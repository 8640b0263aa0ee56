"""Wrapper of the CUDA matmul kernels (``csrc/matmul.cu``), the port of
``repro/kernels/matmul.py::matmul_q8`` (``_matmul_q8_kernel``) and
``::matmul`` (``_matmul_kernel``).

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.matmul`` / ``ref.matmul_q8``. :func:`route` picks the kernel body from
M, K, N and the operand types alone (:data:`ROUTES`). ``launches`` counts
``matmul`` launches, ``launches_q8`` ``matmul_q8`` launches, and
``launches_<route>`` the launches of each body by either op.

The autotuner's knobs of ``matmul``: ``split_k`` (0: the kernel splits K
as it sees fit; 1, 2, 4, 8: that many K splits) and the wgmma tile
``block_m`` x ``block_n`` (0 x 0: the kernel's choice; or one of
:data:`TILES`), the names of the JAX tuner's knobs; the other bodies ignore
the tile. ``matmul_q8``, on the serving path, keeps the kernel's choice.

Scratch has one owner per stream: the split-K partials are taken per call
from PyTorch's caching allocator on the caller's stream (stream-ordered;
inside a CUDA graph capture they come from the graph's pool), and the
GEMVs' ticket counters are kept per (device, stream)
(:func:`repro_torch.kernels._checks.tickets`), sized once for every N a GEMV
takes, and left zero by the kernel after each call — no memset per call.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, _checks

launches = 0
launches_q8 = 0
launches_gemv = 0
launches_wgmma = 0
launches_mma_pipe = 0
launches_mma_tile = 0
launches_fma = 0
launches_gemv_tc = 0

# the bodies, in matmul.cu's Route order
ROUTES = ("gemv", "wgmma", "mma_pipe", "mma_tile", "fma", "gemv_tc")
SPLIT_K = (0, 1, 2, 4, 8)  # the autotuner's K splits
TILES = ((128, 128), (128, 256))  # the wgmma tiles (block_m, block_n); (0, 0): the kernel's

_GEMV_COLS = 128  # columns per GEMV block (either body): one split-K ticket counter each


def route(m: int, k: int, n: int, a_dtype: torch.dtype, b_dtype: torch.dtype) -> str:
    """The body that computes [m, k] @ [k, n] for these operand types (b
    int8 is ``matmul_q8``): at M <= 8 the tensor-core GEMV for bf16
    activations with K and N multiples of 16 (bf16 or int8 weights), the
    CUDA-core GEMV for f32 activations (tensor cores would read them as
    TF32) and the K/N tails; above it the wgmma tile for
    bf16 @ bf16 with K and N multiples of 8 (TMA's 16-byte strides), the
    pipelined mma.sync tile for bf16 @ int8 with K % 8 == 0 and N % 16 ==
    0, the synchronous mma.sync tile for other bf16 shapes, and the CUDA-core
    FMA tile for f32 activations."""
    if m <= 8:
        tc = a_dtype == torch.bfloat16 and k > 0 and k % 16 == 0 and n % 16 == 0
        return "gemv_tc" if tc else "gemv"
    if a_dtype == torch.float32:
        return "fma"
    if b_dtype == torch.bfloat16:
        return "wgmma" if k % 8 == 0 and n % 8 == 0 else "mma_tile"
    return "mma_pipe" if k % 8 == 0 and n % 16 == 0 else "mma_tile"


@functools.lru_cache(maxsize=256)
def _workspace_elems(m: int, k: int, n: int, route_code: int, split_k: int, block_n: int,
                     b_code: int) -> int:
    """f32 elements of scratch the kernels need for the partials of a K-split
    GEMV or tile of this shape and weight type (0 when it does not split)."""
    return _build.load().repro_matmul_workspace(m, k, n, route_code, split_k, block_n, b_code)


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, scale: Optional[torch.Tensor],
            split_k: int = 0, block_m: int = 0, block_n: int = 0) -> torch.Tensor:
    if split_k < 0:
        raise ValueError(f"{name}: split_k must be >= 0, got {split_k}")
    if (block_m, block_n) != (0, 0) and (block_m, block_n) not in TILES:
        raise ValueError(f"{name}: (block_m, block_n) must be (0, 0) or one of {TILES}, got "
                         f"{(block_m, block_n)}")
    operands = [a, b] if scale is None else [a, b, scale]
    _checks.cuda_operands(name, *operands)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not chain")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: a must be f32 or bf16, got {a.dtype}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    for t in (a, b, out):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a, b and out must be 16-byte aligned")
    if out.numel() == 0:
        return out
    body = route(m, k, n, a.dtype, b.dtype)
    code = ROUTES.index(body)
    gemv = body in ("gemv", "gemv_tc")
    if gemv and n > _checks.TICKETS * _GEMV_COLS:
        raise ValueError(f"{name}: the GEMV takes N up to {_checks.TICKETS * _GEMV_COLS}, got {n}")
    lib = _build.load()
    b_code = _checks.DTYPE_CODES.get(b.dtype, -1)
    n_ws = _workspace_elems(m, k, n, code, split_k, block_n, b_code)
    # the partials of this call, on the caller's stream: no other call shares them
    ws = torch.empty(n_ws, dtype=torch.float32, device=a.device) if n_ws else None
    stream = _checks.stream(a)
    counters = _checks.tickets(a.device, stream) if gemv else None
    rc = lib.repro_matmul(
        a.data_ptr(), b.data_ptr(), _checks.ptr(scale), _checks.ptr(ws), _checks.ptr(counters),
        out.data_ptr(), m, k, n, _checks.DTYPE_CODES[a.dtype], b_code,
        code, split_k, block_m, block_n, stream,
    )
    _build.check(rc, name)
    globals()[f"launches_{body}"] += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *, split_k: int = 0, block_m: int = 0,
           block_n: int = 0) -> torch.Tensor:
    """a [M, K] @ b [K, N], both f32 or both bf16, f32 accumulation; returns
    [M, N] in a's dtype on a's device and stream, without synchronising.
    ``split_k``: 0 lets the kernel choose the K splits, n > 0 forces n;
    ``block_m`` x ``block_n``: the wgmma tile, (0, 0) for the kernel's
    choice or one of :data:`TILES`."""
    global launches
    if b.dtype != a.dtype:
        raise TypeError(f"matmul: a and b must share one dtype, got {a.dtype} and {b.dtype}")
    out = _launch("matmul", a, b, None, split_k, block_m, block_n)
    if out.numel():
        launches += 1
    return out


def matmul_q8(a: torch.Tensor, b_q8: torch.Tensor, b_scale: torch.Tensor, *,
              split_k: int = 0) -> torch.Tensor:
    """a [M, K] (f32 or bf16) @ int8 b_q8 [K, N], times the f32 per-column
    scales b_scale [N] at the flush; f32 accumulation. ``split_k``: 0 (the
    serving path's) lets the kernel choose the K splits, n > 0 forces n.
    Returns [M, N] in a's dtype on a's device and stream, without
    synchronising."""
    global launches_q8
    name = "matmul_q8"
    if b_q8.dtype != torch.int8:
        raise TypeError(f"{name}: b_q8 must be int8, got {b_q8.dtype}")
    if b_scale.dtype != torch.float32 or b_scale.shape != (b_q8.shape[-1],):
        raise ValueError(f"{name}: b_scale must be f32 of shape ({b_q8.shape[-1]},), got "
                         f"{b_scale.dtype} {tuple(b_scale.shape)}")
    out = _launch(name, a, b_q8, b_scale, split_k)
    if out.numel():
        launches_q8 += 1
    return out
