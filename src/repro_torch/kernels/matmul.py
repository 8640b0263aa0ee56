"""Wrapper of the CUDA matmul kernels (``csrc/matmul.cu``), the port of
``repro/kernels/matmul.py::matmul_q8`` (``_matmul_q8_kernel``) and
``::matmul`` (``_matmul_kernel``).

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.matmul`` / ``ref.matmul_q8``. ``launches`` counts ``matmul`` launches,
``launches_q8`` ``matmul_q8`` launches. ``split_k`` is the autotuner's knob
of ``matmul`` (0: the kernel splits K to fill the card's waves; 1, 2, 4, 8:
that many K splits); ``matmul_q8``, on the serving path, keeps 0.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, _checks

launches = 0
launches_q8 = 0

_GEMV_COLS = 128  # columns per GEMV block: one split-K ticket counter each
_counters: dict = {}  # device -> int32 zeros the kernels leave zero
_scratch: dict = {}  # device -> f32 buffer for split-K partials, grown as needed
SPLIT_K = (0, 1, 2, 4, 8)  # the autotuner's candidates


def _ticket_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``ceil(n / 128)`` int32 zeros on ``device``, kept across calls
    (the GEMV's last block of each column strip resets its own)."""
    need = -(-n // _GEMV_COLS)
    buf = _counters.get(device)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(max(need, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def _partials(device: torch.device, n: int) -> torch.Tensor:
    """An f32 buffer of at least ``n`` elements on ``device``, kept across
    calls: launches on one stream run in order, so each call's partials are
    consumed before the next call writes them."""
    buf = _scratch.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=device)
        _scratch[device] = buf
    return buf


@functools.lru_cache(maxsize=256)
def _workspace_elems(m: int, k: int, n: int, a_code: int, b_code: int, split_k: int) -> int:
    """f32 elements of scratch the kernels need for the partials of a K-split
    GEMV or tile of this shape (0 when it does not split)."""
    return _build.load().repro_matmul_workspace(m, k, n, a_code, b_code, split_k)


def _launch(name: str, a: torch.Tensor, b: torch.Tensor,
            scale: Optional[torch.Tensor], split_k: int = 0) -> torch.Tensor:
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
    lib = _build.load()
    codes = (_checks.DTYPE_CODES[a.dtype], _checks.DTYPE_CODES.get(b.dtype, -1))
    if split_k < 0:
        raise ValueError(f"{name}: split_k must be >= 0, got {split_k}")
    n_ws = _workspace_elems(m, k, n, *codes, split_k)
    ws = _partials(a.device, n_ws) if n_ws else None
    rc = lib.repro_matmul(
        a.data_ptr(), b.data_ptr(), _checks.ptr(scale), _checks.ptr(ws),
        _ticket_counters(a.device, n).data_ptr(), out.data_ptr(), m, k, n, *codes, split_k,
        _checks.stream(a),
    )
    _build.check(rc, name)
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *, split_k: int = 0) -> torch.Tensor:
    """a [M, K] @ b [K, N], both f32 or both bf16, f32 accumulation; returns
    [M, N] in a's dtype on a's device and stream, without synchronising.
    ``split_k``: 0 lets the kernel choose the K splits, n > 0 forces n."""
    global launches
    if b.dtype != a.dtype:
        raise TypeError(f"matmul: a and b must share one dtype, got {a.dtype} and {b.dtype}")
    out = _launch("matmul", a, b, None, split_k)
    if out.numel():
        launches += 1
    return out


def matmul_q8(a: torch.Tensor, b_q8: torch.Tensor, b_scale: torch.Tensor) -> torch.Tensor:
    """a [M, K] (f32 or bf16) @ int8 b_q8 [K, N], times the f32 per-column
    scales b_scale [N] at the flush; f32 accumulation. Returns [M, N] in a's
    dtype on a's device and stream, without synchronising."""
    global launches_q8
    name = "matmul_q8"
    if b_q8.dtype != torch.int8:
        raise TypeError(f"{name}: b_q8 must be int8, got {b_q8.dtype}")
    if b_scale.dtype != torch.float32 or b_scale.shape != (b_q8.shape[-1],):
        raise ValueError(f"{name}: b_scale must be f32 of shape ({b_q8.shape[-1]},), got "
                         f"{b_scale.dtype} {tuple(b_scale.shape)}")
    out = _launch(name, a, b_q8, b_scale)
    if out.numel():
        launches_q8 += 1
    return out
