"""Argument checks shared by the kernel wrappers: every tensor handed to a
kernel is on one CUDA device and contiguous, the row operands (q, the K/V
store, out) are 16-byte aligned (the kernels load rows as vectors), and the
dtypes are ones the kernels were built for."""

from __future__ import annotations

from typing import Optional

import torch

# storage codes of csrc/attention_common.cuh (repro::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}

# the (head_dim, group) domain of the decode, ragged and paged attention
# kernels (csrc/attention_common.cuh: launch_attention's cases) and the head
# widths of the flash kernel (csrc/flash_attention.cu)
HEAD_DIMS = (16, 32, 64, 80, 128)
MAX_GROUP = 16


def in_attention_domain(d: int, g: int) -> bool:
    """Whether the serving attention kernels take head width ``d`` with a
    group of ``g`` query heads per KV head."""
    return d in HEAD_DIMS and 1 <= g <= MAX_GROUP


def attention_domain(name: str, d: int, g: int) -> None:
    """Raise unless the serving attention kernels take (d, g)."""
    if not in_attention_domain(d, g):
        raise ValueError(f"{name}: no kernel instantiated for head_dim {d} with a group of {g} "
                         f"(head_dim one of {HEAD_DIMS}, group 1 to {MAX_GROUP})")


def cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every operand must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def c_int_dims(name: str, *tensors: torch.Tensor) -> None:
    """Every dimension must fit the C interface's ``int``: refuse one of 2^31
    or more (the kernels offset in 64 bits, the sizes they are given are
    32-bit). Checked on the shape alone, before anything is allocated."""
    for t in tensors:
        if any(d >= 2**31 for d in t.shape):
            raise ValueError(f"{name}: every dimension must be below 2^31, got {tuple(t.shape)}")


def aligned_rows(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v and out must be 16-byte aligned")


def float_code(name: str, *tensors: torch.Tensor) -> int:
    dt = tensors[0].dtype
    if dt not in (torch.float32, torch.bfloat16) or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{name}: operands must share one dtype of f32/bf16, got "
                        f"{[t.dtype for t in tensors]}")
    return DTYPE_CODES[dt]


def kv_codes(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
) -> tuple[int, int]:
    """(query code, store code) of an attention call over a K/V store that
    may be quantized. Without scales q, k and v share one dtype of f32/bf16;
    an int8/fp8 store needs f32 scales of shape ``k.shape[:-1]``, and an f32
    store may carry them under f32 or bf16 queries (the identity lane)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    if k_scale is None:
        return (float_code(name, q, k, v),) * 2
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be f32 or bf16, got {q.dtype}")
    if v.dtype != k.dtype or k.dtype not in (torch.float32, torch.int8, torch.float8_e4m3fn):
        raise TypeError(f"{name}: unsupported scaled K/V store {k.dtype}/{v.dtype}")
    for s in (k_scale, v_scale):
        if s.dtype != torch.float32 or s.shape != k.shape[:-1]:
            raise ValueError(f"{name}: scales must be f32 of shape {tuple(k.shape[:-1])}, got "
                             f"{s.dtype} {tuple(s.shape)}")
    return DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype]


def int32_vector(name: str, what: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.int32 or t.shape != (n,):
        raise ValueError(f"{name}: {what} must be int32 of shape ({n},), got "
                         f"{t.dtype} {tuple(t.shape)}")


TICKETS = 1 << 16  # ticket counters per (device, stream)
_tickets: dict = {}  # (device index, stream handle) -> int32 zeros the kernels leave zero


def tickets(device: torch.device, stream: int) -> torch.Tensor:
    """The split kernels' ticket counters of raw stream handle ``stream`` on
    ``device`` (the split GEMVs: one per 128-column strip; split decode: one
    per (slot, KV head, chunk of the group)): made once, before the stream's
    first split launch, at a fixed size, so a captured launch never sees
    them replaced. Each kernel leaves them zero, and launches on one stream
    run in order, so every split kernel of the stream shares them."""
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None:
        buf = torch.zeros(TICKETS, dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for ctypes, None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device, as
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives it but without
    building a Stream object (the wrappers run several times per layer)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
