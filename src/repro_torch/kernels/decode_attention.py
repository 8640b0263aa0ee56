"""Wrapper of the CUDA decode attention kernel (``csrc/decode_attention.cu``),
the port of ``repro/kernels/decode_attention.py::decode_attention`` — its
``_decode_kernel`` and, over a quantized store, ``_decode_kernel_q8``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.decode_attention``. ``launches`` counts launches over an unscaled
store, ``launches_q8`` over a scaled one (int8, fp8, or the f32 lane), and
``launches_split`` every launch of the kernel's one body, the split-KV body
(one split is its single-block case).

The body splits each (slot, KV head, chunk of the group)'s positions over
:func:`split_count` blocks, spans of :data:`BLOCK_S` positions or a multiple
(:func:`split_span`), chosen from host values only so that a CUDA graph can
capture the launch. The partials of a split call are a ``torch.empty`` per
call on the caller's stream, and the last block of each (slot, head, chunk)
merges them in split order on ticket counters kept per (device, stream)
(:func:`repro_torch.kernels._checks.tickets`), left zero by the kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, _checks

launches = 0
launches_q8 = 0
launches_split = 0

BLOCK_S = 256  # positions of a split come in multiples of the JAX kernel's block_s
WAVES = 2  # the split grid fills at least this many blocks per SM where it can


def group_chunk(g: int) -> int:
    """Rows of the group one block holds (csrc/attention_common.cuh)."""
    return 1 if g == 1 else 4 if g <= 4 else 8


def split_span(s_max: int, splits: int) -> tuple[int, int]:
    """(positions per split, splits) of ``splits`` asked over ``s_max``
    positions: the span is ceil(s_max / splits) rounded up to a multiple of
    BLOCK_S, so fewer splits may come back."""
    s = max(s_max, 1)
    per = -(-s // splits)
    span = -(-per // BLOCK_S) * BLOCK_S
    return span, -(-s // span)


@functools.lru_cache(maxsize=1024)
def split_count(s_max: int, b: int, kv: int, g: int, sms: int) -> int:
    """Splits of the position range: the fewest whose B * KV * chunks *
    splits blocks fill WAVES blocks per SM of ``sms``, at most one a BLOCK_S
    span; 1 where the (slot, head, chunk) blocks fill them alone or outnumber
    the ticket counters."""
    blocks = b * kv * -(-g // group_chunk(g))
    if blocks >= WAVES * sms or blocks > _checks.TICKETS:
        return 1
    most = -(-max(s_max, 1) // BLOCK_S)
    n = 1
    for want in range(1, most + 1):
        n = split_span(s_max, want)[1]
        if blocks * n >= WAVES * sms:
            break
    return n


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cur_len: torch.Tensor, *,
    window: int = 0, k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None, splits: Optional[int] = None,
) -> torch.Tensor:
    """q: [B, KV, G, d]; k/v: [B, S_max, KV, d] (f32/bf16 as q, or int8/fp8
    with ``k_scale``/``v_scale`` [B, S_max, KV] f32); cur_len: [B] int32.
    ``splits``: None for :func:`split_count`'s, n >= 1 to ask for n
    (:func:`split_span`). Returns [B, KV, G, d] on q's device and stream,
    without synchronising."""
    global launches, launches_q8, launches_split
    name = "decode_attention"
    scales = [s for s in (k_scale, v_scale) if s is not None]
    _checks.cuda_operands(name, q, k, v, cur_len, *scales)
    _checks.aligned_rows(name, q, k, v)
    qd, sd = _checks.kv_codes(name, q, k, v, k_scale, v_scale)
    b, kvh, g, d = q.shape
    _checks.attention_domain(name, d, g)
    if k.ndim != 4 or k.shape[0] != b or k.shape[2:] != (kvh, d) or v.shape != k.shape:
        raise ValueError(f"{name}: cache shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _checks.int32_vector(name, "cur_len", cur_len, b)
    s_max = k.shape[1]
    if splits is None:
        splits = split_count(s_max, b, kvh, g, _sms(q.device.index))
    elif splits < 1:
        raise ValueError(f"{name}: splits must be >= 1, got {splits}")
    span, splits = split_span(s_max, splits)
    chunks = -(-g // group_chunk(g))
    if splits > 1 and b * kvh * chunks > _checks.TICKETS:
        raise ValueError(f"{name}: a split launch takes up to {_checks.TICKETS} (slot, head, "
                         f"chunk) blocks, got {b * kvh * chunks}")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load()
    stream = _checks.stream(q)
    ws = counters = None
    if splits > 1:  # this call's partials, on the caller's stream
        ws = torch.empty(b * kvh * g * splits * (d + 2), dtype=torch.float32, device=q.device)
        counters = _checks.tickets(q.device, stream)
    rc = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _checks.ptr(k_scale), _checks.ptr(v_scale),
        cur_len.data_ptr(), _checks.ptr(ws), _checks.ptr(counters), out.data_ptr(), b, s_max,
        kvh, g, d, int(window), span, qd, sd, stream,
    )
    _build.check(rc, name)
    if k_scale is None:
        launches += 1
    else:
        launches_q8 += 1
    launches_split += 1
    return out
