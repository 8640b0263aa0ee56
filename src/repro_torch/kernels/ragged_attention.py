"""Wrapper of the CUDA ragged attention kernel (``csrc/ragged_attention.cu``),
the port of ``repro/kernels/ragged_attention.py::ragged_attention`` — its
``_ragged_kernel`` and, over a quantized store, ``_ragged_kernel_q8``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.ragged_attention``. ``launches`` counts launches over an unscaled
store, ``launches_q8`` over a scaled one (int8, fp8, or the f32 lane), and
``launches_split`` every launch of the kernel's one body, the split-KV body
of ``csrc/split_attention.cuh`` under a dense row policy (decode runs it over
the same cache, paged attention over block tables).

A pack runs as a paged pack does: tiles of
:func:`repro_torch.kernels.paged_attention.tile_tokens` consecutive tokens
that share every staged K/V row of their slot (or one token a tile, where
:func:`one_token_tiles` says so), each tile's ``S_max`` positions split into
spans as :func:`plan` picks them from host values only, so a CUDA graph can
capture the launch. The partials of a split call are a ``torch.empty`` per
call on the caller's stream, merged in split order by the last block of
each (tile, head, chunk) on the per-(device, stream) ticket counters of
:func:`repro_torch.kernels._checks.tickets`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _checks
from repro_torch.kernels import decode_attention as _dk
from repro_torch.kernels import paged_attention as _pk

launches = 0
launches_q8 = 0
launches_split = 0


def one_token_tiles(q_dtype: torch.dtype, k_dtype: torch.dtype) -> bool:
    """Whether a pack of ``q_dtype`` queries over a ``k_dtype`` store takes
    one token a tile instead of a pack's tiles (which matter at G <= 4 only:
    at G >= 5 a group chunk of 8 rows fills a block of one token). Measured
    at phase 2's 64-token pack (H100, ``scripts/torch_attention_ab.py``):
    f32 queries over int8 rows took 0.067 ms at one token a tile against
    0.082 at 8 (the CUDA-core rows' shuffles per staged key grow with the
    rows a block); f32 over f32 and bf16 over any store were faster in a
    pack's tiles."""
    return q_dtype == torch.float32 and k_dtype in (torch.int8, torch.float8_e4m3fn)


def plan(s_max: int, t: int, kvh: int, g: int, sms: int, one_token: bool,
         splits: Optional[int] = None) -> tuple[int, int, int]:
    """(tokens a tile, positions a split, splits) of a pack of ``t`` tokens
    over ``s_max`` positions, from host values only: a paged pack's tiles
    (``paged_attention.tile_tokens``), and ``splits`` None for the fewest
    spans whose blocks give every SM one (``decode_attention.split_count``
    at one wave), n >= 1 to ask for n (``decode_attention.split_span``).
    A pack's tiles re-read their slot's rows once each, so its blocks
    stream from L2 at the SMs' rate and more spans only add merges: at
    phase 2's 64-token pack one span took 0.025 ms against 0.030 at four,
    and a chunk at positions 900-963 0.037 against 0.063 (H100,
    ``scripts/torch_attention_ab.py``)."""
    tt = _pk.tile_tokens(g, one_token)
    if splits is None:
        splits = _dk.split_count(s_max, -(-t // tt), kvh, g, sms, waves=1)
    elif splits < 1:
        raise ValueError(f"ragged_attention: splits must be >= 1, got {splits}")
    return (tt, *_dk.split_span(s_max, splits))


def ragged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tok_slot: torch.Tensor,
    tok_pos: torch.Tensor,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """q: [T, KV, G, d]; k/v: [B, S_max, KV, d] (f32/bf16 as q, or int8/fp8
    with ``k_scale``/``v_scale`` [B, S_max, KV] f32); tok_slot/tok_pos: [T]
    int32 with ``tok_slot`` a cache row in [0, B). ``splits``: None for the
    kernel's, n >= 1 to ask for n (:func:`plan`). The tile is
    :func:`one_token_tiles`'. Returns [T, KV, G, d] on q's device and stream,
    without synchronising. Padding rows (``tok_pos >= S_max``) read no key and come
    back as zeros; ``ref.ragged_attention`` attends the whole slot there, and
    nothing reads them."""
    global launches, launches_q8, launches_split
    name = "ragged_attention"
    scales = [s for s in (k_scale, v_scale) if s is not None]
    _checks.cuda_operands(name, q, k, v, tok_slot, tok_pos, *scales)
    _checks.aligned_rows(name, q, k, v)
    qd, sd = _checks.kv_codes(name, q, k, v, k_scale, v_scale)
    t, kvh, g, d = q.shape
    _checks.attention_domain(name, d, g)
    if k.ndim != 4 or k.shape[2:] != (kvh, d) or v.shape != k.shape:
        raise ValueError(f"{name}: cache shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _checks.int32_vector(name, "tok_slot", tok_slot, t)
    _checks.int32_vector(name, "tok_pos", tok_pos, t)
    out = torch.empty_like(q)
    if t == 0:  # no tiles: split_count would divide by zero blocks
        return out
    s_max = k.shape[1]
    one_token = one_token_tiles(q.dtype, k.dtype)
    sms = _dk._sms(q.device.index) if splits is None else 0
    tt, span, splits = plan(s_max, t, kvh, g, sms, one_token, splits)
    tickets = -(-t // tt) * kvh * -(-g // _dk.group_chunk(g))
    if splits > 1 and tickets > _checks.TICKETS:
        raise ValueError(f"{name}: a split launch takes up to {_checks.TICKETS} (tile, head, "
                         f"chunk) blocks, got {tickets}")
    lib = _build.load()
    stream = _checks.stream(q)
    ws = counters = None
    if splits > 1:  # this call's partials, on the caller's stream
        ws = torch.empty(t * kvh * g * splits * (d + 2), dtype=torch.float32, device=q.device)
        counters = _checks.tickets(q.device, stream)
    rc = lib.repro_ragged_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _checks.ptr(k_scale), _checks.ptr(v_scale),
        tok_slot.data_ptr(), tok_pos.data_ptr(), _checks.ptr(ws), _checks.ptr(counters),
        out.data_ptr(), t, s_max, kvh, g, d, int(window), span, 1 if one_token else 0, qd, sd,
        stream,
    )
    _build.check(rc, name)
    if k_scale is None:
        launches += 1
    else:
        launches_q8 += 1
    launches_split += 1
    return out
