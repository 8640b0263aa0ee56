"""Wrapper of the CUDA paged attention kernel (``csrc/paged_attention.cu``),
the port of ``repro/kernels/ragged_attention.py::paged_ragged_attention`` —
its ``_paged_kernel`` and, over a quantized store, ``_paged_kernel_q8``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.paged_ragged_attention`` / ``ref.paged_decode_attention``.
``launches`` counts launches over an unscaled pool, ``launches_q8`` over a
scaled one (int8, fp8, or the f32 lane); ``launches_split_decode`` and
``launches_split_pack`` count the launches of the kernel's one body, the
split-KV body of ``csrc/split_attention.cuh``, as a decode (one token a
tile) and as a pack (:func:`tile_tokens` tokens a tile).

As split decode (:mod:`repro_torch.kernels.decode_attention`), the body
splits each (tile, KV head, chunk of the group)'s positions — the
``max_blocks * bs`` of a table row — into spans of a multiple of
``BLOCK_S`` positions, as many as :func:`split_count` picks from host
values only (the positions, the tiles, KV, G and the SM count), so a CUDA
graph can capture the launch. Its rows go to the tensor cores where a block
holds 8 of them over a bf16, int8 or fp8 pool under bf16 queries (a pack
tile, or a group chunk of 8), to the CUDA cores otherwise. The partials of a split call are a
``torch.empty`` per call on the caller's stream, merged in split order by
the last block of each (tile, head, chunk) on the per-(device, stream)
ticket counters of :func:`repro_torch.kernels._checks.tickets`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _checks
from repro_torch.kernels import decode_attention as _dk

launches = 0
launches_q8 = 0
launches_split_decode = 0
launches_split_pack = 0


MAX_WAVES = 8  # a paged launch splits its positions into up to this many blocks an SM


def split_count(positions: int, tiles: int, kvh: int, g: int, sms: int) -> int:
    """Splits of a paged launch, from host values only: as many BLOCK_S
    spans as keep the (tile, head, chunk, split) blocks within MAX_WAVES an
    SM, and at least ``decode_attention.split_count``'s. A block walks its
    span alone, so where the sequences of a launch differ in length (a
    decode over a shared prefix beside short prompts) the longest span sets
    the time: finer spans share it out, and a block past its sequence's end
    returns at once."""
    blocks = tiles * kvh * -(-g // _dk.group_chunk(g))
    fewest = _dk.split_count(positions, tiles, kvh, g, sms)
    if blocks > _checks.TICKETS:
        return fewest
    most = -(-max(positions, 1) // _dk.BLOCK_S)
    return max(fewest, min(most, MAX_WAVES * sms // blocks))


def tile_tokens(g: int, decode: bool) -> int:
    """Tokens a block takes: one for a decode; for a pack as many as fill 8
    query rows with its chunk of the group (8 at G = 1, 2 at G <= 4, 1
    above)."""
    return 1 if decode else 8 // _dk.group_chunk(g)


def plan(positions: int, t: int, kvh: int, g: int, sms: int, decode: bool,
         splits: Optional[int] = None) -> tuple[int, int, int]:
    """(tokens a tile, positions a split, splits) of a launch over ``t``
    tokens of table rows of ``positions`` positions, from host values only:
    ``splits`` None for :func:`split_count`'s over the tiles, n >= 1 to ask
    for n (``decode_attention.split_span``)."""
    tt = tile_tokens(g, decode)
    tiles = -(-t // tt)
    if splits is None:
        splits = split_count(positions, tiles, kvh, g, sms)
    elif splits < 1:
        raise ValueError(f"paged_attention: splits must be >= 1, got {splits}")
    span, splits = _dk.split_span(positions, splits)
    return tt, span, splits


def paged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tok_seq: torch.Tensor,
    tok_pos: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    decode: bool = False,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """q: [T, KV, G, d]; k/v: pool [NB, bs, KV, d] (f32/bf16 as q, or
    int8/fp8 with ``k_scale``/``v_scale`` [NB, bs, KV] f32); tok_seq/tok_pos:
    [T] int32, token t at position ``tok_pos[t]`` of table row
    ``tok_seq[t]``; block_tables: [R, max_blocks] int32 (entries >= NB are
    the unallocated sentinel). ``decode``: one token a tile (a decode step,
    one token per sequence), else :func:`tile_tokens`' (a pack, built
    sequence by sequence). ``splits``: None for the kernel's, n >= 1 to ask
    for n (:func:`plan`). Returns [T, KV, G, d] on q's device and stream,
    without synchronising. Padding rows (``tok_pos >= max_blocks * bs``)
    read no key and come back as zeros; the plain version attends the whole
    row there, and nothing reads them."""
    global launches, launches_q8, launches_split_decode, launches_split_pack
    name = "paged_attention"
    scales = [s for s in (k_scale, v_scale) if s is not None]
    _checks.cuda_operands(name, q, k, v, tok_seq, tok_pos, block_tables, *scales)
    _checks.aligned_rows(name, q, k, v)
    qd, sd = _checks.kv_codes(name, q, k, v, k_scale, v_scale)
    t, kvh, g, d = q.shape
    _checks.attention_domain(name, d, g)
    if k.ndim != 4 or k.shape[2:] != (kvh, d) or v.shape != k.shape:
        raise ValueError(f"{name}: pool shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2:
        raise ValueError(f"{name}: block_tables must be int32 [R, max_blocks], got "
                         f"{block_tables.dtype} {tuple(block_tables.shape)}")
    _checks.int32_vector(name, "tok_seq", tok_seq, t)
    _checks.int32_vector(name, "tok_pos", tok_pos, t)
    out = torch.empty_like(q)
    if t == 0:  # no tiles: split_count would divide by zero blocks
        return out
    nb, bs = k.shape[0], k.shape[1]
    max_blocks = block_tables.shape[1]
    sms = _dk._sms(q.device.index) if splits is None else 0
    tt, span, splits = plan(max_blocks * bs, t, kvh, g, sms, decode, splits)
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
    rc = lib.repro_paged_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _checks.ptr(k_scale), _checks.ptr(v_scale),
        tok_seq.data_ptr(), tok_pos.data_ptr(), block_tables.data_ptr(), _checks.ptr(ws),
        _checks.ptr(counters), out.data_ptr(), t, nb, bs, max_blocks, kvh, g, d, int(window),
        span, 1 if decode else 0, qd, sd, stream,
    )
    _build.check(rc, name)
    if k_scale is None:
        launches += 1
    else:
        launches_q8 += 1
    if decode:
        launches_split_decode += 1
    else:
        launches_split_pack += 1
    return out
