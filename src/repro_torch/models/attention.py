"""Attention for the dense decoder: the training forward, prefill with K/V
capture, one decode step against the KV cache, and the packed ragged step
(counterparts of ``repro/models/attention.py``).

The training forward (:func:`attention_apply` without ``return_kv``) attends
through :func:`dense_attention` or :func:`chunked_attention` (``cfg.attn_impl``)
in plain torch, as the JAX package keeps its training forward on XLA: a
hand-written kernel has no backward. Prefill (``return_kv=True``) goes through
``ops.gqa_flash_attention``.

All three are GQA-native: K/V stay at ``n_kv_heads`` and the kernels group
query heads ``[.., KV, G, hd]`` without repeating K/V. Weight layouts are
the JAX package's: wq [d, H, hd], wk/wv [d, KV, hd], wo [H, hd, d], each
dense or an int8 ``{"q8", "scale"}`` leaf (``models.quant``).

Where the JAX functions return a new cache (the donated buffer), these
update the cache tensors IN PLACE and return them.

Two options change the cache the step and packed functions read and write,
as in the JAX package:

* ``block_tables`` ([B, max_blocks] int32): the cache arguments are a
  block-paged pool ``[NB + 1, bs, KV, hd]`` and position p of slot b lives at
  offset p % bs of block ``block_tables[b, p // bs]``. The pool's last block
  (index NB, the tables' unallocated sentinel) is a scratch block that no
  table names: a write whose table entry is the sentinel, or whose position
  lies past the table (bucket padding), lands there. That stands in for the
  JAX scatter's ``mode="drop"`` without a host sync, and no live block is
  ever touched by such a write.
* ``k_scale``/``v_scale`` (f32, [B, S_max, KV] or pool-shaped [NB + 1, bs,
  KV]): the cache stores quantized rows. The new K/V rows are quantized at
  insert (``quantize_rows``), their scales scattered beside them, and the
  kernels widen the rows with their scales. The functions then return a
  5-tuple (out, k, v, k_scale, v_scale).

Head-sharded (merged) attention, :func:`attention_lanes`, runs any of the
three on each lane of a mesh with the lane's own KV heads and their G query
heads (JAX's ``_head_constraint``), over the lane's shard of the cache, on
the lane's stream: each lane's ``wo`` rows give a partial output, and the
partials are summed on the controller lane.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives
from repro_torch.dist.compression import quantize_rows
from repro_torch.dist.sharding import recompute_in_lane
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import Params, apply_rope, rms_norm
from repro_torch.models.quant import qmatmul


def _project(params: Params, cfg: ArchConfig, x: torch.Tensor):
    """x [..., d] -> q [..., H, hd], k/v [..., KV, hd] (qk-norm applied),
    each projection dense or int8 (``qmatmul``)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = x.shape[:-1]
    q = qmatmul(x, params["wq"]).reshape(*lead, H, hd)
    k = qmatmul(x, params["wk"]).reshape(*lead, KV, hd)
    v = qmatmul(x, params["wv"]).reshape(*lead, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def _out_proj(params: Params, o: torch.Tensor) -> torch.Tensor:
    """o [..., H, hd] -> [..., d] through wo [H, hd, d], dense or int8."""
    return qmatmul(o.reshape(*o.shape[:-2], -1), params["wo"])


def _group_q(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B, Sq, H, hd] -> [B, Sq, KV, G, hd]: query head h belongs to KV head
    h // G."""
    b, sq, h, hd = q.shape
    return q.reshape(b, sq, kv_heads, h // kv_heads, hd)


def _mask(sq: int, kpos: torch.Tensor, *, causal: bool, q_offset, window: int,
          sk: Optional[int] = None) -> torch.Tensor:
    """[Sq, len(kpos)] bool: key kpos[j] visible to query i (at absolute
    position i + q_offset) under ``causal`` and ``window``, and below ``sk``
    (the keys past it are padding)."""
    qpos = (torch.arange(sq, device=kpos.device) + q_offset)[:, None]
    mask = torch.ones((sq, kpos.shape[0]), dtype=torch.bool, device=kpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos
    if window:
        mask &= kpos[None, :] > qpos - window
    if sk is not None:
        mask &= (kpos < sk)[None, :]
    return mask


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    q_offset=0, window: int = 0) -> torch.Tensor:
    """Attention over the full score matrix. q: [B, Sq, H, hd], k/v: [B, Sk,
    KV, hd] with H % KV == 0; the group dim lives inside the einsums (no K/V
    repeat). ``q_offset`` is q[0]'s absolute position. Scores and softmax in
    f32, the probabilities cast to v's dtype for P.V, as the JAX function."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    if kvh == h:  # MHA: flat 4-D einsums
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    else:
        scores = torch.einsum("bqkgd,bskd->bkgqs", _group_q(q, kvh), k).float() * scale
    mask = _mask(sq, torch.arange(sk, device=q.device), causal=causal, q_offset=q_offset,
                 window=window)
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1).to(v.dtype)
    if kvh == h:
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v).reshape(b, sq, h, hd)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                      chunk: int = 512, q_offset=0, window: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks: never the [Sq, Sk] matrix,
    one [B, heads..., Sq, chunk] block at a time, carrying the running (max,
    sum, acc) in f32. Shapes as :func:`dense_attention`; K/V are zero-padded
    to a whole number of chunks and the padding masked, as the JAX scan
    does. Under autograd each chunk's body is recomputed in backward
    (``checkpoint``), so its probability block is not kept, as the JAX body
    is ``jax.checkpoint``'ed."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    pad = -sk % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = hd ** -0.5
    if kvh != h:  # GQA: the group dim inside the einsums
        qf = _group_q(q, kvh).float()  # [B, Sq, KV, G, hd]
        qk, pv = "bqkgd,bckd->bkgqc", "bkgqc,bckd->bkgqd"
        head_shape = (b, kvh, h // kvh)
    else:  # MHA: flat 4-D einsums
        qf = q.float()
        qk, pv = "bqhd,bchd->bhqc", "bhqc,bchd->bhqd"
        head_shape = (b, h)

    def body(m, l, acc, kci, vci, start: int):
        scores = torch.einsum(qk, qf, kci.float()) * scale
        kpos = torch.arange(start, start + chunk, device=q.device)
        mask = _mask(sq, kpos, causal=causal, q_offset=q_offset, window=window,
                     sk=sk if pad else None)
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum(pv, p, vci.float())
        return m_new, l_new, acc_new

    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    m = torch.full((*head_shape, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((*head_shape, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((*head_shape, sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], chunk):
        kci, vci = k[:, start:start + chunk], v[:, start:start + chunk]
        if grad:
            m, l, acc = checkpoint(body, m, l, acc, kci, vci, start, use_reentrant=False,
                                   context_fn=recompute_in_lane)
        else:
            m, l, acc = body(m, l, acc, kci, vci, start)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]  # [*head, Sq, hd]
    if kvh != h:
        out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    else:
        out = out.transpose(1, 2)
    return out.to(q.dtype)


def attention_apply(
    params: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
    *, impl: Optional[str] = None, return_kv: bool = False,
):
    """Causal self-attention over a full sequence (training forward and
    prefill).

    x: [B, S, d]; positions: [S] or [B, S]. Without ``return_kv`` (the
    training forward) attention is :func:`chunked_attention` or
    :func:`dense_attention` by ``impl`` (default ``cfg.attn_impl``), sliding
    window included, in plain torch: no kernel, so autograd reaches every
    op. With ``return_kv`` (prefill) it also returns the post-RoPE (k, v)
    [B, S, KV, hd] — the decode cache layout — and attention runs through
    ``ops.gqa_flash_attention``: the CUDA flash kernel on the card, its
    plain version on the CPU. A windowed prefill takes the training route
    (the flash kernels, JAX's and the port's, have no window), as JAX's
    ``attention_apply`` does."""
    q, k, v = _project(params, cfg, x)
    if positions.ndim == 1:
        positions = positions[None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if not return_kv or cfg.sliding_window:
        if (impl or cfg.attn_impl) == "dense":
            o = dense_attention(q, k, v, causal=True, window=cfg.sliding_window)
        else:
            o = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                  window=cfg.sliding_window)
        out = _out_proj(params, o)
        return (out, (k, v)) if return_kv else out
    # [B,S,H,hd] -> [B,H,S,hd] / [B,KV,S,hd] for the GQA kernel, and back
    o = ops.gqa_flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True
    ).transpose(1, 2)
    return _out_proj(params, o), (k, v)


def _scatter_step(cache: torch.Tensor, new: torch.Tensor, cur_len: torch.Tensor) -> torch.Tensor:
    """Write new [B, 1, ...] into cache [B, S, ...] at position cur_len per
    row, IN PLACE. Mirrors ``dynamic_update_slice``: an out-of-range start is
    clamped to S - 1, not dropped."""
    b, s = cache.shape[:2]
    pos = torch.as_tensor(cur_len, device=cache.device).broadcast_to((b,)).clamp(0, s - 1)
    rows = torch.arange(b, device=cache.device)
    cache[rows, pos.long()] = new[:, 0].to(cache.dtype)
    return cache


def _paged_rows(pool: torch.Tensor, block_tables: torch.Tensor, seq: torch.Tensor,
                pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(block, offset) in ``pool`` of position ``pos[t]`` of table row
    ``seq[t]``. A position past the table, or an unallocated (sentinel)
    entry, maps to the scratch block ``pool.shape[0] - 1``."""
    scratch, bs = pool.shape[0] - 1, pool.shape[1]
    maxb = block_tables.shape[1]
    pos = pos.long()
    blk = block_tables[seq.long(), (pos // bs).clamp(max=maxb - 1)].long()
    blk = torch.where(pos < maxb * bs, blk, scratch).clamp(max=scratch)
    return blk, pos % bs


def attention_decode(
    params: Params, cfg: ArchConfig, x: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor, cur_len: torch.Tensor,
    block_tables: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """One decode step. x: [B, 1, d]; cache_k/v: [B, S_max, KV, hd] (updated
    in place) or, with ``block_tables``, a paged pool; cur_len: [B] int32
    tokens already cached. The new K/V land at cur_len, then attention runs
    through ``ops.decode_attention`` (``ops.paged_decode_attention``).
    Returns (out [B, 1, d], cache_k, cache_v), plus the scales when
    quantized."""
    b = x.shape[0]
    q, k, v = _project(params, cfg, x)
    pos = torch.as_tensor(cur_len, device=x.device).broadcast_to((b,))[:, None]  # [B,1]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    quant = k_scale is not None
    if quant:  # per-(position, head) rows; the identity lane at f32 storage
        k, ks = quantize_rows(k, cache_k.dtype)
        v, vs = quantize_rows(v, cache_v.dtype)
    if block_tables is None:
        _scatter_step(cache_k, k, cur_len)
        _scatter_step(cache_v, v, cur_len)
        if quant:
            _scatter_step(k_scale, ks, cur_len)
            _scatter_step(v_scale, vs, cur_len)
        o = ops.decode_attention(
            q[:, 0], cache_k, cache_v, cur_len, window=cfg.sliding_window,
            k_scale=k_scale, v_scale=v_scale,
        )
    else:
        blk, off = _paged_rows(cache_k, block_tables, torch.arange(b, device=x.device), pos[:, 0])
        cache_k[blk, off] = k[:, 0].to(cache_k.dtype)
        cache_v[blk, off] = v[:, 0].to(cache_v.dtype)
        if quant:
            k_scale[blk, off] = ks[:, 0].to(k_scale.dtype)
            v_scale[blk, off] = vs[:, 0].to(v_scale.dtype)
        o = ops.paged_decode_attention(
            q[:, 0], cache_k, cache_v, cur_len, block_tables, window=cfg.sliding_window,
            k_scale=k_scale, v_scale=v_scale,
        )
    out = _out_proj(params, o[:, None])  # o: [B, H, hd]
    if quant:
        return out, cache_k, cache_v, k_scale, v_scale
    return out, cache_k, cache_v


def _scatter_pack(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor, pos: torch.Tensor):
    """cache[slot[t], pos[t]] = new[t] IN PLACE for every row with
    pos < S_max; rows at pos >= S_max (the pack's bucket padding) are
    dropped, as ``.at[...].set(mode="drop")`` does.

    Without a host sync: a boolean-mask index would wait for the device.
    Instead a dropped row is redirected onto the first kept row with that
    row's own value, so the duplicate write is harmless. A pack holds at
    least one kept row (the engine never dispatches an all-padding one;
    such a pack would write its row 0 at position S_max - 1)."""
    s = cache.shape[1]
    keep = pos < s
    first = keep.to(torch.int32).argmax()  # first kept row
    tgt_slot = torch.where(keep, slot, slot[first]).long()
    tgt_pos = torch.where(keep, pos, pos[first]).clamp(max=s - 1).long()
    keep_b = keep.view(-1, *([1] * (new.ndim - 1)))
    val = new.to(cache.dtype)
    cache[tgt_slot, tgt_pos] = torch.where(keep_b, val, val[first])
    return cache


def attention_packed(
    params: Params, cfg: ArchConfig, x: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor,
    tok_slot: torch.Tensor, tok_pos: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    pack_slots: Optional[torch.Tensor] = None,
    block_tables: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
):
    """Packed variable-length step: any mix of decode singletons and prefill
    chunks as ONE flat token batch (the unified serving dispatch).

    x: [T, d]; cache_k/v: [B, S_max, KV, hd] (updated in place) or, with
    ``block_tables``, a paged pool; tok_slot/tok_pos: [T] int32 — token t
    belongs to cache slot ``tok_slot[t]`` (an index INTO ``pack_slots`` when
    that is given) at position ``tok_pos[t]``. The new K/V are scattered at
    (slot, pos) — through the slot's table row when paged — with padding
    rows at pos >= S_max dropped, then each token attends keys p <=
    tok_pos[t] of its slot. ``valid`` is a precomputed
    ``ref.ragged_valid_mask`` over the full cache (or the tables' full dense
    view) for the plain path.

    The JAX function gathers the P packed slots (or their table rows) and
    passes local indices; here attention reads the full cache, or the full
    tables, at the global slot ``pack_slots[tok_slot]``, which is the same
    result without the copy. Prefix-shared blocks are never written: the
    engine feeds only positions past the matched prefix. Returns (out
    [T, d], cache_k, cache_v), plus the scales when quantized."""
    q, k, v = _project(params, cfg, x)
    pos = tok_pos.to(torch.int32)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    glob = tok_slot if pack_slots is None else pack_slots[tok_slot.long()]
    glob = glob.to(torch.int32)
    quant = k_scale is not None
    if quant:  # [T, KV, hd] rows -> [T, KV] scales
        k, ks = quantize_rows(k, cache_k.dtype)
        v, vs = quantize_rows(v, cache_v.dtype)
    if block_tables is None:
        _scatter_pack(cache_k, k, glob, pos)
        _scatter_pack(cache_v, v, glob, pos)
        if quant:
            _scatter_pack(k_scale, ks, glob, pos)
            _scatter_pack(v_scale, vs, glob, pos)
        o = ops.ragged_attention(
            q, cache_k, cache_v, glob, pos, window=cfg.sliding_window, valid=valid,
            k_scale=k_scale, v_scale=v_scale,
        )  # [T, H, hd]
    else:
        blk, off = _paged_rows(cache_k, block_tables, glob, pos)
        cache_k[blk, off] = k.to(cache_k.dtype)
        cache_v[blk, off] = v.to(cache_v.dtype)
        if quant:
            k_scale[blk, off] = ks.to(k_scale.dtype)
            v_scale[blk, off] = vs.to(v_scale.dtype)
        o = ops.paged_ragged_attention(
            q, cache_k, cache_v, glob, pos, block_tables, window=cfg.sliding_window,
            valid=valid, k_scale=k_scale, v_scale=v_scale,
        )  # [T, H, hd]
    out = _out_proj(params, o)
    if quant:
        return out, cache_k, cache_v, k_scale, v_scale
    return out, cache_k, cache_v


def attention_lanes(fn, lanes, args: list[tuple], kwargs: list[dict]
                    ) -> tuple[torch.Tensor, list]:
    """``fn(*args[j], **kwargs[j])`` for each lane j (the lane's attention
    params, a config at its share of the heads, its input, its cache shard,
    ...) on the lane's stream. Returns (the partial outputs summed on the
    controller lane, each lane's whole result)."""
    outs = []
    for lane, a, kw in zip(lanes, args, kwargs):
        with lane.use():
            outs.append(fn(*a, **kw))
    return collectives.lane_reduce([o[0] for o in outs], lanes), outs
