"""Attention for the dense decoder: prefill with K/V capture, one decode step
against the KV cache, and the packed ragged step (counterparts of
``repro/models/attention.py``).

All three are GQA-native: K/V stay at ``n_kv_heads`` and the kernels group
query heads ``[.., KV, G, hd]`` without repeating K/V. Weight layouts are
the JAX package's: wq [d, H, hd], wk/wv [d, KV, hd], wo [H, hd, d].

Where the JAX functions return a new cache (the donated buffer), these
update the cache tensors IN PLACE and return them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, apply_rope, rms_norm


def _project(params: Params, cfg: ArchConfig, x: torch.Tensor):
    """x [..., d] -> q [..., H, hd], k/v [..., KV, hd] (qk-norm applied)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = x.shape[:-1]
    q = (x @ params["wq"].reshape(cfg.d_model, H * hd)).reshape(*lead, H, hd)
    k = (x @ params["wk"].reshape(cfg.d_model, KV * hd)).reshape(*lead, KV, hd)
    v = (x @ params["wv"].reshape(cfg.d_model, KV * hd)).reshape(*lead, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def _out_proj(params: Params, o: torch.Tensor) -> torch.Tensor:
    """o [..., H, hd] -> [..., d] through wo [H, hd, d]."""
    H, hd, d = params["wo"].shape
    return o.reshape(*o.shape[:-2], H * hd) @ params["wo"].reshape(H * hd, d)


def attention_apply(
    params: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
    *, return_kv: bool = False,
):
    """Causal self-attention over a full sequence (prefill).

    x: [B, S, d]; positions: [S] or [B, S]. With ``return_kv`` also returns
    the post-RoPE (k, v) [B, S, KV, hd] — the decode cache layout. Attention
    runs through ``ops.gqa_flash_attention``: the CUDA flash kernel on the
    card, its plain version on the CPU. A sliding window is not ported (the
    JAX flash kernel has none either)."""
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window prefill is not ported")
    q, k, v = _project(params, cfg, x)
    if positions.ndim == 1:
        positions = positions[None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # [B,S,H,hd] -> [B,H,S,hd] / [B,KV,S,hd] for the GQA kernel, and back
    o = ops.gqa_flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True
    ).transpose(1, 2)
    out = _out_proj(params, o)
    if return_kv:
        return out, (k, v)
    return out


def _scatter_step(cache: torch.Tensor, new: torch.Tensor, cur_len: torch.Tensor) -> torch.Tensor:
    """Write new [B, 1, ...] into cache [B, S, ...] at position cur_len per
    row, IN PLACE. Mirrors ``dynamic_update_slice``: an out-of-range start is
    clamped to S - 1, not dropped."""
    b, s = cache.shape[:2]
    pos = torch.as_tensor(cur_len, device=cache.device).broadcast_to((b,)).clamp(0, s - 1)
    rows = torch.arange(b, device=cache.device)
    cache[rows, pos.long()] = new[:, 0].to(cache.dtype)
    return cache


def attention_decode(
    params: Params, cfg: ArchConfig, x: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor, cur_len: torch.Tensor,
):
    """One decode step. x: [B, 1, d]; cache_k/v: [B, S_max, KV, hd] (updated
    in place); cur_len: [B] int32 tokens already cached. The new K/V land at
    cur_len, then attention runs through ``ops.decode_attention``.
    Returns (out [B, 1, d], cache_k, cache_v)."""
    b = x.shape[0]
    q, k, v = _project(params, cfg, x)
    pos = torch.as_tensor(cur_len, device=x.device).broadcast_to((b,))[:, None]  # [B,1]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    _scatter_step(cache_k, k, cur_len)
    _scatter_step(cache_v, v, cur_len)
    o = ops.decode_attention(
        q[:, 0], cache_k, cache_v, cur_len, window=cfg.sliding_window
    )[:, None]  # [B, 1, H, hd]
    return _out_proj(params, o), cache_k, cache_v


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
):
    """Packed variable-length step: any mix of decode singletons and prefill
    chunks as ONE flat token batch (the unified serving dispatch).

    x: [T, d]; cache_k/v: [B, S_max, KV, hd] (updated in place);
    tok_slot/tok_pos: [T] int32 — token t belongs to cache slot
    ``tok_slot[t]`` (an index INTO ``pack_slots`` when that is given) at
    position ``tok_pos[t]``. The new K/V are scattered at (slot, pos)
    (padding rows at pos >= S_max dropped), then each token attends keys
    p <= tok_pos[t] of its slot. ``valid`` is a precomputed
    ``ref.ragged_valid_mask`` over the full cache for the plain path.

    The JAX function gathers the P packed slots into a sub-cache and passes
    local indices; here attention reads the full cache at the global slot
    ``pack_slots[tok_slot]``, which is the same result without the copy.
    Returns (out [T, d], cache_k, cache_v)."""
    q, k, v = _project(params, cfg, x)
    pos = tok_pos.to(torch.int32)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    glob = tok_slot if pack_slots is None else pack_slots[tok_slot.long()]
    glob = glob.to(torch.int32)
    _scatter_pack(cache_k, k, glob, pos)
    _scatter_pack(cache_v, v, glob, pos)
    o = ops.ragged_attention(
        q, cache_k, cache_v, glob, pos, window=cfg.sliding_window, valid=valid
    )  # [T, H, hd]
    return _out_proj(params, o), cache_k, cache_v
