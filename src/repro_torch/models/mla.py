"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3), the counterpart of
``repro/models/mla.py``.

Prefill uses the expanded form (decompress K/V, then causal attention).
Decode and the packed step use the ABSORBED form: only the compressed latent
c_kv (rank ``kv_lora_rank``) and the shared rope key are cached, and W_uk /
W_uv are absorbed into the query and output sides, so attention is an MQA
over one (kv_lora + rope)-wide shared head. The cache per token is kv_lora +
rope elements against 2 H hd for GQA.

Weight layouts are the JAX package's: wq_a [d, q_lora], q_norm [q_lora],
wq_b [q_lora, H, nope + rope] (or wq [d, H, nope + rope] without a q
LoRA), wkv_a [d, kv_lora + rope], kv_norm [kv_lora], wkv_b [kv_lora, H,
nope + v], wo [H, v, d]; stacked [L, ...] in the model's params. Every
projection is a plain ``torch.matmul`` / ``einsum``, as the JAX package
leaves them to XLA. Caches are updated IN PLACE and returned.

Where the work runs: the packed step's attention through
``ops.mla_ragged_attention`` (the CUDA latent-MQA kernel on the card, its
plain version on the CPU); the training forward's and the prefill's expanded
attention (qk width nope + rope) and the decode step's absorbed attention in
plain torch, as the JAX package computes them outside Pallas. ``packed_calls`` counts
:func:`mla_packed`'s calls, so a run can hold the kernel's launches against
them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import _scatter_pack, _scatter_step
from repro_torch.models.layers import Params, apply_rope, dense_init, rms_norm

packed_calls = 0


def mla_init(cfg: ArchConfig, generator: torch.Generator, dtype, device) -> Params:
    """One MLA block's params for every layer, stacked [L, ...], from
    ``generator`` (on ``device``), with the JAX package's fan-ins."""
    m, L = cfg.mla, cfg.n_layers
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = m.nope_head_dim + m.rope_head_dim

    def w(shape, fan_in):
        return dense_init((L, *shape), generator, dtype, device, fan_in=fan_in)

    def ones(n):
        return torch.ones(L, n, dtype=dtype, device=device)

    p: Params = {}
    if m.q_lora_rank:
        p["wq_a"] = w((d, m.q_lora_rank), d)
        p["q_norm"] = ones(m.q_lora_rank)
        p["wq_b"] = w((m.q_lora_rank, H, qk_dim), m.q_lora_rank)
    else:
        p["wq"] = w((d, H, qk_dim), d)
    p["wkv_a"] = w((d, m.kv_lora_rank + m.rope_head_dim), d)
    p["kv_norm"] = ones(m.kv_lora_rank)
    p["wkv_b"] = w((m.kv_lora_rank, H, m.nope_head_dim + m.v_head_dim), m.kv_lora_rank)
    p["wo"] = w((H, m.v_head_dim, d), H * m.v_head_dim)
    return p


def _project_q(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x [..., d] -> q [..., H, nope + rope], through the q LoRA (wq_a,
    q_norm, wq_b) or the dense wq."""
    m = cfg.mla
    if m.q_lora_rank:
        cq = rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
        q = cq @ params["wq_b"].reshape(m.q_lora_rank, -1)
    else:
        q = x @ params["wq"].reshape(x.shape[-1], -1)
    return q.reshape(*x.shape[:-1], cfg.n_heads, m.nope_head_dim + m.rope_head_dim)


def _latents(params: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """x [..., S, d] -> (c_kv [..., S, kv_lora] after kv_norm, k_rope [..., S,
    rope] rotated at ``positions`` [..., S]): the rows the latent cache holds
    (a pack's [T, d] is S = T tokens)."""
    m = cfg.mla
    c_kv, k_rope = (x @ params["wkv_a"]).split([m.kv_lora_rank, m.rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _queries(params: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope, q_rope rotated at ``positions``), each [..., H, width]."""
    m = cfg.mla
    q_nope, q_rope = _project_q(params, cfg, x).split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _scale(cfg: ArchConfig) -> float:
    """The softmax scale, (nope + rope)**-0.5 (absorption keeps the head's)."""
    return (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim) ** -0.5


def _out_proj(params: Params, o: torch.Tensor) -> torch.Tensor:
    """o [..., H, v] -> [..., d] through wo [H, v, d]."""
    wo = params["wo"]
    return o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def mla_apply(
    params: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
    *, return_kv: bool = False,
):
    """Full-sequence MLA (training forward and prefill), expanded form. x:
    [B, S, d]; positions [S] or [B, S]. Without ``return_kv`` (the training
    forward) the causal attention over qk width nope + rope is the JAX
    function's: ``attention.chunked_attention`` or ``dense_attention`` by
    ``cfg.attn_impl``, v zero-padded to the qk width and sliced back. With
    ``return_kv`` (prefill) it runs in f32 over the full score matrix, cast
    back to x's dtype, and also returns (c_kv [B, S, kv_lora], k_rope [B, S,
    rope]) — the latent cache layout."""
    m = cfg.mla
    H = cfg.n_heads
    if positions.ndim == 1:
        positions = positions[None]
    q_nope, q_rope = _queries(params, cfg, x, positions)
    c_kv, k_rope = _latents(params, cfg, x, positions)
    kv = (c_kv @ params["wkv_b"].reshape(m.kv_lora_rank, -1)).reshape(
        *c_kv.shape[:-1], H, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.nope_head_dim, m.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)  # [B, S, H, qk]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:-1], m.rope_head_dim)],
                  dim=-1)
    if not return_kv:
        v_p = F.pad(v, (0, q.shape[-1] - m.v_head_dim))
        if cfg.attn_impl == "dense":
            o = attn_mod.dense_attention(q, k, v_p, causal=True)
        else:
            o = attn_mod.chunked_attention(q, k, v_p, causal=True, chunk=cfg.attn_chunk)
        return _out_proj(params, o[..., :m.v_head_dim])
    s = x.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(cfg)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, NEG_INF), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(x.dtype)
    return _out_proj(params, o), (c_kv, k_rope)


def mla_packed(
    params: Params, cfg: ArchConfig, x: torch.Tensor,
    cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
    tok_slot: torch.Tensor, tok_pos: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    pack_slots: Optional[torch.Tensor] = None,
):
    """Packed variable-length MLA step over the latent cache: decode
    singletons and prefill chunks as ONE flat token batch.

    x: [T, d]; cache_ckv [B, S_max, kv_lora] and cache_krope [B, S_max,
    rope] (updated in place); tok_slot/tok_pos [T] int32, ``tok_slot`` an
    index INTO ``pack_slots`` when that is given. The pack's latents are
    scattered at (slot, pos) with padding rows (pos >= S_max) dropped; W_uk
    is absorbed into q, ``ops.mla_ragged_attention`` attends in latent
    space, then W_uv and wo. As ``attention_packed``, attention reads the
    full cache at the global slot ``pack_slots[tok_slot]`` where the JAX
    function gathers the P packed rows: the same result without the copy.
    ``valid`` is a ``ref.ragged_valid_mask`` over the full cache for the
    plain path. Returns (out [T, d], cache_ckv, cache_krope)."""
    global packed_calls
    m = cfg.mla
    pos = tok_pos.to(torch.int32)
    q_nope, q_rope = _queries(params, cfg, x, pos)
    c_kv, k_rope = _latents(params, cfg, x, pos)
    glob = (tok_slot if pack_slots is None else pack_slots[tok_slot.long()]).to(torch.int32)
    _scatter_pack(cache_ckv, c_kv, glob, pos)
    _scatter_pack(cache_krope, k_rope, glob, pos)
    w_uk, w_uv = params["wkv_b"].split([m.nope_head_dim, m.v_head_dim], dim=-1)  # [r, H, .]
    q_eff = torch.einsum("thk,rhk->thr", q_nope, w_uk)
    lat = ops.mla_ragged_attention(q_eff, q_rope, cache_ckv, cache_krope, glob, pos,
                                   scale=_scale(cfg), valid=valid)  # [T, H, r]
    packed_calls += 1
    o = torch.einsum("thr,rhv->thv", lat.to(x.dtype), w_uv)
    return _out_proj(params, o), cache_ckv, cache_krope


def mla_decode(
    params: Params, cfg: ArchConfig, x: torch.Tensor,
    cache_ckv: torch.Tensor, cache_krope: torch.Tensor, cur_len: torch.Tensor,
):
    """One decode step over the latent cache. x: [B, 1, d]; cache_ckv [B, S,
    kv_lora], cache_krope [B, S, rope] (updated in place at cur_len);
    cur_len [B] int32. Scores in f32; the probabilities and the latent rows
    are rounded to x's dtype before P V, as the JAX function does. Returns
    (out [B, 1, d], cache_ckv, cache_krope)."""
    m = cfg.mla
    b, s_max = x.shape[0], cache_ckv.shape[1]
    cur = torch.as_tensor(cur_len, device=x.device).broadcast_to((b,))
    pos = cur[:, None]  # [B, 1]
    q_nope, q_rope = _queries(params, cfg, x, pos)
    c_kv, k_rope = _latents(params, cfg, x, pos)
    _scatter_step(cache_ckv, c_kv, cur_len)
    _scatter_step(cache_krope, k_rope, cur_len)
    w_uk, w_uv = params["wkv_b"].split([m.nope_head_dim, m.v_head_dim], dim=-1)
    q_eff = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)
    scores = (torch.einsum("bshr,btr->bhst", q_eff.float(), cache_ckv.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(), cache_krope.float())) * _scale(cfg)
    valid = torch.arange(s_max, device=x.device)[None, :] <= cur[:, None]
    probs = torch.softmax(scores.masked_fill(~valid[:, None, None, :], NEG_INF), dim=-1)
    lat = torch.einsum("bhst,btr->bshr", probs.to(x.dtype), cache_ckv.to(x.dtype))
    o = torch.einsum("bshr,rhv->bshv", lat, w_uv)
    return _out_proj(params, o), cache_ckv, cache_krope
