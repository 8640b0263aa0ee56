"""Plain PyTorch versions of the port's kernels: attention and the
(int8-weight) matrix product on the serving path, the kernel API's flat
flash attention, RMSNorm and row softmax, and the paper's kernel suite
(axpy, dot product, Stockham FFT, 2-D convolution).

Counterparts of ``repro.kernels.ref`` (same layouts, same masks). They are
what :mod:`repro_torch.kernels.ops` runs for a CPU tensor, and the oracle
each CUDA kernel is held against on the card. All softmax math is f32; the
result is cast back to q's dtype. A quantized cache (int8 or float8_e4m3fn
rows with per-(position, head) f32 scales) is widened to f32 and scaled
before any math (:func:`dequant_kv`); a block-paged pool is gathered into
the dense per-sequence view through its block tables (:func:`paged_gather`)
and then runs the dense function.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] with f32 accumulation, cast to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def matmul_q8(a: torch.Tensor, b_q8: torch.Tensor, b_scale: torch.Tensor) -> torch.Tensor:
    """[M, K] @ int8 [K, N] with per-output-column f32 scales [N]: the f32
    accumulator of the widened weight, scaled per column once it is finished
    (the kernel's flush multiply), cast to a's dtype."""
    acc = a.float() @ b_q8.float()
    return (acc * b_scale.reshape(1, -1).float()).to(a.dtype)


def matmul_slices(a: torch.Tensor, b: torch.Tensor, b_scale: Optional[torch.Tensor],
                  rows: int) -> torch.Tensor:
    """[M, K] @ [K, N] as the split-K GEMVs of ``csrc/matmul.cu`` add it:
    the f32 partial of each ``rows``-row slice of K taken alone (a times the
    widened b), the partials added in slice order, the per-column f32
    scales ``b_scale`` [N] (None: unscaled) applied once to the finished
    sum, cast to a's dtype."""
    total = torch.zeros(a.shape[0], b.shape[1], device=a.device)
    for lo in range(0, a.shape[1], rows):
        total = total + a[:, lo:lo + rows].float() @ b[lo:lo + rows].float()
    if b_scale is not None:
        total = total * b_scale.reshape(1, -1).float()
    return total.to(a.dtype)


def int8_bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """The bf16 bit patterns (int16) the tensor-core GEMV builds from int8
    weights, by its integer recipe: 0x4300 | (b & 0x7F) is the bf16 128 +
    (b & 0x7F), 0xC300 | (b & 0x80) the bf16 -(128 + (b & 0x80)), and one
    bf16 add of the two gives b. Exact: every int8 is a bf16."""
    u = x.to(torch.int32) & 0xFF
    hi = ((u & 0x7F) | 0x4300).to(torch.int16).view(torch.bfloat16)
    lo = ((u & 0x80) | 0xC300).to(torch.int16).view(torch.bfloat16)
    return (hi.float() + lo.float()).to(torch.bfloat16).view(torch.int16)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Flat attention. q: [B, H, Sq, d]; k/v: [B, H, Sk, d]. Causal mask is
    the oracle's ``tril`` over (Sq, Sk): query i sees keys j <= i. As
    ``repro.kernels.ref.flash_attention``, the f32 probabilities are cast to
    v's dtype before P·V. Returns [B, H, Sq, d] in v's dtype."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d**-0.5
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last dim, f32 math, in x's
    dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Row softmax over the last dim, numerically stable, f32 math, in x's
    dtype."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def gqa_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """GQA prefill attention. q: [BKV, G, Sq, d]; k/v: [BKV, Sk, d] (no head
    repeat). Causal mask is top-left aligned: query i sees keys j <= i."""
    bkv, g, sq, d = q.shape
    sk = k.shape[1]
    scores = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) * d**-0.5
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bgqk,bkd->bgqd", p, v.float()).to(q.dtype)


def dequant_kv(k: torch.Tensor, k_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """A K or V store widened to f32, times its per-row scales (one per
    ``[..., d]`` row, ``k.shape[:-1]``) when given. With all-ones scales this
    is bit-identical to the plain widening (``x * 1.0 == x``)."""
    kf = k.float()
    if k_scale is None:
        return kf
    return kf * k_scale[..., None].float()


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cur_len: torch.Tensor,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token grouped decode attention.

    q: [B, KV, G, d]; k/v: [B, S_max, KV, d]; cur_len: [] or [B] tokens
    already cached (the new token sits at index cur_len, so key t is valid
    iff t <= cur_len, and t > cur_len - window when window > 0). Optional
    ``k_scale``/``v_scale`` ([B, S_max, KV] f32) dequantize int8/fp8 rows.
    Returns [B, KV, G, d]."""
    k = dequant_kv(k, k_scale)
    v = dequant_kv(v, v_scale)
    b, kvh, g, d = q.shape
    s_max = k.shape[1]
    scores = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float()) * d**-0.5
    kpos = torch.arange(s_max, device=q.device)[None, :]
    cur = torch.as_tensor(cur_len, device=q.device).broadcast_to((b,))[:, None]
    valid = kpos <= cur
    if window:
        valid &= kpos > cur - window
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p, v.float()).to(q.dtype)


def decode_attention_split(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cur_len: torch.Tensor,
    splits: int,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_s: int = 256,
) -> torch.Tensor:
    """Decode attention as ``csrc/decode_attention.cu``'s split body
    computes it (shapes and masks of :func:`decode_attention`). The
    positions are cut into spans of ceil(S_max / splits) rounded up to a
    multiple of ``block_s``; each span's partial (m, l, acc) is taken alone
    over its valid keys, with the row scales folded into the math (s = ks *
    (q . k) / sqrt(d), acc += (p * vs) * v) and (m, l, acc) = (-1e30, 0, 0)
    for a span with none; the partials are merged in span order, M = max m,
    L = sum l * exp(m - M), out = sum acc * exp(m - M) / max(L, 1e-30). A
    query with no valid key in any span gets zeros (where
    :func:`decode_attention`'s softmax gives the mean of the rows). f32 math,
    in q's dtype."""
    b, s_max = k.shape[0], k.shape[1]
    if s_max == 0:
        return torch.zeros_like(q)
    kpos = torch.arange(s_max, device=q.device)[None, :]
    cur = torch.as_tensor(cur_len, device=q.device).broadcast_to((b,))[:, None]
    valid = kpos <= cur
    if window:
        valid &= kpos > cur - window
    return _split_merge(q, k, v, valid, _span(s_max, splits, block_s), k_scale, v_scale)


def _span(s_max: int, splits: int, block_s: int) -> int:
    """Positions a split: ceil(s_max / splits) rounded up to block_s."""
    per = -(-s_max // splits)
    return -(-per // block_s) * block_s


def _split_merge(q, k, v, valid, span, k_scale, v_scale) -> torch.Tensor:
    """The split bodies' arithmetic: q [B, KV, G, d] over the rows of k/v
    [B, S, KV, d] where valid [B, S] holds, per span of ``span`` positions,
    merged in span order (:func:`decode_attention_split`)."""
    b, kvh, g, d = q.shape
    s_max = k.shape[1]
    scores = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float()) * d**-0.5
    vf = v.float()
    if k_scale is not None:
        scores = scores * k_scale.float().permute(0, 2, 1)[:, :, None, :]
    valid = valid[:, None, None, :]
    parts = []
    for lo in range(0, s_max, span):
        sc, ok = scores[..., lo:lo + span], valid[..., lo:lo + span]
        sc = sc.masked_fill(~ok, NEG_INF)
        m = sc.amax(-1)
        p = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
        l_ = p.sum(-1)
        if v_scale is not None:
            p = p * v_scale.float().permute(0, 2, 1)[:, :, None, lo:lo + span]
        parts.append((m, l_, torch.einsum("bkgt,btkd->bkgd", p, vf[:, lo:lo + span])))
    big = parts[0][0]
    for m, _, _ in parts[1:]:
        big = torch.maximum(big, m)
    total = torch.zeros_like(big)
    acc = torch.zeros(b, kvh, g, d, device=q.device)
    for m, l_, a in parts:
        e = torch.exp(m - big)
        total = total + l_ * e
        acc = acc + a * e[..., None]
    return (acc / total.clamp_min(1e-30)[..., None]).to(q.dtype)


def ragged_valid_mask(
    tok_slot: torch.Tensor, tok_pos: torch.Tensor, b: int, s_max: int, window: int = 0
) -> torch.Tensor:
    """[T, B, S_max] bool: key p of slot ``tok_slot[t]`` is valid for token t
    iff p <= tok_pos[t] (and p > tok_pos[t] - window when window > 0).
    Descriptor-only, so a packed step builds it once for every layer."""
    kpos = torch.arange(s_max, device=tok_pos.device)[None, :]
    pos = tok_pos[:, None]
    valid_s = kpos <= pos
    if window:
        valid_s &= kpos > pos - window
    slot_hit = tok_slot[:, None] == torch.arange(b, device=tok_slot.device)[None, :]
    return slot_hit[:, :, None] & valid_s[:, None, :]


def ragged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tok_slot: torch.Tensor,
    tok_pos: torch.Tensor,
    *,
    window: int = 0,
    valid: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed variable-length attention (the unified-dispatch path).

    q: [T, KV, G, d]; k/v: [B, S_max, KV, d] with the packed tokens' K/V
    already scattered at (tok_slot, tok_pos); tok_slot/tok_pos: [T] int32.
    ``valid`` optionally passes a precomputed :func:`ragged_valid_mask`;
    ``k_scale``/``v_scale`` ([B, S_max, KV] f32) dequantize int8/fp8 rows.
    Full-cross form as in the JAX oracle: every token scores against every
    slot and the wrong slots are masked before one softmax over (slot,
    position) — only the token's own slot survives. Returns [T, KV, G, d]."""
    k = dequant_kv(k, k_scale)
    v = dequant_kv(v, v_scale)
    t, kvh, g, d = q.shape
    b, s_max = k.shape[0], k.shape[1]
    if valid is None:
        valid = ragged_valid_mask(tok_slot, tok_pos, b, s_max, window)
    qf = q.permute(1, 0, 2, 3).reshape(kvh, t * g, d).float()
    kf = k.permute(2, 0, 1, 3).reshape(kvh, b * s_max, d).float()
    scores = torch.einsum("hqd,hsd->hqs", qf, kf) * d**-0.5  # [KV, T*G, B*S]
    valid_tg = valid.reshape(t, 1, b * s_max).expand(t, g, b * s_max).reshape(t * g, -1)
    scores = scores.masked_fill(~valid_tg[None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    vf = v.permute(2, 0, 1, 3).reshape(kvh, b * s_max, d).float()
    out = torch.einsum("hqs,hsd->hqd", p, vf)  # [KV, T*G, d]
    return out.reshape(kvh, t, g, d).permute(1, 0, 2, 3).to(q.dtype)


def mla_ragged_attention(
    q_eff: torch.Tensor,
    q_rope: torch.Tensor,
    ckv: torch.Tensor,
    krope: torch.Tensor,
    tok_slot: torch.Tensor,
    tok_pos: torch.Tensor,
    *,
    scale: float,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed ragged attention in MLA latent space (the absorbed form).

    q_eff: [T, H, r] queries absorbed through W_uk (r = kv_lora_rank);
    q_rope: [T, H, rope]; ckv: [B, S_max, r] latent cache (keys AND values);
    krope: [B, S_max, rope] shared rope keys; tok_slot/tok_pos: [T] int32;
    ``scale`` the softmax scale ((nope + rope)**-0.5); ``valid`` optionally
    a precomputed :func:`ragged_valid_mask`. One shared latent head serves
    every query head: scores are the latent dot plus the rope dot, and the
    readout re-reads the latent cache. Full-cross form as the JAX oracle.
    Returns [T, H, r] in q_eff's dtype."""
    t, h, r = q_eff.shape
    b, s_max = ckv.shape[0], ckv.shape[1]
    if valid is None:
        valid = ragged_valid_mask(tok_slot, tok_pos, b, s_max)
    qe = q_eff.permute(1, 0, 2).float()  # [H, T, r]
    qr = q_rope.permute(1, 0, 2).float()  # [H, T, rope]
    kl = ckv.reshape(b * s_max, r).float()  # [B*S, r]
    kr = krope.reshape(b * s_max, krope.shape[-1]).float()
    scores = (torch.einsum("htr,sr->hts", qe, kl)
              + torch.einsum("htk,sk->hts", qr, kr)) * scale  # [H, T, B*S]
    scores = scores.masked_fill(~valid.reshape(t, b * s_max)[None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("hts,sr->htr", p, kl)  # latent-space readout
    return out.permute(1, 0, 2).to(q_eff.dtype)


def mla_ragged_attention_split(
    q_eff: torch.Tensor,
    q_rope: torch.Tensor,
    ckv: torch.Tensor,
    krope: torch.Tensor,
    tok_slot: torch.Tensor,
    tok_pos: torch.Tensor,
    *,
    scale: float,
    rows: int = 64,
    span: Optional[int] = None,
    splits: int = 1,
) -> torch.Tensor:
    """Latent MQA as ``csrc/mla_attention.cu``'s bf16 body computes it
    (shapes of :func:`mla_ragged_attention`). The (token, head) pairs of
    [T * H] are the rows, flattened, in tiles of ``rows``; split s owns the
    positions [s * span, (s + 1) * span) (``span`` None: ceil(S_max /
    splits)). A tile's live splits are those up to its last real token's
    position; in each, one pass per slot of the tile's tokens with keys
    there (in the order the tokens come) takes the partial (m, l, acc) of
    that slot's rows over their keys p <= tok_pos in the span, and a tile
    with one live split is normalised at once; otherwise the partials are
    merged in split order, M = max m, L = sum l * exp(m - M), out = sum acc *
    exp(m - M) / max(L, 1e-30), a split with no key of a row contributing
    (-1e30, 0, 0). Padding tokens (tok_pos >= S_max) get zeros. f32 math, in
    q_eff's dtype."""
    t, h, r = q_eff.shape
    s_max = ckv.shape[1]
    n = t * h
    out = torch.zeros(n, r, device=q_eff.device)
    if span is None:
        span = -(-s_max // splits)
    qe = q_eff.reshape(n, r).float()
    qr = q_rope.reshape(n, -1).float()
    kl, kr = ckv.float(), krope.float()
    tok = torch.arange(n, device=q_eff.device) // h
    slot_row, pos_row = tok_slot.long()[tok], tok_pos.long()[tok]
    live_row = pos_row < s_max
    for m0 in range(0, n, rows):
        sl = slice(m0, min(m0 + rows, n))
        live, slot, pos = live_row[sl], slot_row[sl], pos_row[sl]
        if not live.any():
            continue
        parts = []
        for s in range(int(pos[live].max()) // span + 1):
            lo, hi = s * span, min(s * span + span, s_max)
            m_ = torch.full((len(live),), NEG_INF, device=q_eff.device)
            l_ = torch.zeros(len(live), device=q_eff.device)
            acc = torch.zeros(len(live), r, device=q_eff.device)
            here = live & (pos >= lo)
            for sq in dict.fromkeys(slot[here].tolist()):  # one pass a slot, in order
                mine = here & (slot == sq)
                keys = torch.arange(lo, hi, device=q_eff.device)
                sc = (qe[sl][mine] @ kl[sq, lo:hi].T + qr[sl][mine] @ kr[sq, lo:hi].T) * scale
                ok = keys[None, :] <= pos[mine][:, None]
                sc = sc.masked_fill(~ok, NEG_INF)
                mx = sc.amax(-1)
                p = torch.where(ok, torch.exp(sc - mx[:, None]), 0.0)
                m_[mine], l_[mine], acc[mine] = mx, p.sum(-1), p @ kl[sq, lo:hi]
            parts.append((m_, l_, acc))
        if len(parts) == 1:
            _, l_, acc = parts[0]
            out[sl] = acc / l_.clamp_min(1e-30)[:, None]
            continue
        big = torch.stack([m_ for m_, _, _ in parts]).amax(0)
        total = torch.zeros_like(big)
        acc = torch.zeros(len(big), r, device=q_eff.device)
        for m_, l_, a in parts:  # split order
            e = torch.exp(m_ - big)
            total = total + l_ * e
            acc = acc + a * e[:, None]
        out[sl] = acc / total.clamp_min(1e-30)[:, None]
    return out.reshape(t, h, r).to(q_eff.dtype)


def paged_gather(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Dense rows from a block-paged pool: pool [NB, bs, ...], block_tables
    [R, max_blocks] int32 -> [R, max_blocks * bs, ...], where position p of
    row r is ``pool[block_tables[r, p // bs], p % bs]``. Entries past the
    pool (the unallocated sentinel) clamp to its last block, as in the JAX
    oracle: their positions hold finite garbage that every consumer masks."""
    nb, bs = pool.shape[0], pool.shape[1]
    r, maxb = block_tables.shape
    view = pool[block_tables.long().clamp(max=nb - 1)]  # [R, maxb, bs, ...]
    return view.reshape(r, maxb * bs, *pool.shape[2:])


def _gather_opt(pool: Optional[torch.Tensor], block_tables: torch.Tensor):
    return None if pool is None else paged_gather(pool, block_tables)


def paged_decode_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    cur_len: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention against a paged pool: the dense per-sequence view
    (scale pools [NB, bs, KV] ride the same gather), then
    :func:`decode_attention` — bit-identical to the unpaged path."""
    return decode_attention(
        q, paged_gather(pool_k, block_tables), paged_gather(pool_v, block_tables), cur_len,
        window=window, k_scale=_gather_opt(k_scale, block_tables),
        v_scale=_gather_opt(v_scale, block_tables),
    )


def paged_ragged_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tok_seq: torch.Tensor,
    tok_pos: torch.Tensor,
    block_tables: torch.Tensor,
    *,
    window: int = 0,
    valid: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Packed ragged attention against a paged pool: token t belongs to
    table row ``tok_seq[t]``; :func:`ragged_attention` over the gathered
    view (``valid`` is a :func:`ragged_valid_mask` over that view)."""
    return ragged_attention(
        q, paged_gather(pool_k, block_tables), paged_gather(pool_v, block_tables),
        tok_seq, tok_pos, window=window, valid=valid,
        k_scale=_gather_opt(k_scale, block_tables), v_scale=_gather_opt(v_scale, block_tables),
    )


def paged_attention_split(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tok_seq: torch.Tensor,
    tok_pos: torch.Tensor,
    block_tables: torch.Tensor,
    splits: int,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_s: int = 256,
) -> torch.Tensor:
    """Paged attention as ``csrc/paged_attention.cu``'s split body computes
    it, decode or pack (shapes of :func:`paged_ragged_attention`): token t
    reads table row ``tok_seq[t]`` over the keys p <= tok_pos[t] (p >
    tok_pos[t] - window when window > 0) of its ``max_blocks * bs``
    positions, the sentinel entries clamped as :func:`paged_gather` clamps
    them (:func:`_tokens_split`)."""
    if q.shape[0] == 0:
        return torch.zeros_like(q)
    rows = block_tables.long()[tok_seq.long()]  # each token's table row

    def view(pool):
        return None if pool is None else paged_gather(pool, rows)

    return _tokens_split(q, view(pool_k), view(pool_v), tok_pos, splits, window,
                         view(k_scale), view(v_scale), block_s)


def ragged_attention_split(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tok_slot: torch.Tensor,
    tok_pos: torch.Tensor,
    splits: int,
    *,
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_s: int = 256,
) -> torch.Tensor:
    """Ragged attention as ``csrc/ragged_attention.cu``'s split body
    computes it (shapes of :func:`ragged_attention`): token t reads cache
    slot ``tok_slot[t]`` over the keys p <= tok_pos[t] (p > tok_pos[t] -
    window when window > 0) of its S_max positions (:func:`_tokens_split`)."""
    if q.shape[0] == 0:
        return torch.zeros_like(q)
    rows = tok_slot.long()

    def view(x):
        return None if x is None else x[rows]

    return _tokens_split(q, view(k), view(v), tok_pos, splits, window, view(k_scale),
                         view(v_scale), block_s)


def _tokens_split(q, k, v, tok_pos, splits, window, k_scale, v_scale, block_s) -> torch.Tensor:
    """The split body over tokens that each read their own rows: q [T, KV,
    G, d] against k/v [T, S, KV, d] (scales [T, S, KV]), token t's keys p <=
    tok_pos[t] (p > tok_pos[t] - window when window > 0), cut into spans as
    :func:`decode_attention_split` cuts them and merged in span order. A
    padding token (tok_pos >= S) has no key and gets zeros. The kernel's
    tiles (several tokens of a pack a block, a pass per sequence) decide
    which rows share a staged key, not a row's arithmetic, so this twin takes
    each token alone. f32 math, in q's dtype."""
    s_max = k.shape[1]
    if s_max == 0:
        return torch.zeros_like(q)
    kpos = torch.arange(s_max, device=q.device)[None, :]
    pos = tok_pos.long()[:, None]
    valid = (kpos <= pos) & (pos < s_max)
    if window:
        valid &= kpos > pos - window
    return _split_merge(q, k, v, valid, _span(s_max, splits, block_s), k_scale, v_scale)


# ---------------------------------------------------------------- kernel suite


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``alpha * x + y`` rounded once to f32, as a fused multiply-add does
    (the CUDA kernel's ``fmaf``, and XLA's contraction of the TPU kernel's
    body, ``repro/kernels/axpy.py``, in interpret mode), then cast to x's
    dtype. Computed in float64, where the product is exact: it equals the
    f32 fma except where the f64 sum lands on an f32 rounding tie (about one
    element in 2^28). alpha is first rounded to x's dtype and then widened,
    as the TPU kernel does (``jnp.asarray(alpha, x.dtype)``), so at bf16 an
    alpha such as 1/3 is its bf16 neighbour 0.333984375 (the JAX oracle
    ``repro.kernels.ref.axpy`` keeps it in f32 and differs there by alpha's
    rounding error times x, plus an output rounding)."""
    a = rounded_alpha(alpha, x.dtype)
    return (a * x.double() + y.double()).float().to(x.dtype)


def rounded_alpha(alpha, dtype: torch.dtype) -> float:
    """alpha rounded to ``dtype`` (the TPU kernel's ``jnp.asarray(alpha,
    x.dtype)``) as a Python float, exact in f32 and f64. Rounded on the host,
    so nothing is copied to the card (a CUDA graph could not capture it); a
    tensor alpha is read with ``float()``, which synchronises."""
    return float(torch.tensor(float(alpha), dtype=dtype))


def dotp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum of ``x * y`` over every element, in f32 (a 0-d tensor)."""
    return (x.float() * y.float()).sum()


def dotp_partials(x: torch.Tensor, y: torch.Tensor, block: int) -> torch.Tensor:
    """x, y: [R, C]. [R, cdiv(C, block)] f32: partial j of row r sums
    ``x[r, c] * y[r, c]`` over c in [j * block, (j + 1) * block)."""
    r, c = x.shape
    nb = -(-c // block)
    prod = F.pad(x.float() * y.float(), (0, nb * block - c))
    return prod.reshape(r, nb, block).sum(-1)


def fft(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched complex FFT over the last dim, planar (re, im), through
    complex64 (the JAX oracle defers to ``jnp.fft`` likewise); outputs in
    re's and im's dtypes."""
    z = torch.fft.fft(torch.complex(re.float(), im.float()), dim=-1)
    return z.real.to(re.dtype), z.imag.to(im.dtype)


def fft_twiddles(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-stage Stockham radix-2 twiddle table [log2(n), n//2] (re, im), a
    copy of ``repro.kernels.ref.fft_twiddles`` with the same f32 bits: the
    angle in float64, ``np.cos``/``np.sin``, then float32.

    Stage s (s=0 the first) multiplies odd halves by W_{2L}^{j mod L} where
    L = 2**s; entries are tiled so every stage reads row s directly.
    """
    stages = int(np.log2(n))
    if 2**stages != n:
        raise ValueError(f"n={n} must be a power of 2")
    tw_re = np.ones((stages, n // 2), np.float32)
    tw_im = np.zeros((stages, n // 2), np.float32)
    for s in range(stages):
        l = 2**s
        j = np.arange(n // 2) % l
        ang = -2.0 * np.pi * j / (2 * l)
        tw_re[s] = np.cos(ang).astype(np.float32)
        tw_im[s] = np.sin(ang).astype(np.float32)
    return tw_re, tw_im


def fft_twiddle_row(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The last row of :func:`fft_twiddles` (re, im) [n // 2], W_n^j, with
    the same f32 bits. Stage s's entry p is this row's entry
    ``(p mod L) * n / (2L)`` (L = 2**s), bit for bit: the two float64
    angles differ by a power of two, which scales exactly."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of 2")
    l = n // 2
    ang = -2.0 * np.pi * np.arange(l) / (2 * l)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def fft_twiddle_stages(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The distinct entries of every stage of :func:`fft_twiddles`, packed
    (re, im) [n - 1]: stage s's L = 2**s entries W_2L^p (p < L) at offset
    L - 1, each read from :func:`fft_twiddle_row` at p * n / (2L), so bit
    for bit the TPU kernel's. A stage's consecutive p are consecutive here,
    where the row holds them n / 2L apart."""
    row_re, row_im = fft_twiddle_row(n)
    idx = np.concatenate([np.arange(2**s) * (n // 2 ** (s + 1))
                          for s in range(n.bit_length() - 1)])
    return row_re[idx], row_im[idx]


def fft_stockham_passes(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fft_stockham` computed as ``csrc/fft.cu`` moves the data: the
    log2 N stages in passes of four (the last pass takes the rest), each a
    radix-2^R group of points ``t * N / 2^R + q`` (t < 2^R) run through R
    stages in place, its twiddles read from :func:`fft_twiddle_stages`. A
    pass starting at stage s leaves group q = m * 2^s + j's output u at
    ``m * 2^(s+R) + u * 2^s + j``. Every butterfly is the step-by-step
    version's, on the same twiddle bits, so the result is equal bit for bit.
    """
    b, n = re.shape
    log2n = n.bit_length() - 1
    tab_re, tab_im = (torch.from_numpy(t).to(re.device) for t in fft_twiddle_stages(n))
    xr, xi = re.float(), im.float()
    s = 0
    while s < log2n:
        r = min(4, log2n - s)
        radix, g = 1 << r, n >> r
        # [b, local index, group]; local index l = (remaining input bits << k) | produced bits
        vr, vi = xr.reshape(b, radix, g), xi.reshape(b, radix, g)
        j = torch.arange(g, device=re.device) % (1 << s)
        half = radix // 2
        for k in range(r):  # stage s + k, L = 2^(s+k); the pair differs in the top local bit
            p = torch.arange(half, device=re.device) % (1 << k)
            idx = (1 << (s + k)) - 1 + (p[:, None] << s) + j[None, :]
            wr, wi = tab_re[idx], tab_im[idx]
            er, ei, orr, oi = vr[:, :half], vi[:, :half], vr[:, half:], vi[:, half:]
            tr = orr * wr - oi * wi
            ti = orr * wi + oi * wr
            # (r' 2^k + p, e +/- t) -> local (r' << (k+1)) | (h << k) | p
            shape = (b, half >> k, 1 << k, g)
            vr = torch.stack([(er + tr).reshape(shape), (er - tr).reshape(shape)], 2)
            vi = torch.stack([(ei + ti).reshape(shape), (ei - ti).reshape(shape)], 2)
            vr, vi = vr.reshape(b, radix, g), vi.reshape(b, radix, g)
        # local u, group q = m 2^s + j -> m 2^(s+R) + u 2^s + j
        out = (b, radix, g >> s, 1 << s)
        xr = vr.reshape(out).permute(0, 2, 1, 3).reshape(b, n)
        xi = vi.reshape(out).permute(0, 2, 1, 3).reshape(b, n)
        s += r
    return xr.to(re.dtype), xi.to(im.dtype)


def softmax_split(x: torch.Tensor, parts: int) -> torch.Tensor:
    """Row softmax as ``csrc/softmax.cu``'s cluster body computes it: each
    row cut into ``parts`` slices of ceil(C / parts) columns, each slice's
    (max m_r, sum s_r of exp(x - m_r)) taken alone, then merged in rank
    order, M = max m_r and S = sum over r of s_r * exp(m_r - M), and each
    element written as exp(x - M) / S. An empty or all -inf slice is (the
    finite floor -FLT_MAX, 0). f32 math, in x's dtype."""
    xf = x.float()
    c = x.shape[-1]
    width = -(-c // parts)
    floor = torch.finfo(torch.float32).min
    pairs = []
    for r in range(parts):
        sl = xf[..., r * width:(r + 1) * width]
        if sl.shape[-1] == 0:
            m = torch.full(x.shape[:-1], floor, device=x.device)
            pairs.append((m, torch.zeros_like(m)))
            continue
        m = sl.amax(-1).clamp_min(floor)
        pairs.append((m, torch.exp(sl - m[..., None]).sum(-1)))
    big = pairs[0][0]
    for m, _ in pairs[1:]:
        big = torch.maximum(big, m)
    total = torch.zeros_like(big)
    for m, s in pairs:
        total = total + s * torch.exp(m - big)
    return (torch.exp(xf - big[..., None]) / total[..., None]).to(x.dtype)


def fft_stockham(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stockham radix-2 over the last dim of [B, N], step by step: the
    algorithm of the TPU kernel and of ``csrc/fft.cu``, with the same twiddle
    table, in f32. Stage s views each half of the row as [N / 2L, L]
    (L = 2**s), multiplies the second half by the stage's twiddles and
    writes ``[e + t, e - t]`` side by side."""
    b, n = re.shape
    tw_re, tw_im = fft_twiddles(n)
    xr, xi = re.float(), im.float()
    for s in range(tw_re.shape[0]):
        l = 2**s
        g = n // (2 * l)
        er, ei = xr[:, : n // 2].reshape(b, g, l), xi[:, : n // 2].reshape(b, g, l)
        orr, oi = xr[:, n // 2:].reshape(b, g, l), xi[:, n // 2:].reshape(b, g, l)
        twr = torch.from_numpy(tw_re[s]).to(re.device).reshape(g, l)
        twi = torch.from_numpy(tw_im[s]).to(re.device).reshape(g, l)
        tr = orr * twr - oi * twi
        ti = orr * twi + oi * twr
        xr = torch.cat([er + tr, er - tr], dim=-1).reshape(b, n)
        xi = torch.cat([ei + ti, ei - ti], dim=-1).reshape(b, n)
    return xr.to(re.dtype), xi.to(im.dtype)


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO VALID convolution, stride 1, f32 math, in x's dtype
    (``F.conv2d`` over NCHW / OIHW views of the f32 operands; on the card the
    caller keeps ``torch.backends.cudnn.allow_tf32`` off for full f32)."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1).to(x.dtype)


def fft_transpose(re: torch.Tensor, im: torch.Tensor, tw_n: int, dtype: torch.dtype
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, R, C] planar (re, im) to [B, C, R] in ``dtype``, each element
    times W_N^(r c) = exp(-2 pi i (r c mod N) / N) first when ``tw_n`` = N
    > 0 (the angle in float64, the product in f32): the transpose of
    ``kernels/fft.py::four_step``."""
    xr, xi = re.float(), im.float()
    if tw_n:
        r = torch.arange(re.shape[1], device=re.device, dtype=torch.int64)[:, None]
        c = torch.arange(re.shape[2], device=re.device, dtype=torch.int64)[None, :]
        ang = (r * c % tw_n).double() * (-2.0 * np.pi / tw_n)
        wr, wi = torch.cos(ang).float(), torch.sin(ang).float()
        xr, xi = xr * wr - xi * wi, xr * wi + xi * wr
    return (xr.transpose(1, 2).contiguous().to(dtype), xi.transpose(1, 2).contiguous().to(dtype))
