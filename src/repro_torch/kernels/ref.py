"""Plain PyTorch versions of the attention kernels on the serving path.

Counterparts of ``repro.kernels.ref`` (same layouts, same masks). They are
what :mod:`repro_torch.kernels.ops` runs for a CPU tensor, and the oracle
each CUDA kernel is held against on the card. All softmax math is f32; the
result is cast back to q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


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


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cur_len: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Single-token grouped decode attention.

    q: [B, KV, G, d]; k/v: [B, S_max, KV, d]; cur_len: [] or [B] tokens
    already cached (the new token sits at index cur_len, so key t is valid
    iff t <= cur_len, and t > cur_len - window when window > 0).
    Returns [B, KV, G, d]."""
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
) -> torch.Tensor:
    """Packed variable-length attention (the unified-dispatch path).

    q: [T, KV, G, d]; k/v: [B, S_max, KV, d] with the packed tokens' K/V
    already scattered at (tok_slot, tok_pos); tok_slot/tok_pos: [T] int32.
    ``valid`` optionally passes a precomputed :func:`ragged_valid_mask`.
    Full-cross form as in the JAX oracle: every token scores against every
    slot and the wrong slots are masked before one softmax over (slot,
    position) — only the token's own slot survives. Returns [T, KV, G, d]."""
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
