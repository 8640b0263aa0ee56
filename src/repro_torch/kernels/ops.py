"""Dispatch layer for the attention kernels, mirroring ``repro.kernels.ops``.

The device of the tensors decides, as ``ops._resolve`` decides by backend
in the JAX package, but with no mode that could pick the plain version on
the card: a CPU tensor runs the plain PyTorch version in :mod:`ref`, a CUDA
tensor runs the hand-written CUDA kernel, anything else raises. Block-size,
autotune and ``k_scale`` arguments are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _decode_k
from repro_torch.kernels import flash_attention as _flash_k
from repro_torch.kernels import ragged_attention as _ragged_k
from repro_torch.kernels import ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no attention path for device {t.device}")


def gqa_flash_attention(q, k, v, *, causal: bool = True):
    """GQA-native attention: q [B, H, S, d], k/v [B, KV, S, d], H % KV == 0.
    K/V are never expanded to H heads. Returns [B, H, S, d]."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    qg = q.reshape(b * kvh, h // kvh, sq, d)
    kf = k.reshape(b * kvh, k.shape[2], d)
    vf = v.reshape(b * kvh, v.shape[2], d)
    if _on_cuda(q):
        out = _flash_k.gqa_flash_attention(
            qg.contiguous(), kf.contiguous(), vf.contiguous(), causal=causal
        )
    else:
        out = ref.gqa_flash_attention(qg, kf, vf, causal=causal)
    return out.reshape(b, h, sq, d)


def decode_attention(q, k, v, cur_len, *, window: int = 0):
    """Batched single-token decode attention against the KV cache.
    q: [B, H, d]; k/v: [B, S_max, KV, d]; cur_len: [B] int32 tokens already
    cached per slot. Returns [B, H, d]."""
    b, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    qg = q.reshape(b, kvh, h // kvh, d)
    if _on_cuda(q):
        out = _decode_k.decode_attention(qg.contiguous(), k, v, cur_len, window=window)
    else:
        out = ref.decode_attention(qg, k, v, cur_len, window=window)
    return out.reshape(b, h, d)


def ragged_attention(
    q, k, v, tok_slot, tok_pos, *, window: int = 0, valid: Optional[torch.Tensor] = None
):
    """Packed variable-length attention: q [T, H, d] against k/v
    [B, S_max, KV, d], the tokens' K/V already scattered at (tok_slot,
    tok_pos) ([T] int32). ``valid`` optionally passes a precomputed
    ``ref.ragged_valid_mask`` to the plain version; the kernel derives its
    masks itself. Returns [T, H, d]."""
    t, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    qg = q.reshape(t, kvh, h // kvh, d)
    if _on_cuda(q):
        out = _ragged_k.ragged_attention(
            qg.contiguous(), k, v, tok_slot, tok_pos, window=window
        )
    else:
        out = ref.ragged_attention(qg, k, v, tok_slot, tok_pos, window=window, valid=valid)
    return out.reshape(t, h, d)
