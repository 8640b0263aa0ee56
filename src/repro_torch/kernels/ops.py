"""Dispatch layer for the attention and matmul kernels, mirroring
``repro.kernels.ops``.

The device of the tensors decides, as ``ops._resolve`` decides by backend
in the JAX package, but with no mode that could pick the plain version on
the card: a CPU tensor runs the plain PyTorch version in :mod:`ref`, a CUDA
tensor runs the hand-written CUDA kernel, anything else raises. The
quantized store rides the same ops: ``k_scale``/``v_scale`` (f32, one per
(position, head) row) mark an int8/fp8 cache, widened inside the kernel or
the plain version, never as a dequantized cache copy. The paged ops take a
block-paged pool and its block tables. ``matmul_q8`` is the int8-weight
product of :func:`repro_torch.models.quant.qmatmul`. Block-size, mode and
autotune arguments are not ported.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _decode_k
from repro_torch.kernels import flash_attention as _flash_k
from repro_torch.kernels import matmul as _matmul_k
from repro_torch.kernels import paged_attention as _paged_k
from repro_torch.kernels import ragged_attention as _ragged_k
from repro_torch.kernels import ref


@functools.lru_cache(maxsize=64)
def _seq_ids(b: int, device: torch.device) -> torch.Tensor:
    """[0, b) int32 on ``device``: the table rows of a paged decode, built
    once per batch size instead of once per layer."""
    return torch.arange(b, dtype=torch.int32, device=device)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def matmul(a, b):
    """[M, K] @ [K, N] with f32 accumulation, in a's dtype (f32 or bf16; b
    of the same dtype)."""
    if _on_cuda(a):
        return _matmul_k.matmul(a.contiguous(), b.contiguous())
    return ref.matmul(a, b)


def matmul_q8(a, b_q8, b_scale):
    """[M, K] @ int8 [K, N] times per-output-column f32 scales [N], f32
    accumulation, in a's dtype: the weight stays int8 in memory and is
    widened inside the kernel."""
    if _on_cuda(a):
        return _matmul_k.matmul_q8(a.contiguous(), b_q8.contiguous(), b_scale.contiguous())
    return ref.matmul_q8(a, b_q8, b_scale)


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


def decode_attention(q, k, v, cur_len, *, window: int = 0, k_scale=None, v_scale=None):
    """Batched single-token decode attention against the KV cache.
    q: [B, H, d]; k/v: [B, S_max, KV, d]; cur_len: [B] int32 tokens already
    cached per slot; ``k_scale``/``v_scale`` [B, S_max, KV] f32 for a
    quantized store. Returns [B, H, d]."""
    b, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    qg = q.reshape(b, kvh, h // kvh, d)
    if _on_cuda(q):
        out = _decode_k.decode_attention(
            qg.contiguous(), k, v, cur_len, window=window, k_scale=k_scale, v_scale=v_scale
        )
    else:
        out = ref.decode_attention(
            qg, k, v, cur_len, window=window, k_scale=k_scale, v_scale=v_scale
        )
    return out.reshape(b, h, d)


def ragged_attention(
    q, k, v, tok_slot, tok_pos, *, window: int = 0, valid: Optional[torch.Tensor] = None,
    k_scale=None, v_scale=None,
):
    """Packed variable-length attention: q [T, H, d] against k/v
    [B, S_max, KV, d], the tokens' K/V already scattered at (tok_slot,
    tok_pos) ([T] int32). ``valid`` optionally passes a precomputed
    ``ref.ragged_valid_mask`` to the plain version; the kernel derives its
    masks itself. ``k_scale``/``v_scale`` [B, S_max, KV] f32 for a quantized
    store. Returns [T, H, d]."""
    t, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    qg = q.reshape(t, kvh, h // kvh, d)
    if _on_cuda(q):
        out = _ragged_k.ragged_attention(
            qg.contiguous(), k, v, tok_slot, tok_pos, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
    else:
        out = ref.ragged_attention(
            qg, k, v, tok_slot, tok_pos, window=window, valid=valid,
            k_scale=k_scale, v_scale=v_scale,
        )
    return out.reshape(t, h, d)


def paged_ragged_attention(
    q, k, v, tok_seq, tok_pos, block_tables, *, window: int = 0,
    valid: Optional[torch.Tensor] = None, k_scale=None, v_scale=None,
):
    """Packed variable-length attention against a block-paged pool: the
    ``(slot, pos)`` indirection of :func:`ragged_attention` generalised to
    ``(block, offset)`` through per-sequence block tables.

    q: [T, H, d]; k/v: pool [NB, bs, KV, d] with the packed tokens' K/V
    already scattered; tok_seq/tok_pos: [T] int32 — token t belongs to table
    row ``tok_seq[t]`` at position ``tok_pos[t]``; block_tables: [R,
    max_blocks] int32; ``k_scale``/``v_scale`` [NB, bs, KV] f32 for a
    quantized pool. The plain version gathers the tables' dense view
    (``valid`` is a ``ref.ragged_valid_mask`` over it); the kernel streams
    pool blocks through the tables and never builds it. Returns [T, H, d]."""
    t, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    qg = q.reshape(t, kvh, h // kvh, d)
    if _on_cuda(q):
        out = _paged_k.paged_attention(
            qg.contiguous(), k, v, tok_seq, tok_pos, block_tables, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
    else:
        out = ref.paged_ragged_attention(
            qg, k, v, tok_seq, tok_pos, block_tables, window=window, valid=valid,
            k_scale=k_scale, v_scale=v_scale,
        )
    return out.reshape(t, h, d)


def paged_decode_attention(
    q, k, v, cur_len, block_tables, *, window: int = 0, k_scale=None, v_scale=None,
):
    """Batched single-token decode attention against a block-paged pool.
    q: [B, H, d]; k/v: pool [NB, bs, KV, d]; cur_len: [B] int32;
    block_tables: [B, max_blocks] int32 (row b maps sequence b). The plain
    version gathers the dense view and runs the dense decode oracle —
    bit-identical to the unpaged path; the card runs the paged kernel with
    one descriptor (b, cur_len[b]) per sequence, as the JAX package does on
    the TPU. Returns [B, H, d]."""
    b, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    if not _on_cuda(q):
        out = ref.paged_decode_attention(
            q.reshape(b, kvh, h // kvh, d), k, v, cur_len, block_tables, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
        return out.reshape(b, h, d)
    return paged_ragged_attention(
        q, k, v, _seq_ids(b, q.device), cur_len, block_tables, window=window,
        k_scale=k_scale, v_scale=v_scale,
    )
