"""Wrapper of the CUDA paged attention kernel (``csrc/paged_attention.cu``),
the port of ``repro/kernels/ragged_attention.py::paged_ragged_attention`` —
its ``_paged_kernel`` and, over a quantized store, ``_paged_kernel_q8``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.paged_ragged_attention`` / ``ref.paged_decode_attention``.
``launches`` counts launches over an unscaled pool, ``launches_q8`` over a
scaled one (int8, fp8, or the f32 lane).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _checks

launches = 0
launches_q8 = 0


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
) -> torch.Tensor:
    """q: [T, KV, G, d]; k/v: pool [NB, bs, KV, d] (f32/bf16 as q, or
    int8/fp8 with ``k_scale``/``v_scale`` [NB, bs, KV] f32); tok_seq/tok_pos:
    [T] int32, token t at position ``tok_pos[t]`` of table row
    ``tok_seq[t]``; block_tables: [R, max_blocks] int32 (entries >= NB are
    the unallocated sentinel). Returns [T, KV, G, d] on q's device and
    stream, without synchronising. Padding rows (``tok_pos >= max_blocks *
    bs``) read no key and come back as zeros; the plain version attends the
    whole row there, and nothing reads them."""
    global launches, launches_q8
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
    if t == 0:
        return out
    lib = _build.load()
    nb, bs = k.shape[0], k.shape[1]
    rc = lib.repro_paged_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _checks.ptr(k_scale), _checks.ptr(v_scale),
        tok_seq.data_ptr(), tok_pos.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
        t, nb, bs, block_tables.shape[1], kvh, g, d, int(window), qd, sd,
        _checks.stream(q),
    )
    _build.check(rc, name)
    if k_scale is None:
        launches += 1
    else:
        launches_q8 += 1
    return out
