"""Wrapper of the CUDA ragged attention kernel (``csrc/ragged_attention.cu``),
the port of ``repro/kernels/ragged_attention.py::ragged_attention`` — its
``_ragged_kernel`` and, over a quantized store, ``_ragged_kernel_q8``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.ragged_attention``. ``launches`` counts launches over an unscaled
store, ``launches_q8`` over a scaled one (int8, fp8, or the f32 lane).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _checks

launches = 0
launches_q8 = 0


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
) -> torch.Tensor:
    """q: [T, KV, G, d]; k/v: [B, S_max, KV, d] (f32/bf16 as q, or int8/fp8
    with ``k_scale``/``v_scale`` [B, S_max, KV] f32); tok_slot/tok_pos: [T]
    int32 with ``tok_slot`` a cache row in [0, B). Returns [T, KV, G, d] on
    q's device and stream, without synchronising. Padding rows (``tok_pos >=
    S_max``) read no key and come back as zeros; ``ref.ragged_attention``
    attends the whole slot there, and nothing reads them."""
    global launches, launches_q8
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
    if t == 0:
        return out
    lib = _build.load()
    rc = lib.repro_ragged_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _checks.ptr(k_scale), _checks.ptr(v_scale),
        tok_slot.data_ptr(), tok_pos.data_ptr(), out.data_ptr(), t, k.shape[1], kvh, g, d,
        int(window), qd, sd, _checks.stream(q),
    )
    _build.check(rc, name)
    if k_scale is None:
        launches += 1
    else:
        launches_q8 += 1
    return out
