"""Wrapper of the CUDA decode attention kernel (``csrc/decode_attention.cu``),
the port of ``repro/kernels/decode_attention.py::decode_attention`` — its
``_decode_kernel`` and, over a quantized store, ``_decode_kernel_q8``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.decode_attention``. ``launches`` counts launches over an unscaled
store, ``launches_q8`` over a scaled one (int8, fp8, or the f32 lane).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _checks

launches = 0
launches_q8 = 0


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cur_len: torch.Tensor, *,
    window: int = 0, k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q: [B, KV, G, d]; k/v: [B, S_max, KV, d] (f32/bf16 as q, or int8/fp8
    with ``k_scale``/``v_scale`` [B, S_max, KV] f32); cur_len: [B] int32.
    Returns [B, KV, G, d] on q's device and stream, without synchronising."""
    global launches, launches_q8
    name = "decode_attention"
    scales = [s for s in (k_scale, v_scale) if s is not None]
    _checks.cuda_operands(name, q, k, v, cur_len, *scales)
    _checks.aligned_rows(name, q, k, v)
    qd, sd = _checks.kv_codes(name, q, k, v, k_scale, v_scale)
    b, kvh, g, d = q.shape
    _checks.attention_domain(name, d, g)
    if k.ndim != 4 or k.shape[0] != b or k.shape[2:] != (kvh, d) or v.shape != k.shape:
        raise ValueError(f"{name}: cache shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _checks.int32_vector(name, "cur_len", cur_len, b)
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load()
    rc = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _checks.ptr(k_scale), _checks.ptr(v_scale),
        cur_len.data_ptr(), out.data_ptr(), b, k.shape[1], kvh, g, d, int(window), qd, sd,
        _checks.stream(q),
    )
    _build.check(rc, name)
    if k_scale is None:
        launches += 1
    else:
        launches_q8 += 1
    return out
