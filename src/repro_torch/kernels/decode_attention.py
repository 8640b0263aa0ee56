"""Wrapper of the CUDA decode attention kernel (``csrc/decode_attention.cu``),
the port of ``repro/kernels/decode_attention.py::decode_attention``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.decode_attention``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks

launches = 0


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cur_len: torch.Tensor, *, window: int = 0
) -> torch.Tensor:
    """q: [B, KV, G, d]; k/v: [B, S_max, KV, d]; cur_len: [B] int32.
    Returns [B, KV, G, d] on q's device and stream, without synchronising."""
    global launches
    name = "decode_attention"
    _checks.cuda_operands(name, q, k, v, cur_len)
    dtype = _checks.float_code(name, q, k, v)
    b, kvh, g, d = q.shape
    if k.ndim != 4 or k.shape[0] != b or k.shape[2:] != (kvh, d) or v.shape != k.shape:
        raise ValueError(f"{name}: cache shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _checks.int32_vector(name, "cur_len", cur_len, b)
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load()
    rc = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cur_len.data_ptr(), out.data_ptr(),
        b, k.shape[1], kvh, g, d, int(window), dtype,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, name)
    launches += 1
    return out
