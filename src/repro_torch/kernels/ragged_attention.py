"""Wrapper of the CUDA ragged attention kernel (``csrc/ragged_attention.cu``),
the port of ``repro/kernels/ragged_attention.py::ragged_attention``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.ragged_attention``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks

launches = 0


def ragged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tok_slot: torch.Tensor,
    tok_pos: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """q: [T, KV, G, d]; k/v: [B, S_max, KV, d]; tok_slot/tok_pos: [T] int32
    with ``tok_slot`` a cache row in [0, B). Returns [T, KV, G, d] on q's
    device and stream, without synchronising. Padding rows (``tok_pos >=
    S_max``) read no key and come back as zeros; ``ref.ragged_attention``
    attends the whole slot there, and nothing reads them."""
    global launches
    name = "ragged_attention"
    _checks.cuda_operands(name, q, k, v, tok_slot, tok_pos)
    dtype = _checks.float_code(name, q, k, v)
    t, kvh, g, d = q.shape
    if k.ndim != 4 or k.shape[2:] != (kvh, d) or v.shape != k.shape:
        raise ValueError(f"{name}: cache shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _checks.int32_vector(name, "tok_slot", tok_slot, t)
    _checks.int32_vector(name, "tok_pos", tok_pos, t)
    out = torch.empty_like(q)
    if t == 0:
        return out
    lib = _build.load()
    rc = lib.repro_ragged_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tok_slot.data_ptr(), tok_pos.data_ptr(),
        out.data_ptr(), t, k.shape[1], kvh, g, d, int(window), dtype,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, name)
    launches += 1
    return out
