"""Wrapper of the CUDA GQA flash attention kernel (``csrc/flash_attention.cu``),
the port of ``repro/kernels/flash_attention.py::gqa_flash_attention``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.gqa_flash_attention``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks

launches = 0


def gqa_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q: [BKV, G, Sq, d]; k/v: [BKV, Sk, d]. Keys past Sk are masked (tail
    tiles), and with ``causal`` query i sees keys j <= i. Returns
    [BKV, G, Sq, d] on q's device and stream, without synchronising."""
    global launches
    name = "gqa_flash_attention"
    _checks.cuda_operands(name, q, k, v)
    _checks.aligned_rows(name, q, k, v)
    dtype = _checks.float_code(name, q, k, v)
    bkv, g, sq, d = q.shape
    if k.ndim != 3 or k.shape[0] != bkv or k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if k.shape[1] == 0:
        raise ValueError(f"{name}: no keys")
    lib = _build.load()
    rc = lib.repro_gqa_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bkv, g, sq, k.shape[1], d, int(bool(causal)), dtype,
        _checks.stream(q),
    )
    _build.check(rc, name)
    launches += 1
    return out
