"""Wrappers of the CUDA flash attention kernel (``csrc/flash_attention.cu``),
the port of ``repro/kernels/flash_attention.py::gqa_flash_attention`` and
``::flash_attention``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.gqa_flash_attention`` / ``ref.flash_attention``. ``launches`` counts
GQA launches, ``launches_flat`` flat ones. The flat op rides the GQA kernel
with a group of one and takes the autotuner's tile; the GQA op (the serving
path's prefill) keeps the default tile.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks

launches = 0
launches_flat = 0

DEFAULT_TILE = (16, 32)  # (block_q, block_k) of the serving path
TILES = (DEFAULT_TILE, (32, 32), (32, 64), (64, 64))  # the instantiated tiles


def _launch(name: str, q, k, v, bkv: int, g: int, sq: int, causal: bool,
            block_q: int, block_k: int) -> torch.Tensor:
    _checks.cuda_operands(name, q, k, v)
    _checks.aligned_rows(name, q, k, v)
    dtype = _checks.float_code(name, q, k, v)
    d = q.shape[-1]
    if k.ndim != 3 or k.shape[0] != bkv or k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if k.shape[1] == 0:
        raise ValueError(f"{name}: no keys")
    rc = _build.load().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bkv, g, sq, k.shape[1], d, int(bool(causal)), block_q, block_k, dtype,
        _checks.stream(q),
    )
    _build.check(rc, name)
    return out


def gqa_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q: [BKV, G, Sq, d]; k/v: [BKV, Sk, d]. Keys past Sk are masked (tail
    tiles), and with ``causal`` query i sees keys j <= i. Returns
    [BKV, G, Sq, d] on q's device and stream, without synchronising."""
    global launches
    bkv, g, sq, _ = q.shape
    out = _launch("gqa_flash_attention", q, k, v, bkv, g, sq, causal, *DEFAULT_TILE)
    if out.numel():
        launches += 1
    return out


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    block_q: int = DEFAULT_TILE[0], block_k: int = DEFAULT_TILE[1],
) -> torch.Tensor:
    """q: [BH, Sq, d]; k/v: [BH, Sk, d] (batch·heads flattened), d of 16, 32,
    64 or 128, (block_q, block_k) one of :data:`TILES`. Keys past Sk are
    masked, and with ``causal`` query i sees keys j <= i. Returns
    [BH, Sq, d] on q's device and stream, without synchronising."""
    global launches_flat
    if q.ndim != 3:
        raise ValueError(f"flash_attention: q must be [BH, S, d], got {tuple(q.shape)}")
    bh, sq, _ = q.shape
    out = _launch("flash_attention", q, k, v, bh, 1, sq, causal, block_q, block_k)
    if out.numel():
        launches_flat += 1
    return out
