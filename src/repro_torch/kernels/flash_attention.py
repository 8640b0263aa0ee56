"""Wrappers of the CUDA flash attention kernel (``csrc/flash_attention.cu``),
the port of ``repro/kernels/flash_attention.py::gqa_flash_attention`` and
``::flash_attention``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.gqa_flash_attention`` / ``ref.flash_attention``. ``launches`` counts
GQA launches, ``launches_flat`` flat ones. The flat op rides the GQA kernel
with a group of one and takes the autotuner's tile; the GQA op (the serving
path's prefill) takes its dtype's :data:`DEFAULT_TILE` unless a tile is
pinned.

bf16 runs on Hopper's tensor cores (wgmma), the G heads of a group packed
into the 64-row M tile; f32 keeps a CUDA-core body (wgmma would read f32 as
TF32). The tiles and the default tile differ by dtype (:data:`TILES`,
:data:`DEFAULT_TILE`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks

launches = 0
launches_flat = 0

# (block_q, block_k) of the serving path by dtype: bf16 one warpgroup over 64
# keys; f32 the smallest CUDA-core tile, whose static shared memory and many
# blocks keep the engine's short prefill fastest (csrc/flash_attention.cu)
DEFAULT_TILE = {torch.bfloat16: (64, 64), torch.float32: (16, 32)}
# the instantiated (block_q, block_k) tiles of each dtype: bf16 one or two
# 64-row warpgroups x 64 or 128 keys; f32 4 query rows per warp x 32-64 keys
TILES = {
    torch.bfloat16: ((64, 64), (64, 128), (128, 64), (128, 128)),
    torch.float32: ((16, 32), (32, 32), (32, 64), (64, 64)),
}
HEAD_DIMS = _checks.HEAD_DIMS  # the head widths both bodies take


def _launch(name: str, q, k, v, bkv: int, g: int, sq: int, causal: bool,
            block_q: int | None, block_k: int | None) -> torch.Tensor:
    _checks.cuda_operands(name, q, k, v)
    _checks.aligned_rows(name, q, k, v)
    dtype = _checks.float_code(name, q, k, v)
    block_q = DEFAULT_TILE[q.dtype][0] if block_q is None else block_q
    block_k = DEFAULT_TILE[q.dtype][1] if block_k is None else block_k
    d = q.shape[-1]
    if k.ndim != 3 or k.shape[0] != bkv or k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or (block_q, block_k) not in TILES[q.dtype]:
        raise ValueError(f"{name}: no kernel instantiated for head_dim {d} at tile "
                         f"{(block_q, block_k)} in {q.dtype} (head_dim one of {HEAD_DIMS}, "
                         f"tiles {TILES[q.dtype]})")
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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    block_q: int | None = None, block_k: int | None = None,
) -> torch.Tensor:
    """q: [BKV, G, Sq, d]; k/v: [BKV, Sk, d], d one of :data:`HEAD_DIMS`,
    (block_q, block_k) one of q's dtype's :data:`TILES` (default: its
    :data:`DEFAULT_TILE`). Keys past Sk are masked (tail tiles), and with
    ``causal`` query i sees keys j <= i.
    Returns [BKV, G, Sq, d] on q's device and stream, without
    synchronising."""
    global launches
    bkv, g, sq, _ = q.shape
    out = _launch("gqa_flash_attention", q, k, v, bkv, g, sq, causal, block_q, block_k)
    if out.numel():
        launches += 1
    return out


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    block_q: int | None = None, block_k: int | None = None,
) -> torch.Tensor:
    """q: [BH, Sq, d]; k/v: [BH, Sk, d] (batch·heads flattened), d one of
    :data:`HEAD_DIMS`, (block_q, block_k) one of q's dtype's :data:`TILES`
    (default: its :data:`DEFAULT_TILE`). Keys past Sk are masked, and with
    ``causal`` query i sees keys j <= i.
    Returns [BH, Sq, d] on q's device and stream, without synchronising."""
    global launches_flat
    if q.ndim != 3:
        raise ValueError(f"flash_attention: q must be [BH, S, d], got {tuple(q.shape)}")
    bh, sq, _ = q.shape
    out = _launch("flash_attention", q, k, v, bh, 1, sq, causal, block_q, block_k)
    if out.numel():
        launches_flat += 1
    return out
