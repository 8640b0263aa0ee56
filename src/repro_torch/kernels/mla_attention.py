"""Wrapper of the CUDA latent-MQA ragged attention kernel
(``csrc/mla_attention.cu``), the port of
``repro/kernels/ragged_attention.py::ragged_attention`` (``_ragged_kernel``)
as ``repro/kernels/ops.py::mla_ragged_attention`` drives it over the MLA
latent cache.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.mla_ragged_attention``. ``launches`` counts the kernel's launches.

One block per (token, chunk of heads): the query heads are the rows of the
block's tile, 16 x ``mt`` of them, so one staged latent row serves every
head of the chunk; :func:`plan` picks ``mt`` and the chunks from host values
only, so a CUDA graph can capture the launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks

launches = 0

# m16 row tiles a block may hold at bf16 per latent width: the accumulator
# of 16 x mt rows x r dims over eight warps stays at <= 48 f32 registers a
# thread (r 256: 48 rows; r 512: 16 rows). f32 rows run on the CUDA cores,
# 16 a block.
MAX_TILES = {32: 4, 256: 3, 512: 1}


def plan(h: int, r: int, dtype: torch.dtype) -> tuple[int, int]:
    """(mt, chunks): the m16 row tiles of a block and the chunks of heads a
    token takes for ``h`` heads at latent width ``r``. The heads split into
    the fewest chunks of at most 16 x MAX_TILES[r] rows (16 at f32), each
    chunk as narrow as its share of the heads allows: minicpm3's 40 heads
    are one chunk of 48 rows, 64 heads at r 256 two of 32."""
    most = MAX_TILES[r] if dtype == torch.bfloat16 else 1
    chunks = _cdiv(h, 16 * most)
    mt = _cdiv(_cdiv(h, chunks), 16)
    return mt, _cdiv(h, 16 * mt)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def mla_attention(
    q_eff: torch.Tensor,
    q_rope: torch.Tensor,
    ckv: torch.Tensor,
    krope: torch.Tensor,
    tok_slot: torch.Tensor,
    tok_pos: torch.Tensor,
    *,
    scale: float,
) -> torch.Tensor:
    """q_eff: [T, H, r]; q_rope: [T, H, rope]; ckv: [B, S_max, r]; krope:
    [B, S_max, rope], all f32 or all bf16; tok_slot/tok_pos: [T] int32 with
    ``tok_slot`` a cache row in [0, B). Returns [T, H, r] on q_eff's device
    and stream, without synchronising. Padding rows (``tok_pos >= S_max``)
    read no key and come back as zeros; ``ref.mla_ragged_attention`` attends
    the whole slot there, and nothing reads them."""
    global launches
    name = "mla_ragged_attention"
    _checks.cuda_operands(name, q_eff, q_rope, ckv, krope, tok_slot, tok_pos)
    _checks.aligned_rows(name, q_eff, q_rope, ckv, krope)
    code = _checks.float_code(name, q_eff, q_rope, ckv, krope)
    t, h, r = q_eff.shape
    rope = q_rope.shape[-1]
    _checks.mla_domain(r, rope, h)
    if (q_rope.shape != (t, h, rope) or ckv.ndim != 3 or ckv.shape[2] != r
            or krope.shape != (*ckv.shape[:2], rope)):
        raise ValueError(f"{name}: shapes q_eff {tuple(q_eff.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, ckv {tuple(ckv.shape)}, krope "
                         f"{tuple(krope.shape)} do not match")
    _checks.int32_vector(name, "tok_slot", tok_slot, t)
    _checks.int32_vector(name, "tok_pos", tok_pos, t)
    _checks.c_int_dims(name, q_eff, ckv)
    out = torch.empty_like(q_eff)
    if t == 0:
        return out
    mt, _ = plan(h, r, q_eff.dtype)
    lib = _build.load()
    rc = lib.repro_mla_attention(
        q_eff.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(), krope.data_ptr(),
        tok_slot.data_ptr(), tok_pos.data_ptr(), out.data_ptr(), t, ckv.shape[1], h, r, rope,
        mt, float(scale), code, _checks.stream(q_eff),
    )
    _build.check(rc, name)
    launches += 1
    return out
