"""Wrapper of the CUDA latent-MQA ragged attention kernel
(``csrc/mla_attention.cu``), the port of
``repro/kernels/ragged_attention.py::ragged_attention`` (``_ragged_kernel``)
as ``repro/kernels/ops.py::mla_ragged_attention`` drives it over the MLA
latent cache.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.mla_ragged_attention``. ``launches`` counts every launch,
``launches_wgmma`` those of the bf16 body.

bf16 (every served width): the (token, head) pairs of ``[T * H]`` are the
rows, flattened, in tiles of :data:`ROWS` (one wgmma M), so the tokens of a
tile share every staged latent row; each tile's ``S_max`` positions split
into spans as :func:`plan` picks them from host values only, so a CUDA graph
can capture the launch. The partials of a split call are a ``torch.empty``
per call on the caller's stream, merged in split order by the last block of
each tile on the per-(device, stream) ticket counters of
:func:`repro_torch.kernels._checks.tickets`. ``ref.mla_ragged_attention_split``
is the body's plain twin. f32 (the reduced configs): one block per (token,
chunk of :data:`F32_ROWS` heads) on the CUDA cores, one span.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _checks
from repro_torch.kernels import decode_attention as _dk

launches = 0
launches_wgmma = 0

ROWS = 64  # (token, head) rows of a bf16 tile: one wgmma M
F32_ROWS = 16  # heads of an f32 block
MAX_SPLITS = 16  # splits of a bf16 launch (the merge keeps a weight a split and row)


def plan(t: int, h: int, s_max: int, dtype: torch.dtype, sms: int,
         splits: Optional[int] = None) -> tuple[int, int, int, int]:
    """(rows a block, blocks along the rows, positions a split, splits) of a
    pack of ``t`` tokens of ``h`` heads over ``s_max`` positions, from host
    values only. bf16: tiles of ROWS of the ``t * h`` (token, head) rows and
    ``splits`` None for the fewest spans whose blocks give every SM of
    ``sms`` one (``decode_attention.split_count`` at one wave, spans of
    multiples of 256 positions; one where the tiles outnumber half the
    ticket counters), n >= 1 to ask for n
    (``decode_attention.split_span``), at most MAX_SPLITS: minicpm3's 40
    heads over phase 2's 64-token pack are 40 tiles, so 4 spans of 256. f32:
    a block per token and chunk of F32_ROWS heads, one span."""
    if splits is not None and splits < 1:
        raise ValueError(f"mla_ragged_attention: splits must be >= 1, got {splits}")
    if dtype != torch.bfloat16:
        if splits not in (None, 1):
            raise ValueError("mla_ragged_attention: the f32 body takes one split")
        return F32_ROWS, t * -(-h // F32_ROWS), max(s_max, 1), 1
    tiles = -(-t * h // ROWS)
    if splits is None:  # one split where the tiles outnumber the counters (two a tile)
        splits = 1 if 2 * tiles > _checks.TICKETS else _dk.split_count(s_max, tiles, 1, 1, sms,
                                                                       waves=1)
    return (ROWS, tiles, *_dk.split_span(s_max, min(splits, MAX_SPLITS)))


def mla_attention(
    q_eff: torch.Tensor,
    q_rope: torch.Tensor,
    ckv: torch.Tensor,
    krope: torch.Tensor,
    tok_slot: torch.Tensor,
    tok_pos: torch.Tensor,
    *,
    scale: float,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """q_eff: [T, H, r]; q_rope: [T, H, rope]; ckv: [B, S_max, r]; krope:
    [B, S_max, rope], all f32 or all bf16; tok_slot/tok_pos: [T] int32 with
    ``tok_slot`` a cache row in [0, B). ``splits``: None for :func:`plan`'s,
    n >= 1 to ask for n (bf16 only). Returns [T, H, r] on q_eff's device and
    stream, without synchronising. Padding rows (``tok_pos >= S_max``) read
    no key and come back as zeros; ``ref.mla_ragged_attention`` attends the
    whole slot there, and nothing reads them."""
    global launches, launches_wgmma
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
    if t * h >= 2**31 - ROWS:
        raise ValueError(f"{name}: T * H must be below 2^31 - {ROWS}, got {t * h}")
    out = torch.empty_like(q_eff)
    if t == 0:
        return out
    b, s_max = ckv.shape[0], ckv.shape[1]
    bf16 = q_eff.dtype == torch.bfloat16
    sms = _dk._sms(q_eff.device.index) if bf16 and splits is None else 0
    _, blocks, span, n = plan(t, h, s_max, q_eff.dtype, sms, splits)
    if n > 1 and 2 * blocks > _checks.TICKETS:  # a ticket and a published count a tile
        raise ValueError(f"{name}: a split launch takes up to {_checks.TICKETS // 2} tiles, got "
                         f"{blocks}")
    lib = _build.load()
    stream = _checks.stream(q_eff)
    ws = counters = None
    if n > 1:  # this call's partials, on the caller's stream
        ws = torch.empty(blocks * n * (64 * r + 512), dtype=torch.float32, device=q_eff.device)
        counters = _checks.tickets(q_eff.device, stream)
    rc = lib.repro_mla_attention(
        q_eff.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(), krope.data_ptr(),
        tok_slot.data_ptr(), tok_pos.data_ptr(), _checks.ptr(ws), _checks.ptr(counters),
        out.data_ptr(), t, b, s_max, h, r, rope, span, float(scale), code, stream,
    )
    _build.check(rc, name)
    launches += 1
    if bf16:
        launches_wgmma += 1
    return out
