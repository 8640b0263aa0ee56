"""The latent-MQA kernel's bf16 body (``csrc/mla_attention.cu``,
``mla_wgmma_kernel``): (token, head) rows in 64-row tiles, a pass per slot,
split-KV spans and the ordered merge.

CPU (runs anywhere):
- ``ref.mla_ragged_attention_split`` (the body's plan walked in f32: tiles,
  passes, spans, the merge in split order) against the JAX package's
  ``ops.mla_ragged_attention`` in ``interpret`` mode (the Pallas ragged
  kernel as latent MQA) and its ``ref``, and the port's
  ``ref.mla_ragged_attention``: latent 32 + rope 8 and 256 + 32, 1, 4 and 40
  heads, f32 and bf16, 1, 2 and 4 splits, a pack whose tiles cross slots
  with a padding token, and singletons. Live rows only against JAX (a
  padding token gets its whole slot's average there, zeros from the port).
  Tolerances: 2e-5 absolute at f32 (softmax over <= 48 keys, summation
  order only) and 2e-2 at a bf16 output (one bf16 rounding of an f32
  result; the JAX kernel also rounds its pre-scaled bf16 query), as
  ``tests/test_torch_ragged_split.py``.
- ``mla_attention.plan`` over every engine T bucket and 1-64 heads, and what
  the wrapper hands the C library (a stand-in records the calls): grid,
  span, scratch and the stream's ticket counters from host values only,
  ``splits=`` forcing a count, the launch counters, and the refusals.

The card's checks of the kernel are in ``tests/test_torch_mla.py`` (``-m
cuda``) and ``chip_smoke.py`` phase 2.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _checks, ref
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import mla_attention as mk
from test_torch_tc_paged import TOL, _jax, fake_c, jx  # noqa: F401

B, S = 4, 48
# 6 prompt tokens of slot 2, a decode of slot 0 at the last position, 3 of
# slot 1 at the first positions, 2 of slot 3, and a padding token riding
# slot 2: at 40 heads a tile holds 1.6 tokens, so tiles cross slots
PACK_SLOT = [2] * 6 + [0] + [1] * 3 + [3] * 2 + [2]
PACK_POS = list(range(10, 16)) + [47] + [0, 1, 2] + [20, 33] + [S]
SINGLE_SLOT = [0, 1, 2, 3]
SINGLE_POS = [47, 0, 20, 33]
WIDTHS = {"reduced": (32, 8), "minicpm3": (256, 32)}


def _case(seed, r, rope, h, dtype, kind):
    rng = np.random.default_rng(seed)
    slot, pos = (PACK_SLOT, PACK_POS) if kind == "pack" else (SINGLE_SLOT, SINGLE_POS)
    t = len(slot)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    return (arr(t, h, r), arr(t, h, rope), arr(B, S, r), arr(B, S, rope),
            torch.tensor(slot, dtype=torch.int32), torch.tensor(pos, dtype=torch.int32))


@pytest.mark.parametrize("width,h,dname,kind", [
    ("reduced", 4, "float32", "pack"),
    ("reduced", 1, "bfloat16", "pack"),
    ("reduced", 40, "float32", "singles"),
    ("reduced", 4, "bfloat16", "singles"),
    ("minicpm3", 40, "bfloat16", "pack"),
    ("minicpm3", 40, "float32", "pack"),
    ("minicpm3", 4, "float32", "singles"),
    ("minicpm3", 1, "float32", "pack"),
])
def test_mla_split_twin_vs_jax(jx, width, h, dname, kind):
    jnp, jref, jops = jx
    r, rope = WIDTHS[width]
    dtype = getattr(torch, dname)
    args = _case(r + h, r, rope, h, dtype, kind)
    scale = (r // 4 + rope) ** -0.5
    live = (args[5] < S).numpy()
    jargs = [_jax(jnp, x) for x in args]
    want = [np.asarray(jops.mla_ragged_attention(*jargs, scale=scale, mode="interpret"),
                       np.float32),
            np.asarray(jref.mla_ragged_attention(*jargs, scale=scale), np.float32)]
    plain = ref.mla_ragged_attention(*args, scale=scale)
    for splits in (1, 2, 4):
        got = ref.mla_ragged_attention_split(*args, scale=scale, splits=splits)
        assert got.dtype == dtype and got.shape == args[0].shape
        assert not got[~torch.from_numpy(live)].any()  # padding: zeros, no key read
        mine = got.float().numpy()[live]
        for w in want:
            np.testing.assert_allclose(mine, w[live], atol=TOL[dname], rtol=0)
        np.testing.assert_allclose(mine, plain.float().numpy()[live], atol=TOL[dname], rtol=0)


def test_mla_split_tiles_cross_slots_and_spans():
    """At 40 heads the pack's 64-row tiles hold rows of two slots, and the
    twin's result does not depend on the tile height or the span beyond f32
    summation order; rows of 16 with one span equal the plain version."""
    r, rope, h = 32, 8, 40
    args = _case(3, r, rope, h, torch.float32, "pack")
    slots = args[4].repeat_interleave(h)
    tiles = [set(slots[m0:m0 + 64].tolist()) for m0 in range(0, slots.numel(), 64)]
    assert any(len(x) > 1 for x in tiles)
    scale = 0.2
    base = ref.mla_ragged_attention_split(*args, scale=scale, rows=16)
    for rows, span in ((64, None), (64, 5), (128, 16), (1, 7)):
        got = ref.mla_ragged_attention_split(*args, scale=scale, rows=rows, span=span)
        torch.testing.assert_close(got, base, atol=2e-6, rtol=0)
    live = args[5] < S
    torch.testing.assert_close(base[live], ref.mla_ragged_attention(*args, scale=scale)[live],
                               atol=2e-6, rtol=0)


# ------------------------------------------------------------------- the plan

T_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 256)  # serve/engine.py's _T_BUCKETS, then doubling


@pytest.mark.parametrize("h", [1, 4, 16, 40, 64])
def test_plan_tiles_every_engine_bucket(h):
    for t in T_BUCKETS:
        for s_max in (64, 1024, 4096):
            rows, tiles, span, splits = mk.plan(t, h, s_max, torch.bfloat16, 132)
            assert rows == mk.ROWS == 64 and tiles == -(-t * h // 64)
            assert span % 256 == 0 and (splits - 1) * span < s_max <= splits * span
            assert splits <= mk.MAX_SPLITS
            # the fewest spans whose blocks give every SM one, where spans allow
            assert tiles * splits >= 132 or span == 256 or splits == 1
            if splits > 1:
                assert tiles * dk.split_span(s_max, splits - 1)[1] < 132
            assert mk.plan(t, h, s_max, torch.bfloat16, 132, splits=2)[2:] == \
                dk.split_span(s_max, 2)
            assert mk.plan(t, h, s_max, torch.float32, 132) == (16, t * -(-h // 16), s_max, 1)


def test_plan_refusals_and_caps():
    with pytest.raises(ValueError, match="splits"):
        mk.plan(8, 40, 1024, torch.bfloat16, 132, splits=0)
    with pytest.raises(ValueError, match="one split"):
        mk.plan(8, 40, 1024, torch.float32, 132, splits=2)
    assert mk.plan(8, 40, 1024, torch.float32, 132, splits=1)[3] == 1
    # at most MAX_SPLITS spans, planned or asked: the merge keeps a weight a split
    assert mk.plan(1, 1, 1 << 16, torch.bfloat16, 132)[2:] == \
        dk.split_span(1 << 16, mk.MAX_SPLITS)
    assert mk.plan(8, 40, 1 << 16, torch.bfloat16, 132, splits=1000)[3] == mk.MAX_SPLITS


# ------------------------------------------- what the wrapper hands the C library


def _call(t, h, r=256, rope=32, s_max=1024, dtype=torch.bfloat16, **kw):
    z = dict(dtype=dtype)
    i32 = torch.zeros(t, dtype=torch.int32)
    return mk.mla_attention(torch.zeros(t, h, r, **z), torch.zeros(t, h, rope, **z),
                            torch.zeros(4, s_max, r, **z), torch.zeros(4, s_max, rope, **z),
                            i32, i32, scale=0.125, **kw)


@pytest.mark.parametrize("t,h,r,rope,dtype,kw,want", [
    # (tiles, span, splits): phase 2's pack at minicpm3's widths: 40 tiles, 4
    # spans of 256 give 160 blocks
    (64, 40, 256, 32, torch.bfloat16, {}, (40, 256, 4)),
    (64, 16, 512, 64, torch.bfloat16, {}, (16, 256, 4)),  # deepseek: at most 4 spans
    (128, 40, 256, 32, torch.bfloat16, {}, (80, 512, 2)),  # the 128-token bucket
    (256, 40, 256, 32, torch.bfloat16, {}, (160, 1024, 1)),  # the tiles fill the SMs
    (64, 40, 256, 32, torch.bfloat16, dict(splits=1), (40, 1024, 1)),
    (64, 40, 256, 32, torch.bfloat16, dict(splits=3), (40, 512, 2)),  # spans of 512: 2
    (8, 4, 32, 8, torch.bfloat16, {}, (1, 256, 4)),
    (64, 40, 256, 32, torch.float32, {}, (192, 1024, 1)),  # a block per token and 16 heads
])
def test_mla_wrapper_grid_span_and_scratch_from_host_values(fake_c, t, h, r, rope, dtype, kw,
                                                            want):
    n0 = (mk.launches, mk.launches_wgmma)
    out = _call(t, h, r, rope, dtype=dtype, **kw)
    assert out.shape == (t, h, r) and out.dtype == dtype
    bf16 = dtype == torch.bfloat16
    assert (mk.launches, mk.launches_wgmma) == (n0[0] + 1, n0[1] + bf16)
    tiles, span, splits = want
    assert mk.plan(t, h, 1024, dtype, 132, kw.get("splits"))[1:] == want
    (name, args), = fake_c
    # (q_eff, q_rope, ckv, krope, tok_slot, tok_pos, ws, counters, out, T, B, S, H, R, ROPE,
    #  span, scale, dtype, stream)
    assert name == "repro_mla_attention"
    assert args[9:16] == (t, 4, 1024, h, r, rope, span)
    assert args[16:18] == (0.125, _checks.DTYPE_CODES[dtype])
    assert (args[6] is not None, args[7] is not None) == (splits > 1,) * 2
    if splits > 1:  # the stream's ticket counters
        assert args[7] == _checks.tickets(torch.device("cpu"), 0).data_ptr()


def test_mla_wrapper_refusals_and_empty_pack(fake_c, monkeypatch):
    """No token: no C call and no launch counted; a forced split past the
    ticket counters (two a tile: 8 of them here), a forced split at f32 and
    splits=0 raise before the C call; past the counters the kernel's own
    plan takes one split."""
    n0 = (mk.launches, mk.launches_wgmma)
    assert _call(0, 40).shape == (0, 40, 256)
    assert (mk.launches, mk.launches_wgmma) == n0 and not fake_c
    monkeypatch.setattr(_checks, "TICKETS", 8)
    dk.split_count.cache_clear()  # its memo holds plans made under the real count
    try:
        with pytest.raises(ValueError, match="split launch"):
            _call(8, 40, r=32, rope=8, splits=2)  # 5 tiles
        with pytest.raises(ValueError, match="one split"):
            _call(8, 4, dtype=torch.float32, splits=2)
        with pytest.raises(ValueError, match="splits"):
            _call(8, 40, splits=0)
        assert not fake_c
        _call(8, 40, r=32, rope=8)
        (_, args), = fake_c
        assert args[15] == 1024 and args[6] is None  # one span, no scratch
    finally:
        dk.split_count.cache_clear()
