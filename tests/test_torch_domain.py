"""The domain of the port's kernels: every (head_dim, group) the serving
attention kernels take, flash attention's head widths and tiles, FFT rows
longer than one block, and conv2d over x and w of different dtypes.

CPU: the pure-Python statement of the attention kernels' domain
(``_checks.attention_domain``) against every (head_dim, group) of the port's
registry, the wrappers' refusal before any C call, the port's CPU ops
against the JAX package at the new widths and groups, the four-step FFT
composition (``kernels/fft.py::four_step``) over the plain row FFT against
the JAX FFT, and conv2d with a bf16 x and an f32 w against JAX. Tolerances:
2e-5 absolute for attention at f32 (softmax attention over <= 64 keys,
summation order only; the int8 and fp8 stores are dequantized alike on both
sides), the FFT's 1e-5 of max|plain| at f32 and conv2d's 2e-2 at a bf16
output (one bf16 rounding of an f32 sum), as in ``tests/test_torch_suite.py``.

CUDA (``-m cuda``, skipped without a card): each changed kernel against its
plain version: decode, ragged and paged attention at every new (D, G) over
bf16, f32 and int8 stores; flash attention at every bf16 tile and head
width, packed groups and Sq != Sk, and the f32 body at D = 80; the FFT at
2^15 to 2^20 points; conv2d with mixed dtypes.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.dist.compression import quantize_rows
from repro_torch.kernels import _build, _checks, ops, ref
from repro_torch.kernels import conv2d as cvk
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import fft as ffk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import paged_attention as pk
from repro_torch.kernels import ragged_attention as rk

TOL = 2e-5
# (head_dim, group) pairs the JAX package answers and the card refused before:
# the reduced configs (16, 1) and (16, 4), llama4-scout's (128, 5),
# mistral-large's (128, 12), zamba2's head width 80
NEW_PAIRS = [(16, 1), (16, 4), (16, 5), (32, 3), (80, 2), (80, 12), (128, 5), (128, 12),
             (64, 16)]


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.ref, repro.kernels.ops)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jref, jops


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax(jnp, *ts):
    out = []
    for t in ts:
        if t.dtype == torch.float8_e4m3fn:
            out.append(jnp.asarray(t.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn))
        else:
            out.append(jnp.asarray(t.numpy()))
    return out


# ------------------------------------------------------------ the domain


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_attention_domain_covers_the_registry(name, reduced):
    cfg = get_arch(name)
    cfg = cfg.reduced() if reduced else cfg
    if cfg.mla is not None:  # latent MQA: its own kernel's domain (plain-torch prefill)
        _checks.mla_domain(cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim, cfg.n_heads)
        return
    if cfg.n_heads == 0:  # an attention-free (ssm) stack launches no attention kernel
        assert cfg.family == "ssm", name
        return
    g = cfg.n_heads // cfg.n_kv_heads
    assert _checks.in_attention_domain(cfg.d_head, g), (name, cfg.d_head, g)
    assert cfg.d_head in fk.HEAD_DIMS


@pytest.mark.parametrize("d", _checks.HEAD_DIMS)
def test_attention_domain_takes_every_group_to_16(d):
    assert all(_checks.in_attention_domain(d, g) for g in range(1, 17))
    assert not _checks.in_attention_domain(d, 0)
    assert not _checks.in_attention_domain(d, 17)


@pytest.mark.parametrize("d,g", [(48, 1), (96, 2), (576, 16), (288, 40), (40, 4), (256, 1)])
def test_attention_domain_refuses_other_widths(d, g):
    assert not _checks.in_attention_domain(d, g)
    with pytest.raises(ValueError, match="head_dim"):
        _checks.attention_domain("decode_attention", d, g)


@pytest.fixture
def no_c_calls(monkeypatch):
    """CPU tensors pass the device checks, and any C call fails the test: a
    refusal must come from the Python domain check."""
    monkeypatch.setattr(_checks, "cuda_operands", lambda *a: None)
    monkeypatch.setattr(_checks, "aligned_rows", lambda *a: None)

    def load():
        raise AssertionError("the wrapper reached the C library")

    monkeypatch.setattr(_build, "load", load)


@pytest.mark.parametrize("d,g", [(48, 1), (128, 17), (576, 16)])
def test_serving_wrappers_refuse_outside_the_domain_before_the_c_call(no_c_calls, d, g):
    q = torch.zeros(2, 1, g, d)
    k = torch.zeros(2, 8, 1, d)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        dk.decode_attention(q, k, k, i32)
    with pytest.raises(ValueError, match="head_dim"):
        rk.ragged_attention(q, k, k, i32, i32)
    with pytest.raises(ValueError, match="head_dim"):
        pk.paged_attention(q, k, k, i32, i32, torch.zeros(2, 1, dtype=torch.int32))


@pytest.mark.parametrize("dtype,d,tile", [
    (torch.bfloat16, 48, (64, 64)), (torch.bfloat16, 64, (32, 64)),
    (torch.float32, 64, (128, 128)), (torch.float32, 96, (64, 64)),
])
def test_flash_wrapper_refuses_outside_its_tiles_before_the_c_call(no_c_calls, dtype, d, tile):
    q = torch.zeros(2, 16, d, dtype=dtype)
    with pytest.raises(ValueError, match="instantiated"):
        fk.flash_attention(q, q, q, block_q=tile[0], block_k=tile[1])


def test_flash_tiles_per_dtype():
    """Each dtype's serving default is one of its tiles; bf16's are wgmma's
    64-row warpgroups; the tuner sweeps the tiles of the call's dtype and
    defaults to its serving tile."""
    from repro_torch.kernels import autotune

    assert fk.DEFAULT_TILE.keys() == fk.TILES.keys()
    for dtype, tiles in fk.TILES.items():
        assert fk.DEFAULT_TILE[dtype] in tiles
        assert autotune.candidates("flash_attention", dtype) == [
            {"block_q": q, "block_k": k} for q, k in tiles]
        assert autotune.default("flash_attention", dtype) == dict(
            zip(("block_q", "block_k"), fk.DEFAULT_TILE[dtype]))
    assert all(q % 64 == 0 and k % 64 == 0 for q, k in fk.TILES[torch.bfloat16])


@pytest.fixture
def fake_c(monkeypatch):
    """CPU tensors pass the device checks, and every C entry point returns 0
    without touching memory; each call is recorded as (name, args)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_checks, "cuda_operands", lambda *a: None)
    monkeypatch.setattr(_checks, "aligned_rows", lambda *a: None)
    monkeypatch.setattr(_checks, "stream", lambda t: 0)
    monkeypatch.setattr(_build, "load", Lib)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_wrappers_launch_their_dtypes_default_tile(fake_c, dtype):
    """Without a pinned tile, both wrappers hand the C call the default tile
    of q's dtype."""
    q = torch.zeros(2, 3, 16, 64, dtype=dtype)
    k = torch.zeros(2, 16, 64, dtype=dtype)
    fk.gqa_flash_attention(q, k, k)
    fk.flash_attention(k, k, k)
    assert [name for name, _ in fake_c] == ["repro_flash_attention"] * 2
    # (q, k, v, out, bkv, g, sq, sk, d, causal, block_q, block_k, dtype, stream)
    assert all(args[10:12] == fk.DEFAULT_TILE[dtype] for _, args in fake_c)


# ------------------------------------------------- serving attention vs JAX


@pytest.mark.parametrize("d,g", [(16, 5), (16, 12), (80, 5), (80, 12)])
@pytest.mark.parametrize("quant", [None, torch.int8])
def test_decode_at_new_widths_vs_jax(d, g, quant, jx):
    jnp, jref, jops = jx
    rng = np.random.default_rng(d + g)
    b, kv, s_max = 3, 2, 40
    q = torch.from_numpy(_np(rng, b, kv * g, d))
    k, v = torch.from_numpy(_np(rng, b, s_max, kv, d)), torch.from_numpy(_np(rng, b, s_max, kv, d))
    cl = torch.tensor([0, 17, 39], dtype=torch.int32)
    sc = {}
    if quant is not None:
        k, ks = quantize_rows(k, quant)
        v, vs = quantize_rows(v, quant)
        sc = dict(k_scale=ks, v_scale=vs)
    got = ops.decode_attention(q, k, v, cl, **sc)
    jsc = dict(zip(sc, _jax(jnp, *sc.values())))
    want = jops.decode_attention(*_jax(jnp, q, k, v, cl), mode="interpret", **jsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("d,g", [(16, 5), (16, 12), (80, 5), (80, 12)])
@pytest.mark.parametrize("window", [0, 5])
def test_ragged_at_new_widths_vs_jax(d, g, window, jx):
    jnp, jref, jops = jx
    rng = np.random.default_rng(10 + d + g)
    b, kv, s_max = 3, 2, 30
    slots = np.asarray([2] * 6 + [0] * 5 + [1], np.int32)
    poss = np.asarray(list(range(4, 10)) + list(range(11, 16)) + [0], np.int32)
    t = len(slots)
    q = torch.from_numpy(_np(rng, t, kv * g, d))
    k, v = torch.from_numpy(_np(rng, b, s_max, kv, d)), torch.from_numpy(_np(rng, b, s_max, kv, d))
    ts, tp = torch.from_numpy(slots), torch.from_numpy(poss)
    got = ops.ragged_attention(q, k, v, ts, tp, window=window)
    want = jops.ragged_attention(*_jax(jnp, q, k, v, ts, tp), window=window, mode="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    want_ref = jref.ragged_attention(*_jax(jnp, q.reshape(t, kv, g, d), k, v, ts, tp),
                                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref).reshape(t, kv * g, d),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("d,g", [(16, 5), (16, 12), (80, 5), (80, 12)])
@pytest.mark.parametrize("quant", [None, torch.float8_e4m3fn])
def test_paged_at_new_widths_vs_jax(d, g, quant, jx):
    jnp, _, jops = jx
    rng = np.random.default_rng(20 + d + g)
    nb, bs, kv = 7, 8, 2
    k, v = torch.from_numpy(_np(rng, nb, bs, kv, d)), torch.from_numpy(_np(rng, nb, bs, kv, d))
    sc = {}
    if quant is not None:
        k, ks = quantize_rows(k, quant)
        v, vs = quantize_rows(v, quant)
        sc = dict(k_scale=ks, v_scale=vs)
    btab = torch.tensor([[4, 1, 6], [0, 5, nb]], dtype=torch.int32)
    seq = torch.tensor([0, 1, 1, 1, 1], dtype=torch.int32)
    pos = torch.tensor([20, 9, 10, 11, 12], dtype=torch.int32)
    q = torch.from_numpy(_np(rng, 5, kv * g, d))
    got = ops.paged_ragged_attention(q, k, v, seq, pos, btab, **sc)
    jsc = dict(zip(sc, _jax(jnp, *sc.values())))
    want = jops.paged_ragged_attention(*_jax(jnp, q, k, v, seq, pos, btab), mode="interpret",
                                       **jsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# ------------------------------------------------------------ FFT, conv2d


def _fft_err(got, want) -> float:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n", [4, 64, 32768])
def test_four_step_over_the_plain_row_fft_vs_jax(n, jx):
    """The long-row composition the card runs, with the plain row FFT and
    the plain transpose in place of the kernels, against the JAX FFT."""
    _, jref, _ = jx
    rng = np.random.default_rng(n)
    re, im = _np(rng, 2, n), _np(rng, 2, n)
    gr, gi = ffk.four_step(torch.from_numpy(re), torch.from_numpy(im), ref.fft, ref.fft_transpose)
    wr, wi = jref.fft(re, im)
    assert _fft_err(gr, wr) < 1e-5 and _fft_err(gi, wi) < 1e-5


@pytest.mark.parametrize("n,max_row", [(1024, 16), (32768, 16), (32768, 4)])
def test_four_step_recurses_past_the_row_limit_vs_jax(n, max_row, jx):
    """A row pass longer than the row limit is a four-step FFT in turn, as
    on the card from 2^29 points, where N2 = 2^15 passes a block: here at a
    limit of 16 or 4 points, over the plain pieces, against the JAX FFT."""
    _, jref, _ = jx
    rows, transposes = [], []

    def row_fft(re, im):
        rows.append(re.shape[1])
        return ref.fft(re, im)

    def transpose(*args):
        transposes.append(args[0].shape)
        return ref.fft_transpose(*args)

    rng = np.random.default_rng(n + max_row)
    re, im = _np(rng, 2, n), _np(rng, 2, n)
    gr, gi = ffk.four_step(torch.from_numpy(re), torch.from_numpy(im), row_fft, transpose,
                           max_row=max_row)
    assert max(rows) <= max_row and len(transposes) > 3
    wr, wi = jref.fft(re, im)
    assert _fft_err(gr, wr) < 1e-5 and _fft_err(gi, wi) < 1e-5


def _launches_of_one_call(n: int) -> int:
    """Kernel launches of one ``fft`` call at ``n`` points: the row kernel
    once up to the row limit, else three transposes and two row passes."""
    if n <= ffk.MAX_ROW_N:
        return 1
    n1, n2 = ffk.split(n)
    return 3 + _launches_of_one_call(n1) + _launches_of_one_call(n2)


@pytest.mark.parametrize("n,max_row,long,short", [
    (16, 16384, 0, 1), (2**15, 16384, 5, 0), (256, 16, 5, 0), (1024, 16, 13, 0),
    (512, 16, 9, 0)])
def test_fft_launches_are_counted_where_they_launch(fake_c, monkeypatch, n, max_row, long,
                                                    short):
    """Every transpose and row pass of the four-step path adds one to
    ``launches_long`` as it launches, the recursion's too; a row that fits
    a block adds one to ``launches``."""
    monkeypatch.setattr(ffk, "MAX_ROW_N", max_row)
    re = torch.zeros(2, n)
    n_long, n_short = ffk.launches_long, ffk.launches
    ffk.fft(re, re)
    assert (ffk.launches_long - n_long, ffk.launches - n_short) == (long, short)
    assert long + short == _launches_of_one_call(n) == len(fake_c)
    assert {name for name, _ in fake_c} <= {"repro_fft", "repro_fft_transpose"}


@pytest.mark.parametrize("n", [2**15, 2**16, 2**20, 2**24])
def test_four_step_split_fits_the_row_kernel(n):
    n1, n2 = ffk.split(n)
    assert n1 * n2 == n and n1 <= n2 <= ffk.MAX_ROW_N and n2 <= 2 * n1


def test_long_rows_past_the_c_int_are_refused_without_allocating(no_c_calls):
    """Each four-step pass crosses the C interface with its row count as an
    int: B * N of 2^32 or more is refused from the shape alone."""
    big = torch.empty(2**3, 2**29, device="meta")
    with pytest.raises(ValueError, match="2\\^32"):
        ffk.fft(big, big)


def test_four_step_transpose_twiddles():
    """ref.fft_transpose: out[b][c][r] = in[b][r][c] * W_N^(r c)."""
    rng = np.random.default_rng(3)
    re, im = torch.from_numpy(_np(rng, 2, 4, 8)), torch.from_numpy(_np(rng, 2, 4, 8))
    orr, oi = ref.fft_transpose(re, im, 32, torch.float32)
    z = torch.complex(re, im).to(torch.complex128)
    w = torch.exp(-2j * np.pi * (torch.arange(4)[:, None] * torch.arange(8)[None, :]) / 32)
    want = (z * w).transpose(1, 2)
    assert orr.shape == (2, 8, 4)
    np.testing.assert_allclose(orr.numpy(), want.real.numpy(), atol=1e-6)
    np.testing.assert_allclose(oi.numpy(), want.imag.numpy(), atol=1e-6)


@pytest.mark.parametrize("xdt,wdt", [("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("b,h,w,c,o,kh", [(1, 3, 3, 8, 8, 1), (2, 12, 10, 8, 16, 3)])
def test_conv2d_mixed_dtypes_vs_jax(jx, xdt, wdt, b, h, w, c, o, kh):
    jnp, jref, jops = jx
    rng = np.random.default_rng(8)
    xn, wn = _np(rng, b, h, w, c), _np(rng, kh, kh, c, o)
    x = torch.from_numpy(xn).to(getattr(torch, xdt))
    wt = torch.from_numpy(wn).to(getattr(torch, wdt))
    got = ops.conv2d(x, wt)
    assert got.dtype == x.dtype and got.shape == (b, h - kh + 1, w - kh + 1, o)
    jxx, jw = jnp.asarray(xn, getattr(jnp, xdt)), jnp.asarray(wn, getattr(jnp, wdt))
    tol = 2e-2 if xdt == "bfloat16" else 2e-4
    for want in (jops.conv2d(jxx, jw, mode="interpret", block_h=1), jref.conv2d(jxx, jw)):
        assert np.asarray(want).dtype == np.dtype(jxx.dtype)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


# ------------------------------------------------------------ CUDA kernels


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(dev, seed, *shape, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


# f32: both sides f32 math in other orders; bf16: the same bf16 inputs, f32
# math, one bf16 rounding of the output
_KTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
_STORES = {"plain": None, "int8": torch.int8}


def _store(dev, seed, shape, qdtype, store):
    """K or V over a plain store of q's dtype, or (values, scales) quantized."""
    x = _randn(dev, seed, *shape)
    if _STORES[store] is None:
        return x.to(qdtype), None
    return quantize_rows(x, _STORES[store])


@pytest.mark.cuda
@pytest.mark.parametrize("d,g", NEW_PAIRS)
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("store", list(_STORES))
def test_cuda_serving_attention_over_the_domain(d, g, qdtype, store):
    dev = _cuda()
    b, kv, s_max = 3, 2, 150
    (kq, ks), (vq, vs) = (_store(dev, 1, (b, s_max, kv, d), qdtype, store),
                          _store(dev, 2, (b, s_max, kv, d), qdtype, store))
    sc = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    tol = _KTOL[qdtype]
    q = _randn(dev, 0, b, kv, g, d, dtype=qdtype)
    cl = torch.tensor([0, 77, 149], dtype=torch.int32, device=dev)
    got = dk.decode_attention(q, kq, vq, cl, **sc)
    assert (got.float() - ref.decode_attention(q, kq, vq, cl, **sc).float()).abs().max() <= tol
    slots = torch.tensor([2] * 9 + [0] * 4 + [1], dtype=torch.int32, device=dev)
    poss = torch.tensor(list(range(60, 69)) + list(range(4)) + [s_max], dtype=torch.int32,
                        device=dev)
    qt = _randn(dev, 3, slots.numel(), kv, g, d, dtype=qdtype)
    got = rk.ragged_attention(qt, kq, vq, slots, poss, window=7, **sc)
    want = ref.ragged_attention(qt, kq, vq, slots, poss, window=7, **sc)
    real = poss < s_max
    assert (got[real].float() - want[real].float()).abs().max() <= tol
    assert not got[~real].any()
    # the dense cache as a pool of 10-position blocks, its table reversed
    bs = 10
    pool_k, pool_v = (t.reshape(b * s_max // bs, bs, kv, d).flip(0).contiguous() for t in (kq, vq))
    psc = {n: s.reshape(b * s_max // bs, bs, kv).flip(0).contiguous() for n, s in sc.items()}
    nb = b * s_max // bs
    tables = (nb - 1 - torch.arange(nb, dtype=torch.int32, device=dev)).reshape(b, -1)
    got = pk.paged_attention(qt, pool_k, pool_v, slots, poss, tables, **psc)
    want = ref.paged_ragged_attention(qt, pool_k, pool_v, slots, poss, tables, **psc)
    assert (got[real].float() - want[real].float()).abs().max() <= tol
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d,g", [(48, 1), (128, 17), (64, 0)])
def test_cuda_serving_attention_refuses_outside_the_domain(d, g):
    dev = _cuda()
    q = _randn(dev, 0, 2, 1, max(g, 1), d)[:, :, :g]
    k = _randn(dev, 1, 2, 8, 1, d)
    with pytest.raises(ValueError, match="head_dim"):
        dk.decode_attention(q.contiguous(), k, k, torch.zeros(2, dtype=torch.int32, device=dev))


def _held(got, want, dtype):
    """tol * (|plain| + max|plain row|): bf16 P.V rounds p to bf16, an error
    of a bf16 step of the row's terms, which a cancelling element falls far
    below (chip_smoke.py phase 7's rule)."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    limit = _KTOL[dtype] * (want.abs() + want.abs().amax(-1, keepdim=True))
    diff = (got - want).abs()
    assert (diff <= limit).all(), f"{int((diff > limit).sum())} outside, max {diff.max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("tile", fk.TILES[torch.bfloat16])
@pytest.mark.parametrize("d", _checks.HEAD_DIMS)
@pytest.mark.parametrize("bkv,g,sq,sk,causal", [(3, 1, 200, 200, True), (2, 4, 37, 37, True),
                                                (2, 8, 64, 64, True), (2, 3, 50, 130, False),
                                                (1, 2, 130, 50, True)])
def test_cuda_flash_bf16_tiles_and_widths(tile, d, bkv, g, sq, sk, causal):
    dev = _cuda()
    q = _randn(dev, 0, bkv, g, sq, d, dtype=torch.bfloat16)
    k = _randn(dev, 1, bkv, sk, d, dtype=torch.bfloat16)
    v = _randn(dev, 2, bkv, sk, d, dtype=torch.bfloat16)
    n0 = fk.launches
    got = fk.gqa_flash_attention(q, k, v, causal=causal, block_q=tile[0], block_k=tile[1])
    assert fk.launches == n0 + 1
    _held(got, ref.gqa_flash_attention(q, k, v, causal=causal), torch.bfloat16)
    if g == 1:
        flat = fk.flash_attention(q[:, 0], k, v, causal=causal, block_q=tile[0], block_k=tile[1])
        _held(flat, ref.flash_attention(q[:, 0][None], k[None], v[None], causal=causal)[0],
              torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", fk.TILES[torch.float32])
def test_cuda_flash_f32_at_width_80(tile):
    dev = _cuda()
    q = _randn(dev, 0, 2, 3, 45, 80)
    k, v = _randn(dev, 1, 2, 45, 80), _randn(dev, 2, 2, 45, 80)
    got = fk.gqa_flash_attention(q, k, v, block_q=tile[0], block_k=tile[1])
    _held(got, ref.gqa_flash_attention(q, k, v), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,dtype", [(3, 2**15, torch.float32), (2, 2**16, torch.float32),
                                       (2, 2**20, torch.float32), (4, 2**15, torch.bfloat16),
                                       (1, 2**17, torch.bfloat16), (1, 2**29, torch.float32),
                                       (1, 2**30, torch.float32)])
def test_cuda_fft_long_rows(b, n, dtype):
    """Up to 2^30 points: from 2^29 a row pass is a four-step FFT in turn."""
    dev = _cuda()
    re, im = _randn(dev, 0, b, n, dtype=dtype), _randn(dev, 1, b, n, dtype=dtype)
    n0, n_short = ffk.launches_long, ffk.launches
    gr, gi = ffk.fft(re, im)
    assert ffk.launches_long == n0 + _launches_of_one_call(n)
    assert ffk.launches == n_short and gr.dtype == dtype
    wr, wi = ref.fft(re, im)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = max(wr.float().abs().max().item(), wi.float().abs().max().item())
    assert (gr.float() - wr.float()).abs().max().item() <= tol * scale
    assert (gi.float() - wi.float()).abs().max().item() <= tol * scale
    with pytest.raises(ValueError, match="block_rows"):
        ffk.fft(re, im, block_rows=1)


@pytest.mark.cuda
@pytest.mark.parametrize("block_h", cvk.BLOCK_H)
@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("xs,ws", [((2, 13, 9, 8), (3, 3, 8, 16)), ((1, 20, 70, 4), (1, 1, 4, 3))])
def test_cuda_conv2d_mixed_dtypes(block_h, xdt, wdt, xs, ws):
    dev = _cuda()
    torch.backends.cudnn.allow_tf32 = False
    x, w = _randn(dev, 0, *xs, dtype=xdt), _randn(dev, 1, *ws, dtype=wdt)
    n0 = cvk.launches_fma
    got = cvk.conv2d(x, w, block_h=block_h)
    assert cvk.launches_fma == n0 + 1  # mixed dtypes: the FMA tile
    want = ref.conv2d(x, w)
    torch.cuda.synchronize()
    assert got.dtype == xdt
    tol = 1e-2 if xdt == torch.bfloat16 else 1e-5
    w_ = want.float()
    assert ((got.float() - w_).abs() <= tol * (w_.abs() + w_.pow(2).mean().sqrt())).all()
