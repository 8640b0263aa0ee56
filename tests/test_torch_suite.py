"""The paper's kernel suite in the port (``repro_torch.kernels.ops``:
``axpy``, ``dotp``, ``fft``, ``conv2d``) against the JAX package.

CPU: ``ops.*`` on CPU tensors (the plain versions in
``repro_torch.kernels.ref``) against ``repro.kernels.ops.*(mode="interpret")``
(the Pallas kernel bodies) and ``repro.kernels.ref`` on the same numpy
inputs, at the shapes of ``tests/test_kernels.py`` and
``tests/test_hot_path.py``. Tolerances:

- axpy: against the Pallas body, exact at f32 — XLA contracts its
  ``a * x + y`` into one fused multiply-add, rounded once, which the port's
  kernel (``fmaf``) and plain version (float64) compute too — and within one
  bf16 step of each output at bf16 (both round the same f32 value once).
  Against ``repro.kernels.ref.axpy``, which rounds the product and the sum
  separately, within an f32 ulp of the product plus one of the result (the
  product's rounding the fma skips, and the result's). The port rounds alpha to x's dtype first,
  as the Pallas kernel does; ``repro.kernels.ref.axpy`` keeps it in f32, and
  at bf16 with alpha = 1/3 the two differ by one bf16 step
  (test_axpy_alpha_is_rounded_to_x_dtype).
- dotp: ``1e-5 * sum |x_i y_i|``, not relative to the result, which cancels:
  f32 sums in different orders differ by a few roundings of the terms'
  magnitudes.
- fft: ``max |got - want| / max |want|`` below 1e-5 at f32 (the JAX test's
  bound) and 1e-2 at bf16 (an output rounding of ~2^-8 of the largest
  element, and inputs rounded to bf16 on both sides alike).
- conv2d: 2e-4 absolute and relative at f32 (the JAX test's), 2e-2 at bf16.

CUDA (``-m cuda``, skipped without a card): each kernel against its plain
version at every configuration the tuner may pick, at small shapes and
tails, and the refusals.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _checks, autotune, ops, ref
from repro_torch.kernels import axpy as axk
from repro_torch.kernels import conv2d as cvk
from repro_torch.kernels import dotp as dpk
from repro_torch.kernels import fft as ffk


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.ref, repro.kernels.ops, the Pallas dotp)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import dotp as jdotp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jref, jops, jdotp


def _inputs(jx, dtype, *shapes, seed=0):
    """The same standard-normal draws as torch and jax arrays of ``dtype``."""
    jnp = jx[0]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs],
            [jnp.asarray(x, getattr(jnp, dtype)) for x in xs])


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _bf16_step(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _axpy_held(got, want, dtype, product=None):
    """At f32 equal, or given ``product`` (alpha * x) within an ulp of it
    plus an ulp of the result; at bf16 within one bf16 step."""
    got, want = _f32(got), _f32(want)
    if dtype == "float32" and product is None:
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        limit = np.spacing(np.abs(_f32(product))) + np.spacing(np.abs(want))
        assert (np.abs(got - want) <= limit).all()
    else:
        assert (np.abs(got - want) <= _bf16_step(want)).all()


# ------------------------------------------------------------ CPU vs JAX


@pytest.mark.parametrize("shape", [(3, 500), (1, 64), (8, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [2.5, 1 / 3])
def test_axpy_vs_jax_interpret(jx, shape, dtype, alpha):
    _, jref, jops, _ = jx
    (x, y), (jxx, jy) = _inputs(jx, dtype, shape, shape)
    got = ops.axpy(alpha, x, y)
    assert got.shape == x.shape and got.dtype == x.dtype
    _axpy_held(got, jops.axpy(alpha, jxx, jy, mode="interpret", block=128), dtype)
    if dtype == "float32" or alpha == 2.5:  # an alpha that bf16 represents
        _axpy_held(got, jref.axpy(alpha, jxx, jy), dtype, product=alpha * x.float())


def test_axpy_takes_vectors(jx):
    _, jref, jops, _ = jx
    (x, y), (jxx, jy) = _inputs(jx, "float32", (1000,), (1000,), seed=1)
    got = ops.axpy(-0.75, x, y)
    assert got.shape == (1000,)
    _axpy_held(got, jops.axpy(-0.75, jxx, jy, mode="interpret", block=256), "float32")
    _axpy_held(got, jref.axpy(-0.75, jxx, jy), "float32", product=-0.75 * x)


def test_axpy_alpha_is_rounded_to_x_dtype(jx):
    """The one intended difference from the JAX package's CPU path (``ref``):
    at bf16 the port, like the Pallas kernel, scales by bf16(1/3) =
    0.333984375; ``repro.kernels.ref.axpy`` scales by the f32 1/3. Outputs
    then differ by that error of alpha times x, plus an output rounding."""
    _, jref, jops, _ = jx
    (x, y), (jxx, jy) = _inputs(jx, "bfloat16", (8, 500), (8, 500), seed=2)
    got = _f32(ops.axpy(1 / 3, x, y))
    np.testing.assert_array_equal(got, _f32(jops.axpy(1 / 3, jxx, jy, mode="interpret")))
    np.testing.assert_array_equal(got, _f32(ref.axpy(0.333984375, x, y)))
    assert float(torch.tensor(1 / 3, dtype=torch.bfloat16)) == 0.333984375
    want = _f32(jref.axpy(1 / 3, jxx, jy))
    diff = np.abs(got - want)
    assert (diff > 0).sum() > 400  # the difference exists (about a fifth of the outputs)...
    alpha_err = np.abs((0.333984375 - 1 / 3) * _f32(x))
    assert (diff <= alpha_err + np.maximum(_bf16_step(got), _bf16_step(want))).all()  # ...and is alpha's


def _dotp_scale(x, y) -> float:
    return float((x.double() * y.double()).abs().sum())


@pytest.mark.parametrize("n", [64, 1000, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dotp_vs_jax(jx, n, dtype):
    _, jref, jops, _ = jx
    (x, y), (jxx, jy) = _inputs(jx, dtype, (n,), (n,), seed=3)
    got = ops.dotp(x, y)
    assert got.shape == () and got.dtype == torch.float32
    tol = 1e-5 * _dotp_scale(x, y)
    for want in (jops.dotp(jxx, jy, mode="interpret", block=256), jref.dotp(jxx, jy)):
        assert abs(float(got) - float(want)) <= tol


def test_dotp_flattens_any_shape(jx):
    _, jref, _, _ = jx
    (x, y), (jxx, jy) = _inputs(jx, "float32", (3, 7, 11), (3, 7, 11), seed=4)
    assert abs(float(ops.dotp(x, y)) - float(jref.dotp(jxx, jy))) <= 1e-5 * _dotp_scale(x, y)


@pytest.mark.parametrize("block", [256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dotp_partials_layout_vs_jax(jx, block, dtype):
    """[R, cdiv(C, block)], partial j over columns [j * block, (j + 1) * block)."""
    _, _, _, jdotp = jx
    (x, y), (jxx, jy) = _inputs(jx, dtype, (3, 1000), (3, 1000), seed=5)
    got = ref.dotp_partials(x, y, block)
    want = np.asarray(jdotp.dotp_partials(jxx, jy, block=block, interpret=True))
    assert got.shape == want.shape == (3, -(-1000 // block))
    assert got.dtype == torch.float32
    prod = (x.double() * y.double()).abs()
    for j in range(got.shape[1]):
        scale = prod[:, j * block:(j + 1) * block].sum(-1).numpy()
        assert (np.abs(got[:, j].numpy() - want[:, j]) <= 1e-5 * scale).all()


def _fft_err(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,n", [(4, 64), (2, 256), (6, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fft_vs_jax(jx, b, n, dtype):
    _, jref, jops, _ = jx
    (re, im), (jre, jim) = _inputs(jx, dtype, (b, n), (b, n), seed=6)
    gr, gi = ops.fft(re, im)
    assert gr.shape == (b, n) and gr.dtype == re.dtype and gi.dtype == im.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    for wr, wi in (jops.fft(jre, jim, mode="interpret", block_rows=2), jref.fft(jre, jim)):
        assert _fft_err(gr, wr) < tol and _fft_err(gi, wi) < tol


@pytest.mark.parametrize("log2n", range(1, 15))
def test_fft_twiddles_bitwise_equal_to_jax(jx, log2n):
    _, jref, _, _ = jx
    for got, want in zip(ref.fft_twiddles(2**log2n), jref.fft_twiddles(2**log2n)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fft_stockham_vs_jax(jx):
    """The step-by-step algorithm of the kernels, against the JAX package's
    copy and against the oracle FFT."""
    _, jref, _, _ = jx
    (re, im), (jre, jim) = _inputs(jx, "float32", (3, 128), (3, 128), seed=7)
    sr, si = ref.fft_stockham(re, im)
    jr, ji = jref.fft_stockham(jre, jim)
    assert _fft_err(sr, jr) < 1e-6 and _fft_err(si, ji) < 1e-6
    fr, fi = ref.fft(re, im)
    assert _fft_err(sr, fr) < 1e-5 and _fft_err(si, fi) < 1e-5


@pytest.mark.parametrize("log2n", range(1, 15))
def test_fft_stage_rows_are_the_last_row_strided(log2n):
    """The last twiddle row holds every stage's table: stage s's entry p is
    entry (p mod L) * N / 2L of the last row, bit for bit (the float64
    angles differ by a power of two); so the packed stage table the CUDA
    kernel reads (stage s's L distinct entries at offset L - 1) is the TPU
    kernel's, bit for bit."""
    n = 2**log2n
    tab_re, tab_im = ref.fft_twiddles(n)
    row_re, row_im = ref.fft_twiddle_row(n)
    np.testing.assert_array_equal(row_re.view(np.uint32), tab_re[-1].view(np.uint32))
    np.testing.assert_array_equal(row_im.view(np.uint32), tab_im[-1].view(np.uint32))
    p = np.arange(n // 2)
    for s in range(log2n):
        idx = (p % 2**s) * (n // 2 ** (s + 1))
        np.testing.assert_array_equal(row_re[idx].view(np.uint32), tab_re[s].view(np.uint32))
        np.testing.assert_array_equal(row_im[idx].view(np.uint32), tab_im[s].view(np.uint32))
    st_re, st_im = ref.fft_twiddle_stages(n)
    assert st_re.shape == st_im.shape == (n - 1,)
    for s in range(log2n):
        seg = slice(2**s - 1, 2 ** (s + 1) - 1)
        np.testing.assert_array_equal(st_re[seg].view(np.uint32), tab_re[s][: 2**s].view(np.uint32))
        np.testing.assert_array_equal(st_im[seg].view(np.uint32), tab_im[s][: 2**s].view(np.uint32))


@pytest.mark.parametrize("log2n", range(1, 15))
def test_fft_stockham_passes_bitwise_equal_to_stages(log2n):
    """The kernel's data movement (radix-16 passes, one twiddle row) leaves
    every butterfly as the stage-by-stage version computes it."""
    n = 2**log2n
    rng = np.random.default_rng(log2n)
    b = max(1, 4096 // n)
    re, im = (torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)) for _ in range(2))
    sr, si = ref.fft_stockham(re, im)
    pr, pi = ref.fft_stockham_passes(re, im)
    assert torch.equal(pr, sr) and torch.equal(pi, si)


@pytest.mark.parametrize("b,n", [(4, 64), (2, 256), (6, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fft_stockham_passes_vs_jax(jx, b, n, dtype):
    """On test_fft_vs_jax's inputs: within 1e-5 of the Pallas body (the
    same algorithm in f32) at either dtype, the inputs rounded alike."""
    _, jref, jops, _ = jx
    (re, im), (jre, jim) = _inputs(jx, dtype, (b, n), (b, n), seed=6)
    pr, pi = ref.fft_stockham_passes(re.float(), im.float())
    wr, wi = jops.fft(jre.astype(jx[0].float32), jim.astype(jx[0].float32), mode="interpret",
                      block_rows=2)
    assert _fft_err(pr, wr) < 1e-5 and _fft_err(pi, wi) < 1e-5
    gr, gi = ref.fft_stockham_passes(re, im)
    assert gr.dtype == re.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    for wr, wi in (jops.fft(jre, jim, mode="interpret", block_rows=2), jref.fft(jre, jim)):
        assert _fft_err(gr, wr) < tol and _fft_err(gi, wi) < tol


@pytest.mark.parametrize("b,h,w,c,o,kh", [
    (2, 12, 10, 8, 16, 3), (1, 8, 8, 4, 4, 1), (2, 10, 9, 4, 8, 3), (2, 13, 9, 4, 8, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv2d_vs_jax(jx, b, h, w, c, o, kh, dtype):
    _, jref, jops, _ = jx
    (x, wt), (jxx, jw) = _inputs(jx, dtype, (b, h, w, c), (kh, kh, c, o), seed=8)
    got = ops.conv2d(x, wt)
    assert got.shape == (b, h - kh + 1, w - kh + 1, o) and got.dtype == x.dtype
    tol = 2e-4 if dtype == "float32" else 2e-2
    for want in (jops.conv2d(jxx, jw, mode="interpret", block_h=4), jref.conv2d(jxx, jw)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# ------------------------------------------------------------ refusals off the card


def test_wrappers_refuse_cpu_tensors():
    """No fallback: a kernel wrapper given a CPU tensor raises, uncounted."""
    x = torch.randn(4, 16)
    before = (axk.launches, dpk.launches, ffk.launches, cvk.launches)
    for call in (lambda: axk.axpy(2.0, x, x), lambda: dpk.dotp_partials(x, x),
                 lambda: ffk.fft(x, x), lambda: cvk.conv2d(x[None, :, :, None], x[:1, :1, None, None])):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert (axk.launches, dpk.launches, ffk.launches, cvk.launches) == before


def test_dimensions_past_the_c_int_are_refused_without_allocating():
    """The sizes cross the C interface as 32-bit ints: a dimension of 2^31 is
    refused from its shape alone (a meta tensor holds no memory)."""
    big = torch.empty(1, 2**31, device="meta")
    for call in (lambda: axk.axpy(1.0, big, big), lambda: dpk.dotp_partials(big, big),
                 lambda: ffk.fft(big, big),
                 lambda: cvk.conv2d(big[None, :, :, None], torch.empty(1, 1, 1, 1, device="meta"))):
        with pytest.raises(ValueError, match="2\\^31"):
            call()
    _checks.c_int_dims("ok", torch.empty(2**16, 2**16, device="meta"))  # 2^32 elements is fine


def test_dotp_auto_block():
    """block 0: powers of two from 2,048 up, at most 32 partials per SM."""
    assert dpk.auto_block(1, 1000, 132) == 2048
    assert dpk.auto_block(1, 2**28, 132) == 65536
    assert dpk.auto_block(1, 2**22, 132) == 2048
    assert dpk.auto_block(8, 2**22, 132) == 8192
    assert dpk.auto_block(2**16, 64, 132) == 65536  # many short rows: one partial each


def test_fft_fits():
    assert ffk.fits(16384, 1) and not ffk.fits(16384, 2) and ffk.fits(16384, 0)
    assert ffk.fits(2048, 8) and not ffk.fits(4096, 8)


# ------------------------------------------------------------ CUDA kernels


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(dev, seed, *shape, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("block", axk.BLOCK)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((3, 10003), 0), ((1, 4096), 0), ((5, 333), 1),
                                          ((2, 7), 0)])
def test_cuda_axpy_vs_plain(block, dtype, shape, offset):
    """Every block; an offset of one element takes the scalar loads."""
    dev = _cuda()
    n = shape[0] * shape[1]
    x = _randn(dev, 0, n + offset, dtype=dtype)[offset:].view(shape)
    y = _randn(dev, 1, n + offset, dtype=dtype)[offset:].view(shape)
    n0 = axk.launches
    got = axk.axpy(1 / 3, x, y, block=block)
    torch.cuda.synchronize()
    assert axk.launches == n0 + 1
    # both round alpha to x's dtype and alpha * x + y once to f32 (an fma):
    # equal but at a double-rounding tie of the plain version's f64 sum
    want = ref.axpy(1 / 3, x, y).float()
    step = torch.where(want == 0, 2.0**-126, want.abs())
    step = 2.0 ** (torch.floor(torch.log2(step)) - (23 if dtype == torch.float32 else 7))
    assert ((got.float() - want).abs() <= step).all()


@pytest.mark.cuda
@pytest.mark.parametrize("block", dpk.BLOCK)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((8, 100003), 0), ((3, 1000), 0), ((2, 4096), 1)])
def test_cuda_dotp_partials_vs_plain(block, dtype, shape, offset):
    dev = _cuda()
    n = shape[0] * shape[1]
    x = _randn(dev, 2, n + offset, dtype=dtype)[offset:].view(shape)
    y = _randn(dev, 3, n + offset, dtype=dtype)[offset:].view(shape)
    got = dpk.dotp_partials(x, y, block=block)
    eff = block or dpk.auto_block(*shape, dpk._sms(dev.index or 0))
    want = ref.dotp_partials(x, y, eff)
    assert got.shape == want.shape == (shape[0], -(-shape[1] // eff))
    scale = ref.dotp_partials(x.abs(), y.abs(), eff)
    assert ((got - want).abs() <= 1e-5 * scale + 1e-30).all()
    total = dpk.dotp(x, y, block=block)
    assert total.shape == () and total.device.type == "cuda"
    assert abs(total.item() - ref.dotp(x, y).item()) <= 1e-5 * scale.sum().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,rows", [  # every block_rows whose rows fit (the rest: refused)
    (b, n, rows) for b, n in [(37, 64), (3, 2), (5, 1024), (3, 16384), (9, 4)]
    for rows in ffk.BLOCK_ROWS if ffk.fits(n, rows)])
def test_cuda_fft_vs_plain(dtype, b, n, rows):
    dev = _cuda()
    re, im = _randn(dev, 4, b, n, dtype=dtype), _randn(dev, 5, b, n, dtype=dtype)
    gr, gi = ffk.fft(re, im, block_rows=rows)
    wr, wi = ref.fft(re, im)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = torch.maximum(wr.float().abs().max(), wi.float().abs().max())
    assert ((gr.float() - wr.float()).abs().max() / scale).item() < tol
    assert ((gi.float() - wi.float()).abs().max() / scale).item() < tol
    if dtype == torch.float32:  # the same algorithm and table, the same roundings
        sr, si = ref.fft_stockham(re, im)
        assert ((gr - sr).abs().max() / scale).item() < 1e-6
        assert ((gi - si).abs().max() / scale).item() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("log2n", range(1, 15))
def test_cuda_fft_passes_every_n(dtype, log2n):
    """The radix-16 pass body at every N from 2 to 16,384 and every
    block_rows that fits: a batch that leaves the persistent loop a tail
    (more tiles than the grid's blocks, the last tile short), and an offset
    view (the threads' copy-in instead of the bulk copies), each counted on
    ``launches``; at f32 within 1e-6 of ref.fft_stockham."""
    dev = _cuda()
    n = 2**log2n
    b = 3 * 132 * max(1, 4096 // n) + 3  # > one wave of blocks, not a multiple of 8 rows
    for offset in (0, 1):
        base_re = _randn(dev, 20 + log2n, b * n + offset, dtype=dtype)
        base_im = _randn(dev, 40 + log2n, b * n + offset, dtype=dtype)
        re, im = base_re[offset:].view(b, n), base_im[offset:].view(b, n)
        wr, wi = ref.fft(re, im)
        scale = torch.maximum(wr.float().abs().max(), wi.float().abs().max())
        sr, si = ref.fft_stockham(re, im)
        for rows in ffk.BLOCK_ROWS:
            if not ffk.fits(n, rows):
                continue
            n0 = ffk.launches
            gr, gi = ffk.fft(re, im, block_rows=rows)
            assert ffk.launches == n0 + 1
            tol = 1e-5 if dtype == torch.float32 else 1e-2
            assert ((gr.float() - wr.float()).abs().max() / scale).item() < tol, (rows, offset)
            assert ((gi.float() - wi.float()).abs().max() / scale).item() < tol, (rows, offset)
            if dtype == torch.float32:
                assert ((gr - sr).abs().max() / scale).item() < 1e-6, (rows, offset)
                assert ((gi - si).abs().max() / scale).item() < 1e-6, (rows, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("block_h", cvk.BLOCK_H)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,o,kh,kw", [
    (2, 20, 19, 32, 24, 3, 3), (2, 13, 9, 4, 8, 3, 3), (1, 8, 8, 4, 4, 1, 1),
    (1, 70, 9, 16, 72, 3, 2), (2, 11, 12, 24, 40, 3, 3)])
def test_cuda_conv2d_vs_plain(block_h, dtype, b, h, w, c, o, kh, kw):
    """bf16 with C and O multiples of 8 takes the wgmma body, the rest the
    FMA tile; tails in H, W and O."""
    dev = _cuda()
    x = _randn(dev, 6, b, h, w, c, dtype=dtype)
    wt = _randn(dev, 7, kh, kw, c, o, dtype=dtype)
    body = cvk.route(dtype, dtype, c, o)
    assert body == ("wgmma" if dtype == torch.bfloat16 and c % 8 == 0 and o % 8 == 0 else "fma")
    n0 = getattr(cvk, f"launches_{body}")
    got = cvk.conv2d(x, wt, block_h=block_h)
    assert getattr(cvk, f"launches_{body}") == n0 + 1
    torch.backends.cudnn.allow_tf32 = False
    want = ref.conv2d(x, wt).float()
    assert got.shape == want.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    limit = tol * (want.abs() + want.pow(2).mean().sqrt())
    assert ((got.float() - want).abs() <= limit).all()


@pytest.mark.cuda
def test_cuda_refusals():
    dev = _cuda()
    x = _randn(dev, 8, 2, 32768)
    with pytest.raises(ValueError, match="16384"):  # a 32,768-point row fits no block
        ffk.fft(x, x, block_rows=1)
    with pytest.raises(ValueError, match="power of two"):
        ffk.fft(x[:, :48].contiguous(), x[:, :48].contiguous())
    with pytest.raises(ValueError, match="block_rows"):
        ffk.fft(x[:, :4096].contiguous(), x[:, :4096].contiguous(), block_rows=8)
    with pytest.raises(TypeError):  # x and w may differ among f32 and bf16, not int8
        cvk.conv2d(_randn(dev, 9, 1, 8, 8, 4), _randn(dev, 9, 3, 3, 4, 4).to(torch.int8))
    with pytest.raises(TypeError):
        axk.axpy(1.0, x, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="block_h"):
        cvk.conv2d(_randn(dev, 9, 1, 8, 8, 4), _randn(dev, 9, 3, 3, 4, 4), block_h=3)


@pytest.mark.cuda
@pytest.mark.parametrize("op,shape,extra", [
    ("axpy", (3, 10003), ()), ("dotp", (1, 100003), ()), ("fft", (37, 1024), ()),
    ("conv2d", (2, 20, 19, 32), ((3, 3, 32, 24),))])
def test_cuda_measure_times_every_candidate(op, shape, extra):
    _cuda()
    measure = autotune.measure_for(op, shape, torch.bfloat16, "cuda", *extra)
    for cfg in autotune.CANDIDATES[op]:
        t = measure(cfg)
        assert 0 < t < 1, (cfg, t)


@pytest.mark.cuda
def test_cuda_ops_plan_reaches_the_kernels(tmp_path):
    """ops.* on CUDA tensors take the tuner's plan and launch each kernel."""
    dev = _cuda()
    autotune.set_tuner(autotune.Autotuner(str(tmp_path / "t.json"), sweep=False))
    try:
        before = (axk.launches, dpk.launches, ffk.launches, cvk.launches)
        v = _randn(dev, 10, 5000)
        x, wt = _randn(dev, 11, 1, 10, 9, 4), _randn(dev, 12, 3, 3, 4, 8)
        assert torch.equal(ops.axpy(2.5, v, v), ref.axpy(2.5, v, v))
        assert abs(ops.dotp(v, v).item() - ref.dotp(v, v).item()) <= 1e-5 * ref.dotp(v, v).item()
        gr, _ = ops.fft(v[:4096].reshape(2, 2, 1024), v[:4096].reshape(2, 2, 1024))
        assert gr.shape == (2, 2, 1024)
        assert ops.conv2d(x, wt).shape == (1, 8, 7, 8)
        torch.cuda.synchronize()
        after = (axk.launches, dpk.launches, ffk.launches, cvk.launches)
        assert all(a == b + 1 for a, b in zip(after, before))
    finally:
        autotune.set_tuner(None)
