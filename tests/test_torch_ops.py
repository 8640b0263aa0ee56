"""The port's kernel API (``repro_torch.kernels.ops``: flat flash attention,
RMSNorm, row softmax and the tuned matmul) against the JAX package.

CPU: ``ops.*`` on CPU tensors (the plain versions in
``repro_torch.kernels.ref``) against ``repro.kernels.ops.*(mode="interpret")``
(the Pallas kernel bodies) and ``repro.kernels.ref`` on the same numpy
inputs, at the shapes of ``tests/test_kernels.py``. Tolerances are the JAX
tests': 2e-4 (absolute and relative) at f32 — both sides are f32 math that
differs in summation order — and 2e-2 at bf16, where both round the same
bf16 inputs but round intermediates (scores, probabilities) in different
places. The dispatch of a CUDA tensor (the tuner's plan reaching the kernel
wrapper, pinned knobs winning) is checked with the wrappers stubbed.

CUDA (``-m cuda``, skipped without a card): each new kernel against its
plain version at every configuration the tuner may pick, and the matmul at
forced K splits against its default plan.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels import axpy as axk
from repro_torch.kernels import conv2d as cvk
from repro_torch.kernels import dotp as dpk
from repro_torch.kernels import fft as ffk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import rmsnorm as rnk
from repro_torch.kernels import softmax as smk

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.ref, repro.kernels.ops)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jref, jops


def _inputs(jx, dtype, *shapes, seed=0):
    """The same standard-normal draws as torch and jax arrays of ``dtype``
    (bf16 rounds identically on both sides)."""
    jnp = jx[0]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tdt = getattr(torch, dtype)
    return ([torch.from_numpy(x).to(tdt) for x in xs],
            [jnp.asarray(x, getattr(jnp, dtype)) for x in xs])


def _close(got: torch.Tensor, *wants, dtype: str) -> None:
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


# ------------------------------------------------------------ CPU vs JAX


@pytest.mark.parametrize("s", [64, 96, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_vs_jax(jx, s, causal, dtype):
    _, jref, jops = jx
    (q, k, v), (jq, jk, jv) = _inputs(jx, dtype, *[(2, 3, s, 16)] * 3)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.shape == q.shape and got.dtype == q.dtype
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal, mode="interpret", block=32),
           jref.flash_attention(jq, jk, jv, causal=causal), dtype=dtype)


@pytest.mark.parametrize("sq,sk", [(48, 80), (80, 48)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sq_ne_sk_and_flat_form(jx, sq, sk, causal):
    """Sq != Sk (the oracle's tril over (Sq, Sk)) on the [BH, S, d] form."""
    _, jref, jops = jx
    (q, k, v), (jq, jk, jv) = _inputs(jx, "float32", (6, sq, 16), (6, sk, 16), (6, sk, 16),
                                      seed=1)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.shape == (6, sq, 16)
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal, mode="interpret", block=16),
           jref.flash_attention(jq[None], jk[None], jv[None], causal=causal)[0],
           dtype="float32")


@pytest.mark.parametrize("r,c", [(16, 64), (37, 128), (128, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_vs_jax(jx, r, c, dtype):
    _, jref, jops = jx
    (x,), (jxx,) = _inputs(jx, dtype, (r, c), seed=2)
    got = ops.softmax(x)
    assert got.dtype == x.dtype
    _close(got, jops.softmax(jxx, mode="interpret", block_rows=16), jref.softmax(jxx),
           dtype=dtype)
    np.testing.assert_allclose(got.float().sum(-1).numpy(), 1.0, rtol=TOL[dtype])
    # and each element against its own value (the CUDA tests' rule below)
    _held_softmax(got, jref.softmax(jxx).astype(np.float32), x.dtype)


@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("r,c", [(16, 64), (37, 1000), (3, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_split_vs_jax(jx, parts, r, c, dtype):
    """The cluster body's arithmetic (per-slice (max, sum) pairs merged in
    rank order), C below the number of slices included, against the Pallas
    body and the JAX oracle; a row with -inf entries (a masked half) too."""
    _, jref, jops = jx
    (x,), (jxx,) = _inputs(jx, dtype, (r, c), seed=12)
    got = ref.softmax_split(x, parts)
    assert got.dtype == x.dtype
    _close(got, jops.softmax(jxx, mode="interpret", block_rows=16), jref.softmax(jxx),
           dtype=dtype)
    _held_softmax(got, jref.softmax(jxx).astype(np.float32), x.dtype)
    x[0, : (c + 1) // 2] = -float("inf")
    masked = jx[0].asarray(x.float().numpy()).astype(jxx.dtype)
    _held_softmax(ref.softmax_split(x, parts), jref.softmax(masked).astype(np.float32), x.dtype)


@pytest.mark.parametrize("r,c,dtype,block_rows,body", [
    (64, 92416, torch.bfloat16, 0, "cluster"),  # phase 7's vocabulary logits
    (4096, 1024, torch.float32, 0, "rows"),  # phase 7's attention scores
    (37, 92416, torch.bfloat16, 0, "cluster"), (37, 1000, torch.float32, 0, "rows"),
    (1, 16384, torch.float32, 0, "rows"), (1, 16385, torch.float32, 0, "cluster"),
    (3, 131072, torch.bfloat16, 0, "cluster"), (3, 131073, torch.bfloat16, 0, "wide"),
    (2, 10**6, torch.float32, 0, "wide"),
    (64, 92416, torch.bfloat16, 1, "wide"), (64, 16384, torch.bfloat16, 1, "rows"),
    (4096, 1024, torch.float32, 8, "rows"), (4096, 2048, torch.float32, 8, "rows"),
    (4096, 2049, torch.float32, 8, "wide"), (10, 8192, torch.float32, 2, "rows"),
    (10, 8193, torch.float32, 2, "wide"), (2**28, 20000, torch.float32, 0, "wide"),
])
def test_softmax_route(r, c, dtype, block_rows, body):
    """rows while a row fits its group's registers (256 / rows threads x 64
    elements), a cluster of 8 at block_rows 0 up to 131,072 columns, the
    two-pass body past them (and where R x 8 CTAs would pass a grid)."""
    assert smk.route(r, c, dtype, block_rows) == body
    assert body in smk.ROUTES


def test_softmax_route_refuses_what_no_body_takes():
    with pytest.raises(ValueError, match="block_rows"):
        smk.route(4, 64, torch.float32, 3)
    with pytest.raises(TypeError):
        smk.route(4, 64, torch.float16, 0)


@pytest.mark.parametrize("r,c", [(16, 64), (40, 256), (37, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_vs_jax(jx, r, c, dtype):
    _, jref, jops = jx
    (x, w), (jxx, jw) = _inputs(jx, dtype, (r, c), (c,), seed=3)
    got = ops.rmsnorm(x, w)
    assert got.dtype == x.dtype
    _close(got, jops.rmsnorm(jxx, jw, mode="interpret", block_rows=8), jref.rmsnorm(jxx, jw),
           dtype=dtype)


def test_row_ops_take_any_leading_dims(jx):
    _, jref, _ = jx
    (x, w), (jxx, jw) = _inputs(jx, "float32", (3, 37, 64), (64,), seed=4)
    _close(ops.softmax(x), jref.softmax(jxx), dtype="float32")
    _close(ops.rmsnorm(x, w, eps=1e-5), jref.rmsnorm(jxx, jw, 1e-5), dtype="float32")


def test_matmul_vs_jax(jx):
    _, jref, jops = jx
    (a, b), (ja, jb) = _inputs(jx, "float32", (37, 70), (70, 130), seed=5)
    _close(ops.matmul(a, b), jops.matmul(ja, jb, mode="interpret", block=32), jref.matmul(ja, jb),
           dtype="float32")


# ------------------------------------------------------------ dispatch


class _Boom(autotune.Autotuner):
    def lookup(self, *a, **kw):
        raise AssertionError("the tuner was consulted")


def test_cpu_tensors_never_consult_the_tuner(tmp_path):
    autotune.set_tuner(_Boom(str(tmp_path / "t.json"), sweep=True))
    try:
        x = torch.randn(5, 32)
        ops.softmax(x)
        ops.rmsnorm(x, torch.randn(32))
        ops.matmul(x, torch.randn(32, 8))
        ops.flash_attention(x[None, :, :16], x[None, :, :16], x[None, :, :16])
        ops.axpy(2.0, x, x)
        ops.dotp(x, x)
        ops.fft(x, x)
        ops.conv2d(x.reshape(1, 5, 8, 4), torch.randn(3, 3, 4, 2))
    finally:
        autotune.set_tuner(None)


def _fake_cuda(monkeypatch, module, fn_name, plain):
    """Route ops' CUDA branch to a spy in place of the wrapper ``fn_name`` of
    ``module``: records the knobs it was called with, returns ``plain``."""
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        return plain(*args, **kw)

    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(module, fn_name, spy)
    return seen


@pytest.mark.parametrize("op,tuned,pinned", [
    ("softmax", {"block_rows": 4}, {"block_rows": 2}),
    ("rmsnorm", {"block_rows": 8}, {"block_rows": 1}),
    ("matmul", {"block_m": 128, "block_n": 256, "split_k": 4}, {"split_k": 0}),
    ("flash_attention", {"block_q": 64, "block_k": 64}, {"block_q": 32}),
    ("axpy", {"block": 4096}, {"block": 1024}),
    ("dotp", {"block": 16384}, {"block": 0}),
    ("fft", {"block_rows": 4}, {"block_rows": 1}),
    ("conv2d", {"block_h": 8}, {"block_h": 2}),
])
def test_cuda_dispatch_takes_the_tuners_plan_and_pins(tmp_path, monkeypatch, op, tuned, pinned):
    x = torch.randn(40, 24)
    w = torch.randn(24)
    q = torch.randn(2, 3, 48, 16)
    c_w = torch.randn(3, 3, 4, 8)
    calls = {
        "softmax": (smk, "softmax", lambda x, **kw: ref.softmax(x), lambda **kw: ops.softmax(x, **kw),
                    x.shape, ref.softmax(x)),
        "rmsnorm": (rnk, "rmsnorm", lambda x, w, eps, **kw: ref.rmsnorm(x, w, eps),
                    lambda **kw: ops.rmsnorm(x, w, **kw), x.shape, ref.rmsnorm(x, w)),
        "matmul": (mmk, "matmul", lambda a, b, **kw: ref.matmul(a, b),
                   lambda **kw: ops.matmul(x, w[:, None].repeat(1, 7), **kw), (40, 24, 7),
                   ref.matmul(x, w[:, None].repeat(1, 7))),
        "flash_attention": (
            fk, "flash_attention",
            lambda q, k, v, causal, **kw: ref.flash_attention(q[None], k[None], v[None],
                                                              causal=causal)[0],
            lambda **kw: ops.flash_attention(q, q, q, **kw), (6, 48, 16),
            ref.flash_attention(q, q, q)),
        # the JAX package's keys: a vector as [1, N], dotp flattened, conv2d on x's shape
        "axpy": (axk, "axpy", lambda a, x, y, **kw: ref.axpy(a, x, y),
                 lambda **kw: ops.axpy(2.5, w, w, **kw), (1, 24), ref.axpy(2.5, w, w)),
        "dotp": (dpk, "dotp", lambda x, y, **kw: ref.dotp(x, y), lambda **kw: ops.dotp(x, x, **kw),
                 (1, 960), ref.dotp(x, x)),
        "fft": (ffk, "fft", lambda re, im, **kw: ref.fft(re, im),
                lambda **kw: ops.fft(x[:, :16], x[:, 8:], **kw), (40, 16),
                ref.fft(x[:, :16], x[:, 8:])),
        "conv2d": (cvk, "conv2d", lambda x, w, **kw: ref.conv2d(x, w),
                   lambda **kw: ops.conv2d(x.reshape(2, 10, 12, 4), c_w, **kw), (2, 10, 12, 4),
                   ref.conv2d(x.reshape(2, 10, 12, 4), c_w)),
    }
    module, fn_name, plain, call, shape, want = calls[op]
    t = autotune.Autotuner(str(tmp_path / "t.json"), sweep=False)
    t.store(op, shape, torch.float32, "cuda", tuned)
    autotune.set_tuner(t)
    try:
        seen = _fake_cuda(monkeypatch, module, fn_name, plain)
        torch.testing.assert_close(call(), want)
        assert {k: seen[k] for k in tuned} == tuned
        seen.clear()
        call(**pinned)
        assert {k: seen[k] for k in tuned} == {**tuned, **pinned}
    finally:
        autotune.set_tuner(None)


def test_wrappers_refuse_cpu_tensors():
    """No fallback: a kernel wrapper given a CPU tensor raises, uncounted."""
    x = torch.randn(4, 16)
    before = (fk.launches_flat, rnk.launches, smk.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention(x[None], x[None], x[None])
    with pytest.raises(ValueError, match="CUDA"):
        rnk.rmsnorm(x, x[0])
    with pytest.raises(ValueError, match="CUDA"):
        smk.softmax(x)
    assert (fk.launches_flat, rnk.launches, smk.launches) == before


# ------------------------------------------------------------ CUDA kernels


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# flash attention and RMSNorm: tol 2e-4 at f32 (both sides compute in f32
# in different orders) and 2e-2 at bf16 (both compute in f32 from the same
# bf16 inputs and round the output once): a bf16 step or two of each
# element, above a floor tied to the output's own scale. RMSNorm:
# |kernel - plain| <= tol * (|plain| + rms(plain)). Flash: tol * (|plain| +
# max|plain row|), since the plain version rounds p to bf16 before P.V (as
# the JAX oracle does): a bf16 step of the row's terms p.v, which an element
# that cancels can fall far below
_KTOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# softmax: each element against its own value, |kernel - plain| <= rtol *
# |plain| + 1e-6 * max|plain row|, rtol one or two output roundings, and every
# row of the kernel's output sums to 1 within rtol. An element far below the
# row's largest (nearly all of a 92,416-wide row) is held to its own value,
# not to a floor thousands of times its size
_SOFTMAX_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _held(got, want, dtype, *, row_floor=False):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    floor = want.abs().amax(-1, keepdim=True) if row_floor else want.pow(2).mean().sqrt()
    limit = _KTOL[dtype] * (want.abs() + floor)
    diff = (got - want).abs()
    assert (diff <= limit).all(), (
        f"{int((diff > limit).sum())} elements outside tol * (|plain| + floor), "
        f"max_abs_err {diff.max().item()}")


def _held_softmax(got, want, dtype):
    if got.is_cuda:
        torch.cuda.synchronize()
    got = got.float().cpu()
    want = want.float().cpu() if isinstance(want, torch.Tensor) else torch.from_numpy(
        np.asarray(want, np.float32))
    rtol = _SOFTMAX_RTOL[dtype]
    limit = rtol * want.abs() + 1e-6 * want.abs().amax(-1, keepdim=True)
    diff = (got - want).abs()
    assert (diff <= limit).all(), (
        f"{int((diff > limit).sum())} elements outside rtol * |plain| + 1e-6 * max|row|, "
        f"max_rel_err {(diff / want.abs().clamp_min(1e-30)).max().item()}")
    sums = got.double().sum(-1)
    assert ((sums - 1).abs() <= rtol).all(), f"row sums {sums.min().item()}..{sums.max().item()}"


def _randn(dev, seed, *shape, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def _err(got, want):
    torch.cuda.synchronize()
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tile", [(dt, t) for dt, tiles in fk.TILES.items() for t in tiles])
@pytest.mark.parametrize("sq,sk,d,causal", [(96, 96, 16, True), (37, 37, 128, True),
                                            (50, 130, 64, False), (130, 50, 32, True),
                                            (64, 64, 128, False)])
def test_cuda_flash_tiles_vs_plain(dtype, tile, sq, sk, d, causal):
    dev = _cuda()
    q = _randn(dev, 0, 6, sq, d, dtype=dtype)
    k, v = _randn(dev, 1, 6, sk, d, dtype=dtype), _randn(dev, 2, 6, sk, d, dtype=dtype)
    n0 = fk.launches_flat
    got = fk.flash_attention(q, k, v, causal=causal, block_q=tile[0], block_k=tile[1])
    _held(got, ref.flash_attention(q[None], k[None], v[None], causal=causal)[0], dtype,
          row_floor=True)
    assert fk.launches_flat == n0 + 1


@pytest.mark.cuda
def test_cuda_flash_refuses_what_is_not_instantiated():
    dev = _cuda()
    q = _randn(dev, 0, 2, 16, 48)
    with pytest.raises(ValueError, match="instantiated"):
        fk.flash_attention(q, q, q)
    q = _randn(dev, 0, 2, 16, 64)
    with pytest.raises(ValueError, match="instantiated"):
        fk.flash_attention(q, q, q, block_q=48, block_k=32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", rnk.BLOCK_ROWS)
@pytest.mark.parametrize("dtype,wdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("r,c", [(37, 4096), (64, 1000), (5, 333)])
def test_cuda_rmsnorm_vs_plain(rows, dtype, wdtype, r, c):
    dev = _cuda()
    x, w = _randn(dev, 3, r, c, dtype=dtype), _randn(dev, 4, c, dtype=wdtype)
    _held(rnk.rmsnorm(x, w, eps=1e-5, block_rows=rows), ref.rmsnorm(x, w, 1e-5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", smk.BLOCK_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", [(37, 1024), (3, 92416), (10, 333)])
def test_cuda_softmax_vs_plain(rows, dtype, r, c):
    dev = _cuda()
    x = _randn(dev, 5, r, c, dtype=dtype) * 4
    _held_softmax(smk.softmax(x, block_rows=rows), ref.softmax(x), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", [(1, 5), (3, 1000), (2, 16384 // 8), (2, 16384), (5, 16385),
                                 (1, 50001), (64, 92416), (3, 131072), (2, 99999)])
def test_cuda_softmax_cluster_body(dtype, r, c):
    """The cluster body, forced where the route would not take it too: C
    below the cluster's 8 slices, at and around one slice, up to a whole
    cluster's registers, C % 8 != 0, R = 1, a row with -inf entries (a
    masked first half: whole slices of -inf), and an offset view (element
    loads); each launch counted on ``launches_cluster``."""
    dev = _cuda()
    base = _randn(dev, 13, r * c + 1, dtype=dtype) * 4
    for x in (base[: r * c].view(r, c).clone(), base[1:].view(r, c)):
        if r > 1:
            x[1, : c // 2] = -float("inf")
        n0, n_c = smk.launches, smk.launches_cluster
        got = smk.softmax(x, body="cluster")
        assert (smk.launches, smk.launches_cluster) == (n0 + 1, n_c + 1)
        _held_softmax(got, ref.softmax(x), dtype)
        _held_softmax(got, ref.softmax_split(x, smk.CLUSTER), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c,block_rows", [
    (64, 92416, 0), (4096, 1024, 0), (37, 1000, 0), (37, 1000, 8), (10, 333, 4), (1, 16384, 0),
    (64, 92416, 1), (3, 200003, 0), (5, 16385, 0), (9, 2048, 8), (9, 2049, 8)])
def test_cuda_softmax_routes_are_counted_on_their_body(dtype, r, c, block_rows):
    """Each shape runs the body route() names and adds one to that body's
    count and to ``launches``, no other; the result held against plain."""
    dev = _cuda()
    x = _randn(dev, 14, r, c, dtype=dtype) * 4
    body = smk.route(r, c, dtype, block_rows)
    counts = {b: getattr(smk, f"launches_{b}") for b in smk.ROUTES}
    n0 = smk.launches
    got = smk.softmax(x, block_rows=block_rows)
    assert smk.launches == n0 + 1
    assert {b: getattr(smk, f"launches_{b}") - counts[b] for b in smk.ROUTES} == {
        b: int(b == body) for b in smk.ROUTES}
    _held_softmax(got, ref.softmax(x), dtype)


@pytest.mark.cuda
def test_cuda_softmax_bodies_refuse_rows_past_their_registers():
    dev = _cuda()
    with pytest.raises(ValueError, match="instantiated"):
        smk.softmax(_randn(dev, 15, 2, 131073), body="cluster")
    with pytest.raises(ValueError, match="instantiated"):
        smk.softmax(_randn(dev, 15, 2, 2049), block_rows=8, body="rows")
    with pytest.raises(ValueError, match="instantiated"):
        smk.softmax(_randn(dev, 15, 2, 2048), block_rows=2, body="cluster")


@pytest.mark.cuda
@pytest.mark.parametrize("split_k", mmk.SPLIT_K[1:])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4, 4096, 1000), (256, 4096, 512), (37, 1000, 136)])
def test_cuda_matmul_forced_split_vs_default(split_k, dtype, m, k, n):
    """Forced K splits, at every wgmma tile, against the default plan: the
    same product within the matmul tolerance of phase 2 (the split changes
    the summation order). The tile reaches only the bf16 wgmma body (M 256
    and 37 here); the GEMV and the FMA tile ignore it."""
    dev = _cuda()
    a, b = _randn(dev, 6, m, k, dtype=dtype), _randn(dev, 7, k, n, dtype=dtype)
    want = mmk.matmul(a, b)
    for bm, bn in ((0, 0),) + mmk.TILES:
        got = mmk.matmul(a, b, split_k=split_k, block_m=bm, block_n=bn)
        scale = ref.matmul(a, b).float().abs().max().item()
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        assert _err(got, want) <= rel * scale
        assert _err(got, ref.matmul(a, b)) <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("op,shape", [("matmul", (4, 1000, 136)), ("flash_attention", (6, 96, 16)),
                                      ("rmsnorm", (37, 1000)), ("softmax", (37, 1000))])
def test_cuda_measure_times_every_candidate(op, shape):
    """Each op's measure function times every candidate on the card."""
    _cuda()
    measure = autotune.measure_for(op, shape, torch.float32, "cuda")
    for cfg in autotune.candidates(op, torch.float32):
        t = measure(cfg)
        assert 0 < t < 1, (cfg, t)
