"""The port's Hopper GEMM bodies (``kernels/csrc/gemm_wgmma.cuh``): the bf16
matmul tile and the implicit-GEMM conv2d on wgmma and TMA, their routes and
tuner knobs, and the matmul's split-K scratch with one owner per stream.

CPU (runs anywhere): each body's route from shape and dtype alone, the
matmul's new knobs (``block_m``, ``block_n`` beside ``split_k``, the JAX
tuner's names) in the tuner's defaults, candidates and cache, read back by
the JAX package's tuner, and ``ops.matmul`` / ``ops.conv2d`` on CPU tensors
against the JAX package (``repro.kernels.ops`` in interpret mode and
``repro.kernels.ref``) at the tail shapes the CUDA tests take.

CUDA (``-m cuda``, skipped without a card; ``python3 chip_smoke.py`` runs
the main shapes): the wgmma matmul at every M of ``chip_smoke.MATMUL_M``
above 8 and M 129 and 300, over ``MATMUL_KN`` with its tails, at every
tile and K split; conv2d at C in {8, 72, 256}, O in {8, 136, 256}, 1 x 1
and 3 x 3 taps over a ragged image, at every block_h; and split-K matmul,
both split GEMVs and split decode attention on two streams at once,
bitwise equal to serial runs.

Tolerances are ``chip_smoke.py``'s: the matmul within MATMUL_REL_TOL (1e-2
at bf16: both sides sum exact products in f32 and round once) of max
|plain|; conv2d within SUITE_TOL["conv2d"] * (|plain| + rms(plain)) (1e-2
at bf16). CPU against JAX: 2e-4 at f32 and 2e-2 at bf16, as
tests/test_torch_ops.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels import conv2d as cvk
from repro_torch.kernels import matmul as mmk

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
MATMUL_M = (16, 37, 64, 256, 129, 300)  # chip_smoke.MATMUL_M above 8, and two odd tiles
MATMUL_KN = ((4096, 4096), (4096, 13440), (13440, 4096), (4100, 4104))  # chip_smoke's
MATMUL_REL_TOL = 1e-2  # chip_smoke.MATMUL_REL_TOL["bfloat16"]
CONV_TOL = 1e-2  # chip_smoke.SUITE_TOL["conv2d"]["bfloat16"]


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.ref, repro.kernels.ops)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jref, jops


def _inputs(jx, dtype, *shapes, seed=0):
    """The same standard-normal draws as torch and jax arrays of ``dtype``."""
    jnp = jx[0]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs],
            [jnp.asarray(x, getattr(jnp, dtype)) for x in xs])


def _close(got, *wants, dtype):
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


# ------------------------------------------------------------------ routes


@pytest.mark.parametrize("m,k,n,a_dt,b_dt,body", [
    (4, 4096, 13440, torch.bfloat16, torch.bfloat16, "gemv_tc"),
    (8, 4100, 4104, torch.float32, torch.float32, "gemv"),
    (4, 4096, 13440, torch.bfloat16, torch.int8, "gemv_tc"),
    (1, 13440, 4096, torch.bfloat16, torch.int8, "gemv_tc"),  # the down projection
    (8, 4096, 4096, torch.bfloat16, torch.bfloat16, "gemv_tc"),
    (4, 4096, 13440, torch.float32, torch.int8, "gemv"),  # f32 stays off the tensor cores
    (4, 4100, 4096, torch.bfloat16, torch.int8, "gemv"),  # K % 16 != 0
    (4, 4096, 4104, torch.bfloat16, torch.int8, "gemv"),  # N % 16 != 0
    (4, 4104, 4096, torch.bfloat16, torch.bfloat16, "gemv"),  # K % 16 == 8
    (9, 4096, 13440, torch.bfloat16, torch.bfloat16, "wgmma"),
    (256, 4096, 13440, torch.bfloat16, torch.bfloat16, "wgmma"),
    (300, 4104, 4104, torch.bfloat16, torch.bfloat16, "wgmma"),
    (129, 4100, 4104, torch.bfloat16, torch.bfloat16, "mma_tile"),  # K % 8 != 0
    (37, 4096, 4100, torch.bfloat16, torch.bfloat16, "mma_tile"),  # N % 8 != 0
    (16, 4096, 13440, torch.bfloat16, torch.int8, "gemv_tc_rows"),  # the multi-row GEMV
    (64, 13440, 4096, torch.bfloat16, torch.int8, "gemv_tc_rows"),  # its widest
    (65, 4096, 13440, torch.bfloat16, torch.int8, "mma_pipe"),  # past it: the tile
    (37, 4104, 4096, torch.bfloat16, torch.int8, "mma_pipe"),  # K % 16 == 8
    (16, 4096, 4104, torch.bfloat16, torch.int8, "mma_tile"),  # N % 16 != 0
    (256, 4096, 13440, torch.float32, torch.float32, "fma"),
    (16, 4096, 13440, torch.float32, torch.int8, "fma"),
])
def test_matmul_route_from_shape_and_dtype(m, k, n, a_dt, b_dt, body):
    assert mmk.route(m, k, n, a_dt, b_dt) == body
    assert body in mmk.ROUTES and hasattr(mmk, f"launches_{body}")


@pytest.mark.parametrize("x_dt,w_dt,c,o,body", [
    (torch.bfloat16, torch.bfloat16, 256, 256, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 8, 136, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 72, 8, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 4, 8, "fma"),
    (torch.bfloat16, torch.bfloat16, 8, 12, "fma"),
    (torch.float32, torch.float32, 256, 256, "fma"),
    (torch.bfloat16, torch.float32, 64, 64, "fma"),
])
def test_conv2d_route_from_shape_and_dtype(x_dt, w_dt, c, o, body):
    assert cvk.route(x_dt, w_dt, c, o) == body
    assert body in cvk.ROUTES and hasattr(cvk, f"launches_{body}")


# ------------------------------------------------------------ tuner knobs


def test_matmul_knobs_defaults_and_candidates(jx):
    """block_m / block_n beside split_k: the kernel's choice by default,
    every (tile, split) pair a candidate, under the JAX tuner's names."""
    from repro.kernels import autotune as jtune

    assert autotune.default("matmul", torch.bfloat16) == {"block_m": 0, "block_n": 0, "split_k": 0}
    cands = autotune.candidates("matmul", torch.bfloat16)
    want = [{"block_m": m, "block_n": n, "split_k": s}
            for m, n in ((0, 0),) + mmk.TILES for s in mmk.SPLIT_K]
    assert cands == want and autotune.default("matmul", torch.float32) in cands
    assert {"block_m", "block_n"} <= set(jtune.DEFAULTS["matmul"])
    assert all((c["block_m"], c["block_n"]) in ((0, 0),) + mmk.TILES for c in cands)


def test_matmul_knobs_cache_round_trip(tmp_path, jx):
    """A swept tile and split persist, a fresh tuner hits them without
    measuring, the JAX package's tuner reads the same entry, and a config
    of the split_k-only schema is a miss."""
    from repro.kernels import autotune as jtune

    jnp = jx[0]
    path = str(tmp_path / "t.json")
    shape = (256, 4096, 13440)
    winner = {"block_m": 128, "block_n": 256, "split_k": 1}
    t = autotune.Autotuner(path, sweep=True)
    assert t.get("matmul", shape, torch.bfloat16, "cuda",
                 measure=lambda cfg: float(cfg != winner)) == winner
    assert len(t.last_sweep) == len(autotune.candidates("matmul", torch.bfloat16))
    fresh = autotune.Autotuner(path, sweep=True)
    assert fresh.get("matmul", shape, torch.bfloat16, "cuda",
                     measure=lambda cfg: pytest.fail("measured on a hit")) == winner
    assert jtune.Autotuner(path, sweep=False).lookup("matmul", shape, jnp.bfloat16,
                                                     "cuda") == winner
    t.store("matmul", shape, torch.bfloat16, "cuda", {"split_k": 2})
    assert autotune.Autotuner(path, sweep=False).hit("matmul", shape, torch.bfloat16,
                                                     "cuda") is None


def test_conv2d_knob_round_trip(tmp_path):
    path = str(tmp_path / "t.json")
    shape = (4, 512, 512, 256)
    assert autotune.default("conv2d", torch.bfloat16) == {"block_h": 0}
    assert autotune.candidates("conv2d", torch.bfloat16) == [{"block_h": h} for h in cvk.BLOCK_H]
    t = autotune.Autotuner(path, sweep=True)
    assert t.get("conv2d", shape, torch.bfloat16, "cuda",
                 measure=lambda cfg: float(cfg["block_h"] != 2)) == {"block_h": 2}
    assert autotune.Autotuner(path, sweep=False).hit("conv2d", shape, torch.bfloat16,
                                                     "cuda") == {"block_h": 2}


@pytest.mark.parametrize("knobs", [{"block_m": 64, "block_n": 64}, {"block_m": 128},
                                   {"block_n": 256}, {"split_k": -1}])
def test_matmul_wrapper_refuses_knobs_it_lacks(knobs):
    """Knobs are checked before the operands and any launch: a tile other
    than (0, 0) or one of TILES, half a tile, or a negative split raises,
    uncounted."""
    before = (mmk.launches, mmk.launches_wgmma)
    with pytest.raises(ValueError, match="block_m, block_n|split_k"):
        mmk.matmul(torch.randn(16, 32), torch.randn(32, 8), **knobs)
    assert (mmk.launches, mmk.launches_wgmma) == before


# --------------------------------------------------------- CPU vs the JAX package


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(129, 4100, 4104), (300, 4104, 136), (37, 4096, 4104)])
def test_matmul_vs_jax_ref_at_the_tails(jx, dtype, m, k, n):
    _, jref, _ = jx
    (a, b), (ja, jb) = _inputs(jx, dtype, (m, k), (k, n), seed=m)
    got = ops.matmul(a, b)
    assert got.dtype == a.dtype and got.shape == (m, n)
    scale = float(np.abs(np.asarray(jref.matmul(ja, jb), np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jref.matmul(ja, jb), np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype] * scale)


@pytest.mark.parametrize("m,k,n", [(129, 100, 136), (37, 104, 24), (300, 72, 40)])
def test_matmul_vs_jax_interpret_at_the_tails(jx, m, k, n):
    _, jref, jops = jx
    (a, b), (ja, jb) = _inputs(jx, "float32", (m, k), (k, n), seed=k)
    _close(ops.matmul(a, b), jops.matmul(ja, jb, mode="interpret", block=32),
           jref.matmul(ja, jb), dtype="float32")


@pytest.mark.parametrize("c,o", [(8, 136), (72, 8), (16, 24)])
@pytest.mark.parametrize("kh,kw", [(1, 1), (3, 3)])
def test_conv2d_vs_jax_at_the_tails(jx, c, o, kh, kw):
    """A ragged 13 x 19 image; x and w through ops.conv2d on the CPU against
    the Pallas body in interpret mode and the JAX oracle."""
    _, jref, jops = jx
    (x, w), (jxx, jw) = _inputs(jx, "float32", (2, 13, 19, c), (kh, kw, c, o), seed=c + o)
    got = ops.conv2d(x, w)
    assert got.shape == (2, 14 - kh, 20 - kw, o)
    _close(got, jops.conv2d(jxx, jw, mode="interpret", block_h=4), jref.conv2d(jxx, jw),
           dtype="float32")


@pytest.mark.parametrize("xs,ws", [((1, 13, 19, 256), (3, 3, 256, 256)),
                                   ((2, 9, 11, 72), (3, 3, 72, 136))])
def test_conv2d_bf16_vs_jax_ref(jx, xs, ws):
    _, jref, _ = jx
    (x, w), (jxx, jw) = _inputs(jx, "bfloat16", xs, ws, seed=7)
    want = np.asarray(jref.conv2d(jxx, jw), np.float32)
    got = ops.conv2d(x, w).float().numpy()
    scale = np.sqrt(np.mean(want ** 2))
    assert np.all(np.abs(got - want) <= TOL["bfloat16"] * (np.abs(want) + scale))


# -------------------------------------------------------------------- CUDA


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(dev, seed, *shape, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MATMUL_KN)
@pytest.mark.parametrize("m", MATMUL_M)
def test_cuda_matmul_tile_vs_plain(m, k, n):
    """Every tile x split candidate against the plain version, on the body
    route() names (the wgmma tile, or the mma.sync tile for the K tail)."""
    dev = _cuda()
    a, b = _randn(dev, m, m, k), _randn(dev, k, k, n)
    want = ref.matmul(a, b).float()
    limit = MATMUL_REL_TOL * want.abs().max().item()
    body = mmk.route(m, k, n, a.dtype, b.dtype)
    for cfg in autotune.candidates("matmul", torch.bfloat16):
        n0 = getattr(mmk, f"launches_{body}")
        got = mmk.matmul(a, b, **cfg)
        assert getattr(mmk, f"launches_{body}") == n0 + 1
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        assert got.dtype == torch.bfloat16 and err <= limit, (cfg, err, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("block_h", cvk.BLOCK_H)
@pytest.mark.parametrize("kh", [1, 3])
@pytest.mark.parametrize("o", [8, 136, 256])
@pytest.mark.parametrize("c", [8, 72, 256])
def test_cuda_conv2d_wgmma_vs_plain(c, o, kh, block_h):
    """The wgmma body over a ragged 2 x 21 x 35 image (H and W no multiple
    of any patch), C past a 64-channel chunk (72) and below one (8), O
    below, across and at a 256-column tile."""
    dev = _cuda()
    torch.backends.cudnn.allow_tf32 = False
    x, w = _randn(dev, c, 2, 21, 35, c), _randn(dev, o, kh, kh, c, o)
    n0 = cvk.launches_wgmma
    got = cvk.conv2d(x, w, block_h=block_h)
    assert cvk.launches_wgmma == n0 + 1
    want = ref.conv2d(x, w).float()
    torch.cuda.synchronize()
    assert got.shape == want.shape
    limit = CONV_TOL * (want.abs() + want.pow(2).mean().sqrt())
    diff = (got.float() - want).abs()
    assert (diff <= limit).all(), f"{int((diff > limit).sum())} elements, max {diff.max()}"


@pytest.mark.cuda
def test_cuda_split_scratch_has_one_owner_per_stream():
    """Split-K matmul (forced split_k 2 and 4 at M 256, wgmma tile), the
    split GEMVs (matmul_q8 at M 4, K 13440, on the tensor-core GEMV; at f32
    activations on the CUDA-core GEMV; the bf16 matmul at M 4 on the
    tensor-core GEMV) and split decode attention (4 slots x 1024 positions,
    32 KV heads, bf16 and int8 stores) on two streams at once give bitwise
    the serial results: each call's partials are its own, each stream's
    ticket counters its own, and every reduction adds the partials in a
    fixed order."""
    from repro_torch.dist.compression import quantize_rows
    from repro_torch.kernels import decode_attention as dk

    dev = _cuda()
    a, b = _randn(dev, 0, 256, 4096), _randn(dev, 1, 4096, 13440)
    x = _randn(dev, 2, 4, 13440)
    q8 = torch.randint(-127, 128, (13440, 4096), generator=torch.Generator(device=dev)
                       .manual_seed(3), device=dev, dtype=torch.int8)
    scale = torch.rand(4096, generator=torch.Generator(device=dev).manual_seed(4),
                       device=dev) * 0.01
    x32, xb = x.float(), _randn(dev, 5, 4, 4096)
    q, k, v = _randn(dev, 6, 4, 32, 1, 128), _randn(dev, 7, 4, 1024, 32, 128), \
        _randn(dev, 8, 4, 1024, 32, 128)
    (k8, ks), (v8, vs) = quantize_rows(k.float(), torch.int8), quantize_rows(v.float(), torch.int8)
    cl = torch.tensor([0, 333, 700, 1023], dtype=torch.int32, device=dev)
    calls = {
        "split 2": lambda: mmk.matmul(a, b, split_k=2),
        "split 4": lambda: mmk.matmul(a, b, split_k=4),
        "gemv": lambda: mmk.matmul_q8(x, q8, scale),
        "gemv f32": lambda: mmk.matmul_q8(x32, q8, scale),
        "gemv bf16": lambda: mmk.matmul(xb, b),
        "decode": lambda: dk.decode_attention(q, k, v, cl, splits=4),
        "decode int8": lambda: dk.decode_attention(q, k8, v8, cl, k_scale=ks, v_scale=vs,
                                                   splits=4),
    }
    serial = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize()
    assert mmk.route(256, 4096, 13440, a.dtype, b.dtype) == "wgmma"
    assert mmk.route(4, 13440, 4096, x.dtype, q8.dtype) == "gemv_tc"
    assert mmk.route(4, 13440, 4096, x32.dtype, q8.dtype) == "gemv"
    assert mmk.route(4, 4096, 13440, xb.dtype, b.dtype) == "gemv_tc"
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = []
    for rep in range(6):
        for i, (name, fn) in enumerate(calls.items()):
            with torch.cuda.stream(streams[(rep + i) % 2]):
                outs.append((name, fn()))
    torch.cuda.synchronize()
    for name, got in outs:
        assert torch.equal(got, serial[name]), name
