"""The port's quantized KV cache against the JAX package.

CPU:
- ``quantize_rows`` is BITWISE equal to JAX's (int8, fp8, the f32 identity
  lane; f32 and bf16 inputs): the same ops in the same dtype, round half to
  even and round-to-nearest-even casts on both sides.
- The plain decode and ragged attention over a quantized store against
  ``repro.kernels.ops.*(mode="interpret")`` (the ``_decode_kernel_q8`` /
  ``_ragged_kernel_q8`` Pallas bodies) and against ``repro.kernels.ref``,
  within ``TOL`` at f32: both sides are f32 softmax over <= 64 keys with
  scales applied to the widened rows, differing in summation order only.
- Reduced codeqwen engine streams with ``kv_dtype`` f32, int8 and fp8, dense
  and paged, EQUAL to the JAX engine's dense stream of the same kv_dtype
  (the JAX paged engine equals its dense one, tests/test_serve_paged.py), no
  block leaked; the f32 lane equal to the unscaled engine.

CUDA (``-m cuda``, skipped without a card): the decode and ragged kernels
over int8/fp8 stores (f32 and bf16 queries) against their plain versions on
the card. JAX is imported inside the CPU tests only, so these also run where
JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.dist.compression import dequantize_rows, quantize_rows
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ragged_attention as rk

TOL = 1e-5
STORES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.dist.compression, repro.kernels.ref, repro.kernels.ops)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.dist import compression as jcomp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jcomp, jref, jops


def _jdtype(jnp, name):
    return {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn, "f32": jnp.float32}[name]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


# ------------------------------------------------------------- row quantizer


@pytest.mark.parametrize("store", ["int8", "fp8", "f32"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_quantize_rows_bitwise_equal_to_jax(store, in_dtype, jx):
    jnp, jcomp, _, _ = jx
    rng = np.random.default_rng(0)
    # rows spanning five decades, an all-zero row, exact ties of the rounding
    x = _np(rng, 6, 3, 32) * rng.uniform(1e-3, 1e2, (6, 3, 1)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1] = np.linspace(-127, 127, 32).astype(np.float32) / 2
    xj = jnp.asarray(x).astype(getattr(jnp, in_dtype))
    xt = torch.from_numpy(x).to(getattr(torch, in_dtype))
    qj, sj = jcomp.quantize_rows(xj, _jdtype(jnp, store))
    qt, st = quantize_rows(xt, {"f32": torch.float32, **STORES}[store])
    want_q = np.asarray(qj if store != "f32" else qj.astype(jnp.float32))
    got_q = qt.float().numpy() if store == "f32" else qt.view(torch.uint8).numpy()
    if store == "f32":
        np.testing.assert_array_equal(_bits(got_q), _bits(want_q))
    else:
        np.testing.assert_array_equal(got_q, want_q.view(np.uint8))
    np.testing.assert_array_equal(
        _bits(st.float().numpy()), _bits(np.asarray(sj.astype(jnp.float32)))
    )
    deq_j = np.asarray(jcomp.dequantize_rows(qj, sj))
    np.testing.assert_array_equal(_bits(dequantize_rows(qt, st).numpy()), _bits(deq_j))


def test_quantize_rows_identity_lane_and_zero_rows():
    x = torch.randn(4, 2, 16)
    q, s = quantize_rows(x, torch.float32)
    assert q is x and (s == 1).all() and s.dtype == torch.float32
    z = torch.zeros(3, 8)
    for dt in STORES.values():
        q, s = quantize_rows(z, dt)
        assert (s > 0).all() and (dequantize_rows(q, s) == 0).all()
    with pytest.raises(ValueError, match="store dtype"):
        quantize_rows(x, torch.bfloat16)


# ------------------------------------------------- q8 attention vs JAX (CPU)


def _quant_cache(rng, store, *lead_kv_d):
    k, v = _np(rng, *lead_kv_d), _np(rng, *lead_kv_d)
    kq, ks = quantize_rows(torch.from_numpy(k), STORES[store])
    vq, vs = quantize_rows(torch.from_numpy(v), STORES[store])
    return kq, ks, vq, vs


def _to_jax(jnp, t: torch.Tensor):
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("kv,g,window", [(2, 2, 0), (1, 4, 7)])
def test_q8_decode_plain_vs_jax(store, kv, g, window, jx):
    jnp, _, _, jops = jx
    rng = np.random.default_rng(1)
    b, s_max, d = 3, 32, 16
    kq, ks, vq, vs = _quant_cache(rng, store, b, s_max, kv, d)
    q = _np(rng, b, kv * g, d)
    cl = np.asarray([7, 31, 0], np.int32)
    got = ops.decode_attention(torch.from_numpy(q), kq, vq, torch.from_numpy(cl), window=window,
                               k_scale=ks, v_scale=vs)
    jargs = (jnp.asarray(q), _to_jax(jnp, kq), _to_jax(jnp, vq), jnp.asarray(cl))
    jscales = dict(k_scale=_to_jax(jnp, ks), v_scale=_to_jax(jnp, vs))
    want = jops.decode_attention(*jargs, window=window, mode="interpret", block_s=8, **jscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    want_ref = jops.decode_attention(*jargs, window=window, mode="ref", **jscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=TOL, rtol=0)
    # the plain q8 path is the dequantized cache's path
    deq = ref.decode_attention(
        torch.from_numpy(q).reshape(b, kv, g, d), dequantize_rows(kq, ks),
        dequantize_rows(vq, vs), torch.from_numpy(cl), window=window,
    )
    assert torch.equal(got, deq.reshape(b, kv * g, d))


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("kv,g,window", [(2, 2, 0), (1, 4, 5)])
def test_q8_ragged_plain_vs_jax(store, kv, g, window, jx):
    jnp, _, _, jops = jx
    rng = np.random.default_rng(2)
    b, s_max, d = 3, 32, 16
    kq, ks, vq, vs = _quant_cache(rng, store, b, s_max, kv, d)
    slots = np.asarray([2] * 6 + [0] * 5 + [1, 1], np.int32)
    poss = np.asarray(list(range(4, 10)) + list(range(11, 16)) + [0, 20], np.int32)
    q = _np(rng, len(slots), kv * g, d)
    got = ops.ragged_attention(torch.from_numpy(q), kq, vq, torch.from_numpy(slots),
                               torch.from_numpy(poss), window=window, k_scale=ks, v_scale=vs)
    want = jops.ragged_attention(
        jnp.asarray(q), _to_jax(jnp, kq), _to_jax(jnp, vq), jnp.asarray(slots),
        jnp.asarray(poss), window=window, mode="interpret", block_s=8,
        k_scale=_to_jax(jnp, ks), v_scale=_to_jax(jnp, vs),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_q8_kernel_wrappers_refuse_cpu_and_bad_scales():
    rng = np.random.default_rng(3)
    kq, ks, vq, vs = _quant_cache(rng, "int8", 2, 8, 2, 64)
    q = torch.from_numpy(_np(rng, 2, 2, 1, 64))
    cl = torch.tensor([3, 7], dtype=torch.int32)
    n0 = (dk.launches_q8, rk.launches_q8)
    ops.decode_attention(q.reshape(2, 2, 64), kq, vq, cl, k_scale=ks, v_scale=vs)
    assert (dk.launches_q8, rk.launches_q8) == n0
    with pytest.raises(ValueError, match="CUDA"):
        dk.decode_attention(q, kq, vq, cl, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="CUDA"):
        rk.ragged_attention(q, kq, vq, cl, cl, k_scale=ks, v_scale=vs)


def test_kv_codes_name_the_instantiated_combinations():
    """The (query, store) codes a wrapper hands the kernels: unscaled f32/bf16
    stores of the query's type, a scaled f32 store (the identity lane), and
    scaled int8/fp8 stores under f32 or bf16 queries; anything else raises
    before a launch."""
    from repro_torch.kernels import _checks

    def codes(qdt, kdt, scaled):
        q = torch.zeros(1, 1, 1, 32, dtype=qdt)
        k = torch.zeros(1, 4, 1, 32, dtype=kdt)
        s = torch.ones(1, 4, 1) if scaled else None
        return _checks.kv_codes("t", q, k, k, s, s)

    assert codes(torch.float32, torch.float32, False) == (0, 0)
    assert codes(torch.bfloat16, torch.bfloat16, False) == (1, 1)
    assert codes(torch.float32, torch.float32, True) == (0, 0)
    assert codes(torch.bfloat16, torch.int8, True) == (1, 2)
    assert codes(torch.float32, torch.float8_e4m3fn, True) == (0, 3)
    for qdt, kdt, scaled in [(torch.bfloat16, torch.int8, False),
                             (torch.bfloat16, torch.bfloat16, True),
                             (torch.bfloat16, torch.float32, False)]:
        with pytest.raises(TypeError):
            codes(qdt, kdt, scaled)
    with pytest.raises(ValueError, match="scales"):
        _checks.kv_codes("t", torch.zeros(1, 1, 1, 32), torch.zeros(1, 4, 1, 32, dtype=torch.int8),
                         torch.zeros(1, 4, 1, 32, dtype=torch.int8), torch.ones(4), torch.ones(4))


# ------------------------------------------------------- engine vs JAX (CPU)

SIZES = (5, 11, 8, 14, 27)  # 27 > prefill_budget: a prompt fed in two packs
MAX_NEW, SLOTS, MAX_LEN, BUDGET = 6, 2, 48, 16


@pytest.fixture(scope="module")
def models():
    jax = pytest.importorskip("jax")
    from repro.configs import get_arch as jax_get_arch
    from repro.models import LM as JaxLM
    from repro_torch.configs import get_arch
    from repro_torch.models import LM, params_from_jax

    jm = JaxLM(jax_get_arch("codeqwen1.5-7b").reduced())
    jp = jm.init(jax.random.key(0))
    m = LM(get_arch("codeqwen1.5-7b").reduced(), device="cpu")
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 256, size=s).astype(np.int32) for s in SIZES]
    return jm, jp, m, p, prompts


@pytest.fixture(scope="module")
def jax_streams(models):
    """One JAX dense run per kv_dtype (None = the unscaled cache)."""
    from repro.serve import Request as JaxRequest
    from repro.serve import SamplingParams as JaxSamplingParams
    from repro.serve import ServeEngine as JaxServeEngine

    jm, jp, _, _, prompts = models
    out = {}
    for kv_dtype in (None, "int8", "fp8"):
        eng = JaxServeEngine(jm, jp, batch_slots=SLOTS, max_len=MAX_LEN,
                             prefill_budget=BUDGET, kv_dtype=kv_dtype)
        for i, pr in enumerate(prompts):
            eng.submit(JaxRequest(rid=i, prompt=pr, params=JaxSamplingParams(max_new=MAX_NEW)))
        eng.run()
        out[kv_dtype] = {r.rid: r.generated for r in eng.finished}
    return out


def _port_run(models, **kw):
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    _, _, m, p, prompts = models
    eng = ServeEngine(m, p, batch_slots=SLOTS, max_len=MAX_LEN, prefill_budget=BUDGET,
                      device="cpu", **kw)
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, params=SamplingParams(max_new=MAX_NEW)))
    stats = eng.run()
    assert stats.total_requests == len(SIZES)
    return {r.rid: r.generated for r in eng.finished}, eng


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kv_dtype", ["f32", "int8", "fp8"])
def test_quantized_engine_streams_match_jax(models, jax_streams, kv_dtype, paged):
    """f32 is the identity lane: it must equal the UNSCALED JAX engine."""
    kw = dict(kv_block_size=8) if paged else {}
    got, eng = _port_run(models, kv_dtype=kv_dtype, **kw)
    want = jax_streams[None if kv_dtype == "f32" else kv_dtype]
    assert all(len(t) == MAX_NEW for t in got.values())
    assert got == want
    store = {"f32": torch.float32, **STORES}[kv_dtype]
    assert eng.cache["k"].dtype == store and eng.cache["k_scale"].dtype == torch.float32
    if paged:
        assert eng.pool.free == eng.num_blocks


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_packed_logits_match_jax(models, kv_dtype):
    """One packed step over a fresh quantized cache: the port's logits match
    JAX's within 1e-4 (f32 matmuls in another order), and both move away
    from the unscaled cache's logits — the rows really are quantized."""
    import jax.numpy as jnp

    jm, jp, m, p, prompts = models
    seq = prompts[4]
    t = len(seq)
    rows = np.arange(t, dtype=np.int32)
    jdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[kv_dtype]
    jargs = (jnp.asarray(seq), jnp.zeros(t, jnp.int32), jnp.asarray(rows))
    want, jcache = jm.packed_step(jp, jm.init_cache(1, MAX_LEN, kv_dtype=jdt), *jargs)
    targs = (torch.from_numpy(seq), torch.zeros(t, dtype=torch.int32), torch.from_numpy(rows))
    got, cache = m.packed_step(p, m.init_cache(1, MAX_LEN, kv_dtype=STORES[kv_dtype]), *targs)
    plain, _ = m.packed_step(p, m.init_cache(1, MAX_LEN), *targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(cache["k_scale"].numpy(), np.asarray(jcache["k_scale"]),
                               atol=1e-6, rtol=1e-6)
    gap = (got - plain).abs().max().item()
    assert 0 < gap < 0.1, gap


def test_f32_lane_equals_unscaled_port(models):
    plain, _ = _port_run(models)
    lane, eng = _port_run(models, kv_dtype="f32")
    assert lane == plain and "k_scale" in eng.cache


def test_kv_dtype_names_and_byte_accounting(models):
    from repro_torch.serve import ServeEngine

    _, _, m, p, _ = models
    cfg = m.cfg
    for name, dt in [("int8", torch.int8), ("i8", torch.int8), ("fp8", torch.float8_e4m3fn),
                     ("float8_e4m3fn", torch.float8_e4m3fn), ("float32", torch.float32),
                     (torch.int8, torch.int8)]:
        eng = ServeEngine(m, p, batch_slots=2, max_len=32, kv_dtype=name, device="cpu")
        assert eng.cache["k"].dtype == dt
    for bad in ("bf16", "int4", torch.bfloat16):
        with pytest.raises(ValueError, match="kv_dtype"):
            ServeEngine(m, p, batch_slots=2, max_len=32, kv_dtype=bad, device="cpu")
    # one block over every layer: K + V rows of head_dim bytes, + 2 f32 scales
    eng = ServeEngine(m, p, batch_slots=2, max_len=32, kv_block_size=8, kv_dtype="int8",
                      device="cpu")
    per_row = cfg.n_kv_heads * (cfg.head_dim * 1 + 4)
    assert eng.pool.bytes_per_block == cfg.n_layers * 8 * 2 * per_row
    dense = ServeEngine(m, p, batch_slots=2, max_len=32, kv_dtype="int8", device="cpu")
    assert dense.kv_bytes_resident() == cfg.n_layers * 2 * 32 * 2 * per_row
    assert eng.kv_bytes_resident() == 0  # nothing admitted yet


def test_quantized_prefill_into_cache_refused(models):
    _, _, m, p, prompts = models
    cache = m.init_cache(1, 32, kv_dtype=torch.int8)
    with pytest.raises(ValueError, match="packed_step"):
        m.prefill(p, {"tokens": torch.from_numpy(prompts[0][None])}, 32, cache=cache)


# ------------------------------------------------------------- CUDA kernels


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the kernel folds the scales into the score and the probability weight, the
# plain version scales the widened rows first: the same math in another f32
# rounding order; with bf16 queries both round the output once to bf16
Q8_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("kv,g,d,window", [(4, 1, 128, 0), (2, 8, 128, 0), (2, 2, 64, 9)])
def test_cuda_q8_decode_vs_plain(qdtype, store, kv, g, d, window):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s_max = 4, 300
    q = torch.randn(b, kv, g, d, generator=gen, device=dev).to(qdtype)
    kq, ks = quantize_rows(torch.randn(b, s_max, kv, d, generator=gen, device=dev), STORES[store])
    vq, vs = quantize_rows(torch.randn(b, s_max, kv, d, generator=gen, device=dev), STORES[store])
    cl = torch.tensor([0, 77, 299, 150], dtype=torch.int32, device=dev)
    n0 = dk.launches_q8
    got = dk.decode_attention(q, kq, vq, cl, window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert dk.launches_q8 == n0 + 1
    want = ref.decode_attention(q, kq, vq, cl, window=window, k_scale=ks, v_scale=vs)
    assert (got.float() - want.float()).abs().max().item() <= Q8_TOL[qdtype]


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("kv,g,d,window", [(4, 1, 128, 0), (2, 8, 128, 0), (2, 2, 64, 6)])
def test_cuda_q8_ragged_vs_plain(qdtype, store, kv, g, d, window):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s_max = 3, 200
    slots = [2] * 20 + [0] * 9 + [1, 0, 0]
    poss = list(range(5, 25)) + list(range(150, 159)) + [0, s_max, s_max]
    ts = torch.tensor(slots, dtype=torch.int32, device=dev)
    tp = torch.tensor(poss, dtype=torch.int32, device=dev)
    q = torch.randn(len(slots), kv, g, d, generator=gen, device=dev).to(qdtype)
    kq, ks = quantize_rows(torch.randn(b, s_max, kv, d, generator=gen, device=dev), STORES[store])
    vq, vs = quantize_rows(torch.randn(b, s_max, kv, d, generator=gen, device=dev), STORES[store])
    got = rk.ragged_attention(q, kq, vq, ts, tp, window=window, k_scale=ks, v_scale=vs)
    want = ref.ragged_attention(q, kq, vq, ts, tp, window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    real = tp < s_max  # padding rows: zeros from the kernel, never read
    assert (got[real].float() - want[real].float()).abs().max().item() <= Q8_TOL[qdtype]
    assert not got[~real].any()
