"""The port's int8-weight serving against the JAX package.

CPU:
- ``quantize_params`` / ``quantize_leaf`` give the SAME BITS as JAX's (f32
  and bf16 weights): f32 widening, amax, ``where(amax > 0, amax, 1) / 127``,
  round half to even, clip, int8 cast on both sides. Identity for
  ``None``/``"f32"``/``"float32"``, ``ValueError`` otherwise, embeddings and
  norms untouched and shared, ``qweight`` within half a quantization step.
- The plain ``ref.matmul`` / ``ref.matmul_q8`` against ``repro.kernels.ref``
  (f32: 1e-5, summation order only) and against the Pallas bodies,
  ``repro.kernels.ops.matmul(_q8)(mode="interpret", block=16)`` (2e-4, as
  ``tests/test_quant_serving.py`` holds the interpret kernel to its oracle),
  with a K tail. bf16 activations: both sides sum exact products in f32 and
  round once to bf16, so they may differ by one bf16 step of the largest
  output: ``BF16_REL`` = 1e-2 of ``max|want|``.
- Reduced codeqwen1.5-7b and qwen3-32b (f32) with int8 weights: ``LM``
  prefill / decode / packed logits within 1e-4 of JAX ``LM`` over
  ``quantize_params(p, "int8")`` (the port scales the finished f32 sum, JAX
  multiplies the dequantized weight: the same value in another rounding
  order).
- Greedy streams of ``ServeEngine(weight_dtype="int8")`` EQUAL to the JAX
  engine's: dense, paged + prefix, and with an int8 KV cache (dense and
  paged).

CUDA (``-m cuda``, skipped without a card): both matmul kernels against
their plain versions over the GEMV and the tile regimes, with M, K and N
tails; and the attention kernels' bf16-query over scaled-f32-store
instantiation (the identity KV lane of a bf16 model) against the plain
versions. JAX is imported inside the CPU tests only.
"""

import numpy as np
import pytest
import torch

from repro_torch.common import pytree_bytes
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import ops, ref
from repro_torch.models.quant import (
    _quantize,
    is_quantized,
    qmatmul,
    quantize_leaf,
    quantize_params,
    qweight,
)

TOL = 1e-5  # f32 plain vs JAX oracle
INTERP_TOL = 2e-4  # vs the interpret-mode Pallas kernel
BF16_REL = 1e-2  # one bf16 output rounding, relative to max|want|
LOGIT_TOL = 1e-4


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, repro.models.quant, repro.kernels.ref, repro.kernels.ops)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import quant as jquant

    return jax, jnp, jquant, jref, jops


# ------------------------------------------------------------ quantization


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axes", [((3, 24, 4, 8), (1,)), ((2, 4, 8, 24), (1, 2)),
                                        ((3, 24, 40), (1,)), ((2, 3, 16, 24), (2,))])
def test_quantize_leaf_bitwise_equal_to_jax(in_dtype, shape, axes, jx):
    _, jnp, jquant, _, _ = jx
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    w *= rng.uniform(1e-3, 1e2, (shape[0],) + (1,) * (len(shape) - 1)).astype(np.float32)
    w[0, ..., 0] = 0.0  # an all-zero output column: scale 1/127, zeros
    wj = jnp.asarray(w).astype(getattr(jnp, in_dtype))
    wt = torch.from_numpy(w).to(getattr(torch, in_dtype))
    want = jquant.quantize_leaf(wj, axes)
    got = quantize_leaf(wt, axes)
    assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_equal(_bits(got["scale"].numpy()), _bits(np.asarray(want["scale"])))
    # the slice-at-a-time path (axis 0 kept) against one whole-leaf pass
    q, scale = _quantize(wt, axes)
    assert torch.equal(q, got["q8"]) and torch.equal(scale, got["scale"])


@pytest.fixture(scope="module", params=["codeqwen1.5-7b", "qwen3-32b"])
def pair(request, jx):
    jax, _, _, _, _ = jx
    from repro.configs import get_arch as jax_get_arch
    from repro.models import LM as JaxLM
    from repro_torch.configs import get_arch
    from repro_torch.models import LM, params_from_jax

    jm = JaxLM(jax_get_arch(request.param).reduced())
    jp = jm.init(jax.random.key(0))
    m = LM(get_arch(request.param).reduced(), device="cpu")
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, m, p


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_quantize_params_bitwise_equal_to_jax(pair, jx):
    jax, _, jquant, _, _ = jx
    from repro_torch.models import params_from_jax

    jm, jp, m, p = pair
    qp = quantize_params(p, "int8")
    want = dict(_leaves(jax.tree.map(np.asarray, jquant.quantize_params(jp, "int8"))))
    got = dict(_leaves(qp))
    assert got.keys() == want.keys()
    n_q8 = 0
    for path, leaf in got.items():
        w = want[path]
        assert leaf.shape == w.shape, path
        if path[-1] == "q8":
            n_q8 += 1
            assert leaf.dtype == torch.int8
            np.testing.assert_array_equal(leaf.numpy(), w)
        else:
            np.testing.assert_array_equal(_bits(leaf.numpy()), _bits(w))
    attn = qp["blocks"]["attn"]
    assert n_q8 == 7 and all(is_quantized(attn[k]) for k in ("wq", "wk", "wv", "wo"))
    assert all(is_quantized(qp["blocks"]["mlp"][k]) for k in ("w_in", "w_gate", "w_out"))
    # unquantized leaves are shared, not copied
    assert qp["embed"]["tok"] is p["embed"]["tok"] and qp["final_norm"] is p["final_norm"]
    assert qp["blocks"]["norm1"] is p["blocks"]["norm1"]
    if "q_norm" in p["blocks"]["attn"]:
        assert attn["q_norm"] is p["blocks"]["attn"]["q_norm"]
    # JAX's quantized tree crossing over through numpy is the same tree
    crossed = params_from_jax(jax.tree.map(np.asarray, jquant.quantize_params(jp, "int8")),
                              device="cpu")
    for path, leaf in _leaves(crossed):
        assert torch.equal(leaf, got[path]), path
    assert pytree_bytes(qp["blocks"]) * 3 < pytree_bytes(p["blocks"])


def test_quantize_params_identity_names_and_errors(pair):
    _, _, _, p = pair
    for wd in (None, "f32", "float32", torch.float32):
        assert quantize_params(p, wd) is p
    q = quantize_params(p, "int8")
    for wd in ("i8", torch.int8):
        alt = quantize_params(p, wd)
        assert torch.equal(alt["blocks"]["mlp"]["w_in"]["q8"], q["blocks"]["mlp"]["w_in"]["q8"])
    # an already quantized tree keeps its leaves
    again = quantize_params(q, "int8")
    assert again["blocks"]["attn"]["wq"]["q8"] is q["blocks"]["attn"]["wq"]["q8"]
    for bad in ("bf16", "int4", "fp8", torch.bfloat16):
        with pytest.raises(ValueError, match="weight dtype"):
            quantize_params(p, bad)


def test_qweight_within_half_a_step(pair):
    _, _, _, p = pair
    q = quantize_params(p, "int8")
    for group, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("w_in", "w_gate", "w_out"))):
        for name in names:
            w, leaf = p["blocks"][group][name], q["blocks"][group][name]
            err = (qweight(leaf) - w).abs()
            assert (err <= leaf["scale"] / 2 + 1e-6).all(), name
            assert qweight(leaf, torch.bfloat16).dtype == torch.bfloat16
            assert qweight(w) is w


# ------------------------------------------------------ plain matmul vs JAX


def _int8_weight(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32)
    amax = np.abs(w).max(axis=0)
    scale = (np.where(amax > 0, amax, 1.0) / 127.0).astype(np.float32)
    return np.clip(np.round(w / scale), -127, 127).astype(np.int8), scale


def _assert_matches(got: torch.Tensor, want, dtype: str, tol: float) -> None:
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(48, 40, 24), (37, 45, 20)])  # the second: a K tail
@pytest.mark.parametrize("quant", [False, True])
def test_plain_matmul_vs_jax(dtype, m, k, n, quant, jx):
    _, jnp, _, jref, jops = jx
    rng = np.random.default_rng(4)
    a = rng.standard_normal((m, k)).astype(np.float32)
    aj, at = jnp.asarray(a).astype(getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))
    if quant:
        q8, scale = _int8_weight(rng, k, n)
        bj, sj = jnp.asarray(q8), jnp.asarray(scale)
        got = ref.matmul_q8(at, torch.from_numpy(q8), torch.from_numpy(scale))
        assert torch.equal(got, ops.matmul_q8(at, torch.from_numpy(q8), torch.from_numpy(scale)))
        want_ref = jref.matmul_q8(aj, bj, sj)
        want_pallas = jops.matmul_q8(aj, bj, sj, mode="interpret", block=16)
    else:
        b = rng.standard_normal((k, n)).astype(np.float32)
        bj, bt = jnp.asarray(b).astype(getattr(jnp, dtype)), torch.from_numpy(b).to(getattr(torch, dtype))
        got = ref.matmul(at, bt)
        assert torch.equal(got, ops.matmul(at, bt))
        want_ref = jref.matmul(aj, bj)
        want_pallas = jops.matmul(aj, bj, mode="interpret", block=16)
    assert got.dtype == at.dtype and got.shape == (m, n)
    _assert_matches(got, want_ref, dtype, TOL)
    _assert_matches(got, want_pallas, dtype, INTERP_TOL)


def test_qmatmul_dense_and_int8_leaves():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 2, 4)).astype(np.float32))  # [d, H, hd]
    assert torch.equal(qmatmul(x, w), x @ w.reshape(16, 8))
    leaf = quantize_leaf(w[None], (1,))
    leaf = {"q8": leaf["q8"][0], "scale": leaf["scale"][0]}  # one layer's slice
    got = qmatmul(x, leaf)
    want = ref.matmul_q8(x.reshape(6, 16), leaf["q8"].reshape(16, 8), leaf["scale"].reshape(8))
    assert got.shape == (2, 3, 8) and torch.equal(got, want.reshape(2, 3, 8))
    np.testing.assert_allclose(got.numpy(), (x @ qweight(leaf).reshape(16, 8)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_matmul_wrappers_refuse_cpu_and_bad_operands():
    a, b = torch.randn(4, 8), torch.randn(8, 12)
    q8, scale = torch.zeros(8, 12, dtype=torch.int8), torch.ones(12)
    n0 = (mmk.launches, mmk.launches_q8)
    ops.matmul(a, b)
    ops.matmul_q8(a, q8, scale)
    assert (mmk.launches, mmk.launches_q8) == n0  # CPU tensors take the plain versions
    with pytest.raises(ValueError, match="CUDA"):
        mmk.matmul(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        mmk.matmul_q8(a, q8, scale)
    with pytest.raises(TypeError, match="dtype"):
        mmk.matmul(a, b.bfloat16())
    with pytest.raises(TypeError, match="int8"):
        mmk.matmul_q8(a, b, scale)
    with pytest.raises(ValueError, match="b_scale"):
        mmk.matmul_q8(a, q8, torch.ones(1, 12))
    with pytest.raises(ValueError, match="device"):
        ops.matmul(a.to("meta"), b.to("meta"))


def test_kv_codes_take_bf16_queries_over_a_scaled_f32_store():
    """The identity KV lane of a bf16 model: a bf16 query over a scaled f32
    store is a combination the kernels are built for; unscaled it is not."""
    from repro_torch.kernels import _checks

    q = torch.zeros(1, 1, 1, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 1, 32)
    assert _checks.kv_codes("t", q, k, k, torch.ones(1, 4, 1), torch.ones(1, 4, 1)) == (1, 0)
    with pytest.raises(TypeError):
        _checks.kv_codes("t", q, k, k, None, None)


# ------------------------------------------------------ model and engine vs JAX

MAX_LEN = 32


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)


@pytest.fixture(scope="module")
def qpair(pair, jx):
    """(JAX LM, JAX int8 params, port LM, port int8 params)."""
    _, _, jquant, _, _ = jx
    jm, jp, m, p = pair
    return jm, jquant.quantize_params(jp, "int8"), m, quantize_params(p, "int8")


def test_int8_prefill_decode_logits_match_jax(qpair, pair):
    import jax.numpy as jnp

    jm, jq, m, q = qpair
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 256, size=(3, 11)).astype(np.int32)
    jlog, jcache = jm.prefill(jq, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    log, cache = m.prefill(q, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    _close(log, jlog)
    _close(cache["k"], jcache["k"])
    # the weights really are quantized: the dense model's logits move
    dense, _ = m.prefill(pair[3], {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    assert 0 < (dense - log).abs().max().item() < 0.5
    cur = np.asarray([11, 7, 0], np.int32)
    step = rng.integers(0, 256, size=(3, 1)).astype(np.int32)
    for _ in range(2):
        jlog, jcache = jm.decode_step(jq, jcache, {"tokens": jnp.asarray(step)}, jnp.asarray(cur))
        log, cache = m.decode_step(q, cache, {"tokens": torch.from_numpy(step)},
                                   torch.from_numpy(cur))
        _close(log, jlog)
        step = np.array(jnp.argmax(jlog, -1), np.int32)  # writable for torch
        cur = cur + 1
    _close(cache["v"], jcache["v"])


def test_int8_packed_logits_match_jax(qpair):
    import jax.numpy as jnp

    jm, jq, m, q = qpair
    rng = np.random.default_rng(7)
    local = [0] * 6 + [1] * 5 + [0] * 3  # 3 padding rows ride local slot 0
    pos = list(range(0, 6)) + list(range(0, 5)) + [MAX_LEN] * 3
    toks = rng.integers(0, 256, size=len(local)).astype(np.int32)
    args = (toks, np.asarray(local, np.int32), np.asarray(pos, np.int32))
    pack_slots = np.asarray([1, 0], np.int32)
    jlog, jcache = jm.packed_step(jq, jm.init_cache(2, MAX_LEN), *map(jnp.asarray, args),
                                  pack_slots=jnp.asarray(pack_slots), max_len=MAX_LEN)
    log, cache = m.packed_step(q, m.init_cache(2, MAX_LEN), *map(torch.from_numpy, args),
                               pack_slots=torch.from_numpy(pack_slots), max_len=MAX_LEN)
    _close(log[:11], np.asarray(jlog)[:11])
    _close(cache["k"], jcache["k"])


SIZES = (5, 11, 8, 14, 27)  # 27 > prefill_budget: a prompt fed in two packs
MAX_NEW, SLOTS, ENGINE_LEN, BUDGET = 6, 2, 48, 16
SYSTEM = 16  # shared prompt head of the prefix lane: two blocks of 8
LANES = {
    "dense": {},
    "paged+prefix": dict(kv_block_size=8, prefix_cache=True),
    "int8-kv": dict(kv_dtype="int8"),
    "int8-kv paged+prefix": dict(kv_dtype="int8", kv_block_size=8, prefix_cache=True),
}


@pytest.fixture(scope="module")
def engine_models(jx):
    jax, _, _, _, _ = jx
    from repro.configs import get_arch as jax_get_arch
    from repro.models import LM as JaxLM
    from repro_torch.configs import get_arch
    from repro_torch.models import LM, params_from_jax

    jm = JaxLM(jax_get_arch("codeqwen1.5-7b").reduced())
    jp = jm.init(jax.random.key(0))
    m = LM(get_arch("codeqwen1.5-7b").reduced(), device="cpu")
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(21)
    system = rng.integers(0, 256, size=SYSTEM).astype(np.int32)
    prompts = [rng.integers(0, 256, size=s).astype(np.int32) for s in SIZES]
    prompts[1:4] = [np.concatenate([system, pr]) for pr in prompts[1:4]]
    return jm, jp, m, p, prompts


@pytest.fixture(scope="module")
def jax_int8_streams(engine_models):
    from repro.serve import Request as JaxRequest
    from repro.serve import SamplingParams as JaxSamplingParams
    from repro.serve import ServeEngine as JaxServeEngine

    jm, jp, _, _, prompts = engine_models
    out = {}
    for lane, kw in LANES.items():
        eng = JaxServeEngine(jm, jp, batch_slots=SLOTS, max_len=ENGINE_LEN,
                             prefill_budget=BUDGET, weight_dtype="int8", **kw)
        for i, pr in enumerate(prompts):
            eng.submit(JaxRequest(rid=i, prompt=pr, params=JaxSamplingParams(max_new=MAX_NEW)))
        eng.run()
        hits = eng.prefix.stats().hit_tokens if eng.prefix is not None else None
        out[lane] = ({r.rid: r.generated for r in eng.finished}, hits)
    return out


@pytest.mark.parametrize("lane", list(LANES))
def test_int8_weight_engine_streams_match_jax(engine_models, jax_int8_streams, lane):
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    _, _, m, p, prompts = engine_models
    eng = ServeEngine(m, p, batch_slots=SLOTS, max_len=ENGINE_LEN, prefill_budget=BUDGET,
                      weight_dtype="int8", device="cpu", **LANES[lane])
    assert is_quantized(eng.params["blocks"]["mlp"]["w_in"]) and eng.weight_dtype == "int8"
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, params=SamplingParams(max_new=MAX_NEW)))
    eng.run()
    got = {r.rid: r.generated for r in eng.finished}
    want, want_hits = jax_int8_streams[lane]
    assert all(len(t) == MAX_NEW for t in got.values())
    assert got == want
    if eng.prefix is not None:
        assert eng.prefix.stats().hit_tokens == want_hits > 0
    if eng.paged:  # every block back once the tree lets go of its own
        eng.prefix.clear()
        assert eng.pool.free == eng.num_blocks


# ------------------------------------------------------------- CUDA kernels


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# f32: both sum in f32 in different orders; bf16: both round the f32 sum
# once to bf16 (one step of the largest output at most), relative to max|plain|
CUDA_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 7, 8, 9, 16, 17, 64, 100])  # GEMV up to 8, tiles above
# (264, 272): the pipelined tile with K and N tails; (2048, 192): split K;
# (300, 260), (4096, 130) and (45, 20) are unaligned for the pipelined tile
# and take the synchronous one
@pytest.mark.parametrize("k,n", [(256, 512), (264, 272), (2048, 192), (300, 260), (4096, 130),
                                 (45, 20)])
@pytest.mark.parametrize("quant", [False, True])
def test_cuda_matmul_vs_plain(dtype, m, k, n, quant):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k)
    a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    if quant:
        w = torch.randn(k, n, generator=gen, device=dev)
        leaf = quantize_leaf(w[None], (1,))
        q8, scale = leaf["q8"][0], leaf["scale"][0].reshape(n)
        n0 = mmk.launches_q8
        got = mmk.matmul_q8(a, q8, scale)
        torch.cuda.synchronize()
        assert mmk.launches_q8 == n0 + 1
        want = ref.matmul_q8(a, q8, scale)
    else:
        b = torch.randn(k, n, generator=gen, device=dev).to(dtype)
        n0 = mmk.launches
        got = mmk.matmul(a, b)
        torch.cuda.synchronize()
        assert mmk.launches == n0 + 1
        want = ref.matmul(a, b)
    assert got.dtype == dtype and got.shape == (m, n)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= CUDA_REL[dtype] * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode", "ragged", "paged"])
@pytest.mark.parametrize("kv,g", [(4, 1), (2, 4)])
@pytest.mark.parametrize("unit_scales", [True, False])
def test_cuda_bf16_queries_over_scaled_f32_store(kernel, kv, g, unit_scales):
    """The card runs what the CPU runs: bf16 queries over an f32 store with
    scales of 1 (the identity lane) or random scales, at the bf16 tolerance
    of the attention kernels (2e-2 absolute: both compute in f32 and round
    the output once)."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ragged_attention as rk

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    d, b, s_max, bs = 128, 3, 96, 16

    def store(*shape):
        k = torch.randn(*shape, generator=gen, device=dev)
        if unit_scales:
            return k, torch.ones(shape[:-1], device=dev)
        return k, torch.rand(shape[:-1], generator=gen, device=dev) + 0.5

    if kernel == "decode":
        q = torch.randn(b, kv, g, d, generator=gen, device=dev).bfloat16()
        (k, ks), (v, vs) = store(b, s_max, kv, d), store(b, s_max, kv, d)
        cl = torch.tensor([0, 50, s_max - 1], dtype=torch.int32, device=dev)
        n0 = dk.launches_q8
        got = dk.decode_attention(q, k, v, cl, k_scale=ks, v_scale=vs)
        assert dk.launches_q8 == n0 + 1
        want = ref.decode_attention(q, k, v, cl, k_scale=ks, v_scale=vs)
    else:
        slots = [2] * 10 + [0] * 5 + [1]
        poss = list(range(20, 30)) + list(range(60, 65)) + [s_max - 1]
        ts = torch.tensor(slots, dtype=torch.int32, device=dev)
        tp = torch.tensor(poss, dtype=torch.int32, device=dev)
        q = torch.randn(len(slots), kv, g, d, generator=gen, device=dev).bfloat16()
        if kernel == "ragged":
            (k, ks), (v, vs) = store(b, s_max, kv, d), store(b, s_max, kv, d)
            got = rk.ragged_attention(q, k, v, ts, tp, k_scale=ks, v_scale=vs)
            want = ref.ragged_attention(q, k, v, ts, tp, k_scale=ks, v_scale=vs)
        else:
            nb = b * s_max // bs
            tab = torch.randperm(nb, generator=gen, device=dev).int().reshape(b, s_max // bs)
            (k, ks), (v, vs) = store(nb + 1, bs, kv, d), store(nb + 1, bs, kv, d)
            got = pk.paged_attention(q, k, v, ts, tp, tab, k_scale=ks, v_scale=vs)
            want = ref.paged_ragged_attention(q, k, v, ts, tp, tab, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
