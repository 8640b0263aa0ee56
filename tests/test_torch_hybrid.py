"""The hybrid family and the legacy prefill+insert tier in the port (the
hybrid branches of ``models/model.py``, ``ServeEngine(unified=False)`` in
``serve/engine.py``, ``ServeCluster(unified=...)``), against the JAX package.

CPU, f32, reduced zamba2-2.7b (4 Mamba2 layers, the shared attention + MLP
block after every 2: two invocations, 4 heads at d_head 16) and reduced
codeqwen1.5-7b; weights from the JAX ``LM.init(jax.random.key(0))`` through
``params_from_jax``:
- ``LM.prefill`` (two slots at 37 tokens: one chunk of 37) and
  ``decode_step`` logits and every cache leaf (``mamba`` state, the shared
  block's ``attn_k`` / ``attn_v`` planes);
- ``ServeEngine`` streams equal to the JAX engine's on the legacy tier, the
  hybrid's default, greedy and seeded (temperature, top-k / top-p), and for
  the dense codeqwen with ``unified=False`` (also equal to the port's
  unified engine, greedy);
- ``_insert`` overwrites every leaf of the slot, its attention rows up to
  ``max_len`` included;
- the one-time ``RuntimeWarning``, ``unified=True`` refused for a hybrid,
  and the legacy tier's refusals (speculation, paging, quantized KV) in both
  packages; the hybrid's packed step refused;
- a split ``ServeCluster`` of two zamba2 replicas on the CPU gives the
  single legacy engine's streams.

Tolerances: 1e-4 for the logits and the cache (summation order, as
``tests/test_torch_model.py``); streams must be equal. JAX is imported
inside the fixtures only.
"""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import LM, params_from_jax
from repro_torch.serve import Request, SamplingParams, ServeCluster, ServeEngine
from repro_torch.serve import engine as engine_mod

LOGIT_TOL = 1e-4
MAX_LEN = 64


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX package's configs, models, serve)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import serve as jserve
    from repro.models import LM as JaxLM

    return dict(jax=jax, jnp=jnp, configs=jconfigs, serve=jserve, LM=JaxLM)


def _pair(jx, name):
    """(JAX LM, JAX params, port LM, port params) of the reduced ``name``."""
    jm = jx["LM"](jx["configs"].get_arch(name).reduced())
    jp = jx["jax"].jit(jm.init)(jx["jax"].random.key(0))
    m = LM(get_arch(name).reduced(), device="cpu")
    return jm, jp, m, params_from_jax(jx["jax"].tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def zamba(jx):
    return _pair(jx, "zamba2-2.7b")


@pytest.fixture(scope="module")
def codeqwen(jx):
    return _pair(jx, "codeqwen1.5-7b")


@pytest.fixture
def quiet():
    """The legacy-tier warning silenced (its own test checks it)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def _close(got, want, atol=LOGIT_TOL):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k], atol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------- the model


def test_hybrid_logits_and_cache(jx, zamba):
    jm, jp, m, p = zamba
    jnp = jx["jnp"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (2, 37)).astype(np.int32)
    want, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    got, cache = m.prefill(p, {"tokens": _t(toks)}, MAX_LEN)
    _close(got, want)
    _close(cache, jcache)
    assert tuple(cache["attn_k"].shape) == (2, 2, MAX_LEN, 4, 16)
    for step in range(2):
        nt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        cur = np.array([37 + step, 30], np.int32)
        want, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(nt)},
                                      jnp.asarray(cur))
        got, cache = m.decode_step(p, cache, {"tokens": _t(nt)}, _t(cur))
        _close(got, want)
        _close(cache, jcache)
    assert (m.supports_packed, m.has_positional_kv, m.family_tag) == (False, False, "hybrid")
    with pytest.raises(ValueError, match="no packed path"):
        m.packed_step(p, cache, *(torch.zeros(8, dtype=torch.int32) for _ in range(3)),
                      max_len=MAX_LEN)


# ----------------------------------------------------- the legacy tier

PROMPT_LENS = (5, 23, 11, 40, 8, 17)


def _prompts(seed=13):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=s).astype(np.int32) for s in PROMPT_LENS]


def _sampling(i, params_cls, seeded=True):
    kw = [{}, dict(temperature=0.8, seed=100 + i),
          dict(temperature=1.0, top_k=20, top_p=0.9, seed=200 + i)][i % 3 if seeded else 0]
    return params_cls(max_new=4 + i % 4, **kw)


def _jax_streams(jx, jm, jp, prompts, seeded=True, **kw):
    js = jx["serve"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng = js.ServeEngine(jm, jp, batch_slots=3, max_len=MAX_LEN, **kw)
    for i, pr in enumerate(prompts):
        eng.submit(js.Request(rid=i, prompt=pr, params=_sampling(i, js.SamplingParams, seeded)))
    eng.run()
    return {r.rid: (r.generated, r.finish_reason) for r in eng.finished}


def _serve(target, prompts, seeded=True, handles=None):
    for i, pr in enumerate(prompts):
        h = target.submit(Request(rid=i, prompt=pr, params=_sampling(i, SamplingParams, seeded)))
        if handles is not None:
            handles.append(h)
    stats = target.run()
    assert stats.total_requests == len(prompts)
    return {r.rid: (r.generated, r.finish_reason) for r in target.finished}


def _streams(m, p, prompts, seeded=True, **kw):
    eng = ServeEngine(m, p, batch_slots=3, max_len=MAX_LEN, device="cpu", **kw)
    return _serve(eng, prompts, seeded), eng


@pytest.fixture(scope="module")
def zamba_streams(jx, zamba):
    """The JAX engine's zamba2 streams, greedy and seeded (its default tier:
    legacy)."""
    return _jax_streams(jx, *zamba[:2], _prompts())


def test_hybrid_streams_equal_the_jax_engine(zamba, zamba_streams, quiet):
    """Legacy tier by default: blocking exact-length prefills, the first
    token from the fused sampler, decode chunks; greedy and seeded."""
    _, _, m, p = zamba
    got, eng = _streams(m, p, _prompts())
    assert not eng.unified and not eng._prefilling
    assert got == zamba_streams


def test_dense_legacy_streams_equal_the_jax_engine(jx, codeqwen, quiet):
    """A dense model with unified=False: exact-length legacy prefills (the
    JAX engine's are bucket-padded; attention masks the padding, so the
    logits agree); the same greedy streams as the JAX legacy engine and the
    port's unified one."""
    jm, jp, m, p = codeqwen
    got, eng = _streams(m, p, _prompts(), seeded=False, unified=False)
    assert not eng.unified
    assert got == _jax_streams(jx, jm, jp, _prompts(), seeded=False, unified=False)
    assert got == _streams(m, p, _prompts(), seeded=False)[0]


def test_insert_overwrites_the_whole_slot(zamba, quiet):
    """_insert copies a one-slot cache into every leaf of its slot: the
    Mamba state and the attention rows up to max_len, nothing else."""
    _, _, m, p = zamba
    eng = ServeEngine(m, p, batch_slots=3, max_len=MAX_LEN, device="cpu")
    one = m.init_cache(1, MAX_LEN)
    for leaf in (one["mamba"]["h"], one["mamba"]["conv"], one["attn_k"], one["attn_v"]):
        leaf.fill_(2.0)
    eng._insert(one, 1)
    for leaf in (eng.cache["mamba"]["h"], eng.cache["mamba"]["conv"], eng.cache["attn_k"],
                 eng.cache["attn_v"]):
        assert bool((leaf[:, 1] == 2.0).all()) and not bool(leaf[:, [0, 2]].any())
    assert eng.kv_bytes_resident() == sum(
        t.numel() * 4 for t in (eng.cache["mamba"]["h"], eng.cache["mamba"]["conv"],
                                eng.cache["attn_k"], eng.cache["attn_v"]))


def test_tier_defaults_and_refusals(jx, zamba, monkeypatch):
    """A hybrid defaults to the legacy tier with a one-time RuntimeWarning
    and refuses unified=True; the legacy tier refuses speculation, paging and
    quantized KV, in both packages."""
    jm, jp, m, p = zamba
    js = jx["serve"]
    monkeypatch.setattr(engine_mod, "_LEGACY_WARNED", set())
    with pytest.warns(RuntimeWarning, match="legacy prefill\\+insert tier"):
        ServeEngine(m, p, batch_slots=2, max_len=MAX_LEN, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # once per family
        ServeEngine(m, p, batch_slots=2, max_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="no packed path"):
        ServeEngine(m, p, batch_slots=2, max_len=MAX_LEN, device="cpu", unified=True)
    with pytest.raises(ValueError, match="no packed path"):
        js.ServeEngine(jm, jp, batch_slots=2, max_len=MAX_LEN, unified=True)
    dense = LM(get_arch("codeqwen1.5-7b").reduced(), device="cpu")
    dp = dense.init(torch.Generator().manual_seed(0))
    for model, params in ((m, p), (dense, dp)):
        for kw in (dict(speculate="ngram"), dict(kv_block_size=16), dict(kv_dtype="int8")):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                with pytest.raises(ValueError):
                    ServeEngine(model, params, batch_slots=2, max_len=MAX_LEN, device="cpu",
                                unified=False, **kw)
                with pytest.raises(ValueError):
                    js.ServeEngine(jm, jp, batch_slots=2, max_len=MAX_LEN, unified=False, **kw)


def test_split_cluster_of_hybrid_replicas(zamba, zamba_streams, quiet):
    """Two reduced zamba2 replicas on the legacy tier, split over
    ["cpu", "cpu"], give the single legacy engine's streams (greedy and
    seeded: each draw is keyed by its request's seed and position)."""
    _, _, m, p = zamba
    cl = ServeCluster(m, p, devices=["cpu", "cpu"], batch_slots=3, max_len=MAX_LEN)
    assert len(cl.engines) == 2 and not any(e.unified for e in cl.engines)
    handles = []
    assert _serve(cl, _prompts(), handles=handles) == zamba_streams
    assert {h.replica for h in handles} == {0, 1}
