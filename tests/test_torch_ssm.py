"""The state-space family in the port (``models/ssm.py``, the ssm branches of
``configs/base.py`` and ``models/model.py``, served by ``serve/engine.py``),
and the port's whole registry, against the JAX package.

CPU, f32, reduced configs; weights from the JAX ``LM.init(jax.random.key(0))``
through ``params_from_jax``:
- every config of both registries (the ten archs: chameleon-34b,
  mistral-large-123b and musicgen-large among them): fields, sub-configs,
  ``num_params`` / ``num_active_params``, full and reduced;
- ``causal_conv1d``, ``conv_step`` and ``_conv_carried`` (padding rows after
  ``n_real``), the Mamba1 and Mamba2 blocks' apply / decode / packed forms
  (a carried state, padding rows) and both chunked scans across a chunk
  boundary (a 64-token input at chunk 32), on layer 0 of reduced
  falcon-mamba-7b and zamba2-2.7b;
- falcon-mamba's ``LM.prefill``, ``decode_step`` and ``packed_step`` logits
  and states (a fresh pack, then a continuation across the chunk);
- ``ServeEngine`` streams equal to the JAX engine's at two prefill budgets
  with seeded sampled requests beside greedy ones, with int8 weights (a
  no-op: every SSM leaf stays dense, in both packages);
- the refusals (speculation, paging, quantized KV) in both packages, and a
  decode chunk that leaves inactive slots' state alone.

Tolerances: 1e-5 absolute for the conv and one-step pieces, 1e-4 for the
scans and the logits (summation order, as ``tests/test_torch_model.py``);
streams must be equal. JAX is imported inside the fixtures only.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import LM, params_from_jax, quantize_params
from repro_torch.models import ssm
from repro_torch.serve import Request, SamplingParams, ServeEngine

ATOL = 1e-5
SCAN_TOL = 1e-4
MAX_LEN = 96


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX package's configs, models, ssm, quant, serve)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import serve as jserve
    from repro.models import LM as JaxLM
    from repro.models import quant as jquant
    from repro.models import ssm as jssm

    return dict(jax=jax, jnp=jnp, configs=jconfigs, serve=jserve, LM=JaxLM, ssm=jssm,
                quant=jquant)


def _pair(jx, name):
    """(JAX LM, JAX params, port LM, port params) of the reduced ``name``."""
    jm = jx["LM"](jx["configs"].get_arch(name).reduced())
    jp = jx["jax"].jit(jm.init)(jx["jax"].random.key(0))
    m = LM(get_arch(name).reduced(), device="cpu")
    return jm, jp, m, params_from_jax(jx["jax"].tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def falcon(jx):
    return _pair(jx, "falcon-mamba-7b")


@pytest.fixture(scope="module")
def zamba(jx):
    return _pair(jx, "zamba2-2.7b")


def _close(got, want, atol):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _close(got[k], want[k], atol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------- the registry


CFG_FIELDS = ("family", "modality", "source", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_head", "d_ff", "vocab_size", "qk_norm", "rope_theta", "norm_eps",
              "tie_embeddings", "first_k_dense", "dense_ff", "shared_attn_every",
              "sliding_window", "dtype")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_the_registry_matches_the_jax_package(jx, reduced):
    """Both registries hold the same ten archs with the same fields,
    sub-configs and parameter counts, full and reduced."""
    assert set(ARCHS) == set(jx["configs"].ARCHS)
    for name in ARCHS:
        jcfg, cfg = jx["configs"].get_arch(name), get_arch(name)
        if reduced:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        for f in CFG_FIELDS + ("name",):
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
        for sub in ("moe", "mla", "ssm"):
            mine, theirs = getattr(cfg, sub), getattr(jcfg, sub)
            assert (mine is None) == (theirs is None), (name, sub)
            if mine is not None:
                assert mine.__dict__ == theirs.__dict__, (name, sub)
        assert cfg.num_params() == jcfg.num_params(), name
        assert cfg.num_active_params() == jcfg.num_active_params(), name


def test_the_new_configs():
    """The five configs this slice registers, by their published shapes."""
    fm, z = get_arch("falcon-mamba-7b"), get_arch("zamba2-2.7b")
    assert (fm.family, fm.ssm.variant, fm.n_layers, fm.d_model, fm.ssm.state) == (
        "ssm", "mamba1", 64, 4096, 16)
    assert round(fm.num_params() / 1e9, 3) == 7.005
    assert (z.family, z.ssm.variant, z.n_layers, z.shared_attn_every, z.head_dim) == (
        "hybrid", "mamba2", 54, 6, 80)
    assert round(z.num_params() / 1e9, 3) == 2.340
    assert (z.reduced().n_layers, z.reduced().shared_attn_every) == (4, 2)
    assert (fm.reduced().ssm.state, fm.reduced().ssm.chunk, fm.reduced().ssm.head_dim) == (
        8, 32, 16)
    assert [get_arch(n).modality for n in ("chameleon-34b", "mistral-large-123b",
                                           "musicgen-large")] == ["vlm", "text", "audio"]
    assert get_arch("mistral-large-123b").n_heads // get_arch("mistral-large-123b").n_kv_heads \
        == 12


# ----------------------------------------------------- the pieces


def test_conv_pieces(jx):
    """causal_conv1d, conv_step and _conv_carried (rows past n_real are
    padding: the new state is the last K-1 REAL rows)."""
    jssm, jnp = jx["ssm"], jx["jnp"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    _close(ssm.causal_conv1d(_t(x), _t(w), _t(b)), jssm.causal_conv1d(x, w, b), ATOL)
    got_y, got_s = ssm.conv_step(_t(st), _t(x[:, 0]), _t(w), _t(b))
    want_y, want_s = jssm.conv_step(st, x[:, 0], w, b)
    _close(got_y, want_y, ATOL)
    _close(got_s, want_s, ATOL)
    for n_real in (11, 7, 1, 0):
        got = ssm._conv_carried(_t(x), _t(st), _t(w), _t(b), torch.tensor(n_real))
        want = jssm._conv_carried(x, st, w, b, jnp.int32(n_real))
        _close(got[0], want[0], ATOL)
        _close(got[1], want[1], ATOL)


def _block(jx, pair):
    """Layer 0's mamba params of a pair: (JAX, port)."""
    jm, jp, m, p = pair
    return _layer0(jp["blocks"]["mamba"]), _layer0(p["blocks"]["mamba"])


@pytest.mark.parametrize("fam", ["falcon", "zamba"])
def test_the_blocks(jx, request, fam):
    """apply (with its returned state), decode from that state, and a
    state-passing packed chunk with padding rows after ``n_real``, on a
    64-token input at chunk 32 (two chunks)."""
    jm, jp, m, p = request.getfixturevalue(fam)
    jb, tb = _block(jx, (jm, jp, m, p))
    jssm, jnp, cfg = jx["ssm"], jx["jnp"], m.cfg
    v = cfg.ssm.variant
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    want, wst = getattr(jssm, f"{v}_apply")(jb, jm.cfg, x, return_state=True)
    got, gst = getattr(ssm, f"{v}_apply")(tb, cfg, _t(x), return_state=True)
    _close(got, want, SCAN_TOL)
    _close(gst, wst, SCAN_TOL)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want, wst2 = getattr(jssm, f"{v}_decode")(jb, jm.cfg, x1, wst)
    got, gst2 = getattr(ssm, f"{v}_decode")(tb, cfg, _t(x1), {k: _t(a) for k, a in
                                                                  wst.items()})
    _close(got, want, ATOL)
    _close(gst2, wst2, ATOL)
    xp = rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    one = {k: np.asarray(a)[:1] for k, a in wst2.items()}
    for n_real in (16, 11):
        want, wst3 = getattr(jssm, f"{v}_packed")(jb, jm.cfg, xp, one, jnp.int32(n_real))
        got, gst3 = getattr(ssm, f"{v}_packed")(tb, cfg, _t(xp), {k: _t(a) for k, a in
                                                                    one.items()},
                                                torch.tensor(n_real))
        _close(got[:, :n_real], np.asarray(want)[:, :n_real], SCAN_TOL)
        _close(gst3, wst3, SCAN_TOL)


def test_the_chunked_scans(jx):
    """_selective_scan_chunked and _ssd_chunked on their own, a 64-token
    input at chunk 32 and in one chunk, from a carried state."""
    jssm = jx["ssm"]
    rng = np.random.default_rng(2)
    b, s, d_in, n = 2, 64, 12, 8
    x = rng.standard_normal((b, s, d_in)).astype(np.float32)
    dt = rng.uniform(0.001, 0.3, (b, s, d_in)).astype(np.float32)
    a = -rng.uniform(0.5, 8, (d_in, n)).astype(np.float32)
    bm, c = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((b, d_in, n)).astype(np.float32)
    for chunk in (32, 64):
        want = jssm._selective_scan_chunked(x, dt, a, bm, c, h0, chunk)
        got = ssm._selective_scan_chunked(*map(_t, (x, dt, a, bm, c, h0)), chunk)
        _close(got[0], want[0], SCAN_TOL)
        _close(got[1], want[1], SCAN_TOL)
    h, p, g = 4, 6, 2
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.3, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 8, h).astype(np.float32)
    bm, c = (rng.standard_normal((b, s, g, n)).astype(np.float32) for _ in range(2))
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    for chunk, st0 in ((32, None), (64, st), (32, st)):
        want = jssm._ssd_chunked(xh, dt, a, bm, c, chunk, st0)
        got = ssm._ssd_chunked(*map(_t, (xh, dt, a, bm, c)), chunk,
                               None if st0 is None else _t(st0))
        _close(got[0], want[0], SCAN_TOL)
        _close(got[1], want[1], SCAN_TOL)


# ----------------------------------------------------- the model


def test_params_cross_unchanged_and_init_matches_their_shapes(jx, falcon, zamba):
    for jm, jp, m, p in (falcon, zamba):
        own = m.init(torch.Generator().manual_seed(0))
        spec = jx["jax"].tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
        assert jx["jax"].tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                                  own) == spec


def test_falcon_logits_and_state(jx, falcon):
    """prefill (two slots, 40 tokens: one chunk of 40), decode, and packs of
    one slot: a fresh 16-bucket chunk of 11 real tokens, then its
    continuation."""
    jm, jp, m, p = falcon
    jnp = jx["jnp"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (2, 40)).astype(np.int32)
    want, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    got, cache = m.prefill(p, {"tokens": _t(toks)}, MAX_LEN)
    _close(got, want, SCAN_TOL)
    _close(cache, jcache, SCAN_TOL)
    nt = rng.integers(0, 256, (2, 1)).astype(np.int32)
    cur = np.array([40, 40], np.int32)
    want, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(nt)}, jnp.asarray(cur))
    got, cache = m.decode_step(p, cache, {"tokens": _t(nt)}, _t(cur))
    _close(got, want, SCAN_TOL)
    _close(cache, jcache, SCAN_TOL)
    prompt = rng.integers(0, 256, 27).astype(np.int32)
    for lo, hi in ((0, 11), (11, 27)):
        n = hi - lo
        desc = np.zeros((3, 16), np.int32)
        desc[2] = MAX_LEN
        desc[0, :n], desc[2, :n] = prompt[lo:hi], np.arange(lo, hi)
        slots, out_rows = np.array([1], np.int32), np.array([n - 1], np.int32)
        want, jcache = jm.packed_step(jp, jcache, *map(jnp.asarray, desc),
                                      out_rows=jnp.asarray(out_rows),
                                      pack_slots=jnp.asarray(slots), max_len=MAX_LEN)
        got, cache = m.packed_step(p, cache, *map(_t, desc), out_rows=_t(out_rows),
                                   pack_slots=_t(slots), max_len=MAX_LEN)
        _close(got, want, SCAN_TOL)
        _close(cache, jcache, SCAN_TOL)
    with pytest.raises(ValueError, match="never paged"):
        m.packed_step(p, cache, *map(_t, desc), pack_slots=_t(slots), max_len=MAX_LEN,
                      block_tables=torch.zeros(2, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="max_len"):
        m.packed_step(p, cache, *map(_t, desc), pack_slots=_t(slots))


def test_an_inactive_slot_keeps_its_state(falcon):
    """decode_step with ``active`` advances only the active slots' state."""
    _, _, m, p = falcon
    cache = m.init_cache(3, MAX_LEN)
    for leaf in cache.values():
        leaf.normal_(generator=torch.Generator().manual_seed(4))
    before = {k: v.clone() for k, v in cache.items()}
    m.decode_step(p, cache, {"tokens": torch.tensor([[3], [4], [5]])},
                  torch.tensor([7, 7, 7], dtype=torch.int32),
                  active=torch.tensor([1, 0, 1], dtype=torch.int32))
    for k in cache:
        assert torch.equal(cache[k][:, 1], before[k][:, 1])
        assert not torch.equal(cache[k][:, 0], before[k][:, 0])


# ----------------------------------------------------- the engine

PROMPT_LENS = (5, 23, 11, 70, 8, 40)


def _prompts(seed=13):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=s).astype(np.int32) for s in PROMPT_LENS]


def _sampling(i, params_cls):
    """Greedy, then every third a seeded temperature draw, every third a
    seeded top-k / top-p draw."""
    kw = [{}, dict(temperature=0.8, seed=100 + i),
          dict(temperature=1.0, top_k=20, top_p=0.9, seed=200 + i)][i % 3]
    return params_cls(max_new=4 + i % 4, **kw)


def _jax_streams(jx, jm, jp, prompts, **kw):
    js = jx["serve"]
    eng = js.ServeEngine(jm, jp, batch_slots=3, max_len=MAX_LEN, **kw)
    for i, pr in enumerate(prompts):
        eng.submit(js.Request(rid=i, prompt=pr, params=_sampling(i, js.SamplingParams)))
    eng.run()
    return {r.rid: (r.generated, r.finish_reason) for r in eng.finished}


def _streams(m, p, prompts, **kw):
    eng = ServeEngine(m, p, batch_slots=3, max_len=MAX_LEN, device="cpu", **kw)
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, params=_sampling(i, SamplingParams)))
    stats = eng.run()
    assert stats.total_requests == len(prompts)
    return {r.rid: (r.generated, r.finish_reason) for r in eng.finished}, eng


@pytest.mark.parametrize("budget", [64, 8])
def test_engine_streams_equal_the_jax_engine(jx, falcon, budget, monkeypatch):
    """Unified engine, packs one slot wide, every admission on the pack tier
    (a 70-token prompt spans chunks at both budgets); greedy and seeded."""
    jm, jp, m, p = falcon
    want = _jax_streams(jx, jm, jp, _prompts(), prefill_budget=budget)
    widths = []
    inner = m.packed_step

    def spy(params, cache, tokens, tok_slot, tok_pos, out_rows=None, pack_slots=None, **kw):
        widths.append(len(pack_slots))
        return inner(params, cache, tokens, tok_slot, tok_pos, out_rows, pack_slots, **kw)

    monkeypatch.setattr(m, "packed_step", spy)
    got, eng = _streams(m, p, _prompts(), prefill_budget=budget)
    assert got == want
    assert eng.unified and set(widths) == {1} and len(widths) >= len(PROMPT_LENS)


def test_int8_weights_leave_the_ssm_family_dense(jx, falcon):
    """Every SSM leaf stays dense under int8 weights, as the JAX package's
    quantize_params leaves them: the streams are the bf16-free plain ones."""
    jm, jp, m, p = falcon
    q = quantize_params(p, "int8")
    assert all(a is b for a, b in zip(jx["jax"].tree.leaves(q), jx["jax"].tree.leaves(p)))
    jq = jx["quant"].quantize_params(jp, "int8")
    assert not any(isinstance(v, dict) and "q8" in v for v in jq["blocks"]["mamba"].values())
    got, _ = _streams(m, p, _prompts()[:3], weight_dtype="int8")
    assert got == _jax_streams(jx, jm, jp, _prompts()[:3], weight_dtype="int8")


def test_refusals(jx, falcon):
    """An ssm engine refuses speculation (no state rollback), paging and
    quantized KV, where the JAX engine refuses them too; the model has no
    positional KV to page or quantize."""
    jm, jp, m, p = falcon
    js = jx["serve"]
    with pytest.raises(ValueError, match="cannot speculate"):
        ServeEngine(m, p, batch_slots=2, max_len=MAX_LEN, device="cpu", speculate="ngram")
    with pytest.raises(ValueError, match="cannot speculate"):
        js.ServeEngine(jm, jp, batch_slots=2, max_len=MAX_LEN, speculate="ngram")
    for kw, what in ((dict(kv_block_size=16), "page"), (dict(kv_dtype="int8"), "quantize")):
        with pytest.raises(ValueError, match=what):
            ServeEngine(m, p, batch_slots=2, max_len=MAX_LEN, device="cpu", **kw)
        with pytest.raises(ValueError):
            js.ServeEngine(jm, jp, batch_slots=2, max_len=MAX_LEN, **kw)
    with pytest.raises(ValueError, match="page"):
        m.init_kv_pool(4, 16)
    with pytest.raises(ValueError, match="paged"):
        m.decode_step(p, m.init_cache(2, 16), {"tokens": torch.zeros(2, 1, dtype=torch.int32)},
                      torch.zeros(2, dtype=torch.int32),
                      block_tables=torch.zeros(2, 1, dtype=torch.int32))
    assert (m.supports_packed, m.has_positional_kv, m.family_tag) == (True, False, "ssm")
