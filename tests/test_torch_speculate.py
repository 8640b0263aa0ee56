"""The port's speculative decoding (``repro_torch/serve/speculate.py`` and the
engine's verify tick) against the JAX package.

* ``NGramDrafter`` and ``ModelDrafter.truncated`` propose what JAX's
  propose, on the same contexts; the truncated draft views the target's
  block tensors (no copy).
* With ``speculate`` "ngram" and "draft", over the dense cache and the
  paged pool with prefix reuse, the port's streams for mixed greedy and
  seeded traffic equal the JAX engine's streams WITHOUT speculation, token
  for token (exact-match acceptance makes speculation invisible); the
  proposed and accepted counts and the per-slot acceptance EWMAs equal the
  JAX engine's with speculation.
* A stop token stops a speculated stream where the sequential one stops; a
  tenant that opts out proposes nothing; the adaptive depth ladder follows
  JAX's thresholds; reduced minicpm3-4b (MLA) speculates too.
* Every verify pack size B·(K+1) at 4 and 16 slots (8 to 144 tokens, not
  the engine's T buckets, tiles crossing slots) launches the ragged and the
  paged kernel through a stand-in C library.

The drafts come from reduced codeqwen (vocab 256: the n-gram drafter
matches bytes) with prompts that repeat a short pattern, so the drafter
matches and the verify rows accept.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pk
from repro_torch.kernels import ragged_attention as rk
from repro_torch.serve import (
    ModelDrafter,
    NGramDrafter,
    Request,
    SamplingParams,
    ServeEngine,
    SpeculateConfig,
)
from test_torch_tc_paged import fake_c  # noqa: F401

SLOTS, MAX_LEN, MAX_NEW = 4, 96, 12
ENGINE = dict(batch_slots=SLOTS, max_len=MAX_LEN, prefill_budget=8, seed=3)


def spec_prompts() -> list:
    """Ten prompts of 6-40 tokens, each a short random pattern repeated
    with a few random tokens in it; those past 16 tokens share a 16-token
    prefix (prefix reuse at 16-position blocks)."""
    rng = np.random.default_rng(1)
    common = rng.integers(0, 256, size=16)
    out = []
    for i, s in enumerate((6, 9, 12, 16, 19, 23, 27, 31, 36, 40)):
        pat = rng.integers(0, 256, size=3 + i % 5)
        p = np.resize(pat, s)
        p[rng.integers(0, s, size=2)] = rng.integers(0, 256, size=2)
        if s > 16:
            p[:16] = common
        out.append(p.astype(np.int32))
    return out


def _params(i: int, cls):
    kind = i % 4
    if kind == 0:
        return cls(max_new=MAX_NEW)
    if kind == 1:
        return cls(max_new=MAX_NEW, temperature=0.7, seed=50 + i)
    if kind == 2:
        return cls(max_new=MAX_NEW, temperature=0.9, top_k=20, top_p=0.9)  # seed=None
    return cls(max_new=MAX_NEW, logit_bias=((9, -1e9), (11, 0.5)))


def _jx():
    import jax

    from repro import serve as js
    from repro.configs import get_arch as jax_get_arch
    from repro.models import LM as JaxLM

    return jax, js, jax_get_arch, JaxLM


def _pair(arch: str):
    from repro_torch.configs import get_arch
    from repro_torch.models import LM, params_from_jax

    jax, _, jax_get_arch, JaxLM = _jx()
    jm = JaxLM(jax_get_arch(arch).reduced())
    jp = jm.init(jax.random.key(0))
    m = LM(get_arch(arch).reduced(), device="cpu")
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, m, p


@pytest.fixture(scope="module")
def models():
    return _pair("codeqwen1.5-7b")


def jax_run(jm, jp, prompts, **kw):
    _, js, _, _ = _jx()
    eng = js.ServeEngine(jm, jp, **{**ENGINE, "max_chunk": 1, **kw})
    for i, pr in enumerate(prompts):
        eng.submit(js.Request(rid=i, prompt=pr, params=_params(i, js.SamplingParams)))
    stats = eng.run()
    return {r.rid: r.generated for r in eng.finished}, stats, eng


def port_run(m, p, prompts, requests=None, **kw):
    eng = ServeEngine(m, p, device="cpu", **{**ENGINE, **kw})
    for req in requests or [Request(rid=i, prompt=pr, params=_params(i, SamplingParams))
                            for i, pr in enumerate(prompts)]:
        eng.submit(req)
    stats = eng.run()
    return {r.rid: r.generated for r in eng.finished}, stats, eng


@pytest.fixture(scope="module")
def jax_off(models):
    """The JAX engine's streams without speculation: the reference."""
    jm, jp, _, _ = models
    return jax_run(jm, jp, spec_prompts())[0]


@pytest.fixture(scope="module")
def jax_ngram(models, jax_off):
    """The JAX engine speculating with the n-gram drafter: its counts and
    EWMAs, and its own streams equal to its streams without. (The draft
    model's proposals are held to JAX's by the drafter's own test.)"""
    jm, jp, _, _ = models
    streams, stats, eng = jax_run(jm, jp, spec_prompts(), speculate="ngram")
    assert streams == jax_off
    assert stats.spec_proposed > 0 and stats.spec_accepted > 0
    return stats, eng


# ------------------------------------------------------------------ drafters


@pytest.mark.parametrize("vocab", [256, 1000])
def test_ngram_proposals_equal_jax(vocab):
    """Bytes (vocab <= 256) and int arrays, cyclic extension, contexts with
    no match, depth 0, None slots."""
    _, js, _, _ = _jx()
    rng = np.random.default_rng(vocab)
    ctxs = []
    for i in range(12):
        pat = rng.integers(0, vocab, size=1 + i % 6)
        c = np.resize(pat, 5 + 3 * i).astype(np.int64)
        c[rng.integers(0, len(c), size=i % 3)] = rng.integers(0, vocab)
        ctxs.append(c)
    ctxs += [rng.permutation(vocab)[:20].astype(np.int64), np.array([5], np.int64), None]
    depths = np.array([8, 1, 4, 2, 8, 3, 8, 8, 5, 6, 7, 8, 8, 8, 8])
    depths[3] = 0
    for max_n in (1, 3, 8):
        mine, theirs = NGramDrafter(max_n), js.NGramDrafter(max_n)
        mine.setup(torch.device("cpu"), len(ctxs), 96, vocab)
        theirs.setup(None, len(ctxs), 96, vocab)
        got, want = mine.propose(ctxs, depths), theirs.propose(ctxs, depths)
        assert got == want
        assert sum(map(len, got)) > 0


def test_truncated_drafter_proposals_equal_jax(models):
    """Two propose rounds over 4 slots (a catch-up of whole contexts, then of
    the few tokens since), depths 1-8; the draft's blocks are views."""
    from repro.serve.backend import resolve_backend

    jm, jp, m, p = models
    _, js, _, _ = _jx()
    mine = ModelDrafter.truncated(m, p, 1)
    theirs = js.ModelDrafter.truncated(jm, jp, 1)
    mine.setup(torch.device("cpu"), SLOTS, MAX_LEN, 256)
    theirs.setup(resolve_backend(None), SLOTS, MAX_LEN, 256)
    assert mine.params["blocks"]["mlp"]["w_in"].data_ptr() == p["blocks"]["mlp"]["w_in"].data_ptr()
    assert mine.params["blocks"]["mlp"]["w_in"].shape[0] == 1
    prompts = spec_prompts()
    ctxs = [prompts[9], prompts[4], None, prompts[7]]
    for depths in (np.array([8, 4, 0, 1]), np.array([3, 8, 0, 2])):
        got, want = mine.propose(ctxs, depths), theirs.propose(ctxs, depths)
        assert got == want
        ctxs = [np.concatenate([c, g[:2]]) if c is not None else None for c, g in zip(ctxs, got)]


# ------------------------------------------------------------- engine streams


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_spec_streams_equal_jax_spec_off(models, jax_off, mode, paged):
    _, _, m, p = models
    kw = dict(kv_block_size=16, prefix_cache=True) if paged else {}
    got, stats, eng = port_run(m, p, spec_prompts(), speculate=mode, **kw)
    assert got == jax_off
    assert stats.spec_ticks > 0 and stats.spec_proposed > 0 and stats.spec_accepted > 0
    if paged:
        assert eng.prefix.stats().hit_tokens > 0


def test_spec_counts_and_ewma_equal_jax(models, jax_ngram):
    """The same drafts, the same acceptances, slot by slot: the counts and
    each slot's final acceptance EWMA equal the JAX engine's."""
    jstats, jeng = jax_ngram
    _, _, m, p = models
    _, stats, eng = port_run(m, p, spec_prompts(), speculate="ngram")
    assert (stats.spec_proposed, stats.spec_accepted, stats.spec_ticks) == (
        jstats.spec_proposed, jstats.spec_accepted, jstats.spec_ticks)
    assert stats.spec_acceptance == jstats.spec_acceptance
    np.testing.assert_array_equal(eng._spec_ewma, jeng._spec_ewma)


def test_spec_prewarm_and_max_chunk_leave_streams(models, jax_off):
    """A prewarmed speculating engine (every smode, the verify ladder, the
    drafter's buckets) at max_chunk 1 serves the same streams."""
    _, _, m, p = models
    eng = ServeEngine(m, p, device="cpu", speculate="draft", max_chunk=1, **ENGINE)
    eng.prewarm(sampling=True)
    for i, pr in enumerate(spec_prompts()):
        eng.submit(Request(rid=i, prompt=pr, params=_params(i, SamplingParams)))
    eng.run()
    assert {r.rid: r.generated for r in eng.finished} == jax_off


def test_stop_token_stops_at_its_position(models, jax_off):
    """Each request stops at the first occurrence of a token from the middle
    of its reference stream, however many drafts the verify accepted past
    it; the engine keeps serving the others."""
    _, _, m, p = models
    prompts = spec_prompts()
    reqs = []
    for i, pr in enumerate(prompts):
        stop = jax_off[i][6]
        reqs.append(Request(rid=i, prompt=pr,
                            params=replace(_params(i, SamplingParams), stop=(stop,))))
    got, stats, eng = port_run(m, p, prompts, requests=reqs, speculate="ngram")
    for r in eng.finished:
        want = jax_off[r.rid]
        cut = want.index(r.params.stop[0]) + 1
        assert r.generated == want[:cut]
        assert r.finish_reason == "stop"
    assert stats.total_tokens == sum(len(t) - 1 for t in got.values())


def test_tenant_opt_out(models, jax_off):
    """Tenant "b" opts out: its requests ride the verify dispatch at depth 0
    (one sequential token a tick); alone they propose nothing."""
    _, _, m, p = models
    cfg = SpeculateConfig(mode="ngram", tenants={"b": False})
    assert not cfg.enabled_for("b") and cfg.enabled_for("a") and cfg.enabled_for(None)
    prompts = spec_prompts()
    mixed = [Request(rid=i, prompt=pr, params=_params(i, SamplingParams),
                     tenant="b" if i % 2 else "a") for i, pr in enumerate(prompts)]
    got, stats, _ = port_run(m, p, prompts, requests=mixed, speculate=cfg)
    assert got == jax_off and stats.spec_proposed > 0
    only_b = [Request(rid=i, prompt=pr, params=_params(i, SamplingParams), tenant="b")
              for i, pr in enumerate(prompts)]
    got, stats, _ = port_run(m, p, prompts, requests=only_b, speculate=cfg)
    assert got == jax_off
    assert stats.spec_proposed == 0 and stats.spec_ticks > 0


@pytest.mark.parametrize("k,adaptive", [(8, True), (3, True), (1, True), (4, False)])
def test_adaptive_depth_follows_jax(models, k, adaptive):
    jm, jp, m, p = models
    _, js, _, _ = _jx()
    cfg = SpeculateConfig(mode="ngram", k=k, adaptive=adaptive)
    mine = ServeEngine(m, p, device="cpu", speculate=cfg, **ENGINE)
    theirs = js.ServeEngine(jm, jp, speculate=js.SpeculateConfig(mode="ngram", k=k,
                                                                 adaptive=adaptive), **ENGINE)
    assert mine.spec_k == theirs.spec_k
    for e in (0.0, 0.1, 0.19, 0.2, 0.3, 0.44, 0.45, 0.6, 0.69, 0.7, 0.9, 1.0):
        mine._spec_ewma[0] = theirs._spec_ewma[0] = e
        assert mine._spec_depth(0) == theirs._spec_depth(0)


def test_spec_config_parse():
    assert SpeculateConfig.parse("off") is None
    assert SpeculateConfig.parse("draft:codeqwen1.5-7b").draft_arch == "codeqwen1.5-7b"
    assert SpeculateConfig.coerce("ngram").mode == "ngram"
    with pytest.raises(ValueError):
        SpeculateConfig.parse("medusa")
    with pytest.raises(TypeError):
        SpeculateConfig.coerce(3)


def test_draft_arch_builds_from_the_port_registry(models, jax_off):
    """``draft:<arch>`` with a reduced registry config: weights from the
    port's LM.init (not JAX's), so its counts are its own, and the stream is
    still the reference."""
    _, _, m, p = models
    cfg = SpeculateConfig(mode="draft", draft_arch="qwen3-32b", draft_reduced=True)
    got, stats, eng = port_run(m, p, spec_prompts(), speculate=cfg)
    assert got == jax_off and stats.spec_proposed > 0
    assert eng.drafter.model.cfg.n_layers == 2 and eng.drafter.model.cfg.qk_norm


def test_mla_speculates(models):
    """Reduced minicpm3-4b, greedy: ngram and draft streams equal the JAX
    engine's without speculation."""
    _, js, _, _ = _jx()
    jm, jp, m, p = _pair("minicpm3-4b")
    prompts = spec_prompts()[:6]
    eng = js.ServeEngine(jm, jp, max_chunk=1, **ENGINE)
    for i, pr in enumerate(prompts):
        eng.submit(js.Request(rid=i, prompt=pr, params=js.SamplingParams(max_new=MAX_NEW)))
    eng.run()
    want = {r.rid: r.generated for r in eng.finished}
    for mode in ("ngram", "draft"):
        reqs = [Request(rid=i, prompt=pr, params=SamplingParams(max_new=MAX_NEW))
                for i, pr in enumerate(prompts)]
        got, stats, _ = port_run(m, p, prompts, requests=reqs, speculate=mode)
        assert got == want and stats.spec_proposed > 0


# ----------------------------------------------------- verify packs' kernels


@pytest.mark.parametrize("b", [4, 16])
def test_every_verify_pack_launches(fake_c, b):  # noqa: F811
    """T = B·(K+1) for K in {1, 2, 4, 8}: 8, 12, 20, 36 at 4 slots, up to
    144 at 16; the tiles cross slots. Both wrappers plan them from host
    values and launch once each."""
    kv, g, d, s_max = 32, 1, 64, 1024
    for kk in (1, 2, 4, 8):
        t = b * (kk + 1)
        slots = torch.arange(b, dtype=torch.int32).repeat_interleave(kk + 1)
        pos = (torch.arange(kk + 1, dtype=torch.int32) + 100).repeat(b)
        q = torch.zeros(t, kv, g, d, dtype=torch.bfloat16)
        k = torch.zeros(b, s_max, kv, d, dtype=torch.bfloat16)
        n0 = (rk.launches_split, pk.launches_split_pack)
        rk.ragged_attention(q, k, k, slots, pos)
        pool = torch.zeros(b * 32 + 1, 32, kv, d, dtype=torch.bfloat16)
        tables = torch.arange(b * 32, dtype=torch.int32).view(b, 32)
        pk.paged_attention(q, pool, pool, slots, pos, tables)
        assert (rk.launches_split, pk.launches_split_pack) == (n0[0] + 1, n0[1] + 1)
        tt, span, splits = rk.plan(s_max, t, kv, g, 132, False)
        assert tt == 8 and splits >= 1 and span * splits >= s_max
        tt, span, splits = pk.plan(s_max, t, kv, g, 132, False)
        assert tt == 8 and splits >= 1 and span * splits >= s_max
    ragged = [a for n, a in fake_c if n == "repro_ragged_attention"]
    paged = [a for n, a in fake_c if n == "repro_paged_attention"]
    assert [a[10] for a in ragged] == [a[11] for a in paged] == [b * (kk + 1)
                                                                for kk in (1, 2, 4, 8)]
