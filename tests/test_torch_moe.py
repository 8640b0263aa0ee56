"""The mixture-of-experts family in the port (``models/moe.py``, the moe
branches of ``configs/base.py`` and ``models/model.py``, served by
``serve/engine.py``), against the JAX package.

CPU (runs anywhere), f32 at the reduced widths: deepseek-v2-lite-16b (MoE +
MLA: top-2 of 4 routed experts, 2 shared, the first layer dense) and
llama4-scout-17b-a16e (GQA, G 4 reduced: top-1 of 4, 1 shared), weights from
the JAX ``LM.init(jax.random.key(0))`` through ``params_from_jax``:
- every config the port registers against the JAX registry's: fields,
  ``num_params`` and ``num_active_params``, full and reduced;
- ``moe_apply`` (out and aux) against JAX ``moe_apply`` on layer 0 of both
  configs, at ``capacity_factor`` 0.25 (entries dropped: asserted through
  ``moe_dispatch``'s ``keep``), and with tied router columns (exact logits:
  the lower expert index wins, as in ``jax.lax.top_k``);
  ``moe_reference_dense`` against JAX's;
- ``LM.prefill``, ``decode_step`` and ``packed_step`` logits against the JAX
  ``LM``, the pack through ``pack_slots`` padded to its bucket, and a pack at
  ``capacity_factor`` 0.25 in which capacity drops entries;
- ``ServeEngine`` greedy streams equal to the JAX engine's, for both
  configs at the default and a small prefill budget and at
  ``capacity_factor`` 0.25 (packs and buckets that drop entries); for
  llama4-scout also over a paged pool with prefix reuse, with int8 weights,
  and with n-gram speculation (held against the JAX engine without it).

Tolerances: 1e-5 absolute for ``moe_apply`` and its oracle (f32, summation
order only), 1e-4 for logits (two layers of f32 matmuls summed in different
orders, as ``tests/test_torch_model.py``); streams must be equal.

CUDA (``-m cuda``, skipped without a card): ``moe_apply`` at bf16 at
deepseek-v2-lite's expert widths run twice gives bitwise equal outputs (the
deterministic combine), and matches the CPU's plain result at the bf16
tolerance. JAX is imported inside the CPU tests only.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import LM, params_from_jax
from repro_torch.models import moe as moe_mod
from repro_torch.serve import Request, SamplingParams, ServeEngine

ATOL = 1e-5
LOGIT_TOL = 1e-4
MAX_LEN = 64
NAMES = ("deepseek-v2-lite-16b", "llama4-scout-17b-a16e")


@pytest.fixture(scope="module")
def jx():
    """(jax, jax.numpy, the JAX package's configs, models, moe and serve)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import serve as jserve
    from repro.models import LM as JaxLM
    from repro.models import moe as jmoe

    # jitted: one compile each instead of op-by-op dispatch (the cfg is static)
    moe = dict(moe_apply=jax.jit(jmoe.moe_apply, static_argnums=1),
               moe_reference_dense=jax.jit(jmoe.moe_reference_dense, static_argnums=1),
               _capacity=jmoe._capacity)
    return dict(jax=jax, jnp=jnp, configs=jconfigs, serve=jserve, LM=JaxLM, moe=moe)


def _pair(jx, name):
    """(JAX cfg, JAX LM, JAX params, port cfg, port LM, port params) of the
    reduced ``name``."""
    jcfg = jx["configs"].get_arch(name).reduced()
    jm = jx["LM"](jcfg)
    jp = jx["jax"].jit(jm.init)(jx["jax"].random.key(0))
    m = LM(get_arch(name).reduced(), device="cpu")
    p = params_from_jax(jx["jax"].tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, m.cfg, m, p


def _at_capacity(jx, pair, cf):
    """``pair`` with both configs at capacity factor ``cf`` (the same params)."""
    jcfg, _, jp, cfg, _, p = pair
    jcfg = replace(jcfg, moe=replace(jcfg.moe, capacity_factor=cf))
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
    return jcfg, jx["LM"](jcfg), jp, cfg, LM(cfg, device="cpu"), p


@pytest.fixture(scope="module")
def pairs(jx):
    return {name: _pair(jx, name) for name in NAMES}


def _close(got: torch.Tensor, want, atol=ATOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


class _Kept:
    """Records every ``moe_dispatch`` call's (entries, kept) while active."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = moe_mod.moe_dispatch

        def spy(router, cfg, x_flat, aux=True):
            d = inner(router, cfg, x_flat, aux)
            self.calls.append((d.keep.numel(), int(d.keep.sum())))
            return d

        monkeypatch.setattr(moe_mod, "moe_dispatch", spy)

    @property
    def dropped(self) -> int:
        return sum(n - k for n, k in self.calls)


# ----------------------------------------------------- config and params


def test_configs_and_param_counts_match_the_jax_package(jx):
    """Every config the port registers, full and reduced."""
    assert set(NAMES) <= set(ARCHS)
    for name in ARCHS:
        for red in (False, True):
            jcfg, cfg = jx["configs"].get_arch(name), get_arch(name)
            if red:
                jcfg, cfg = jcfg.reduced(), cfg.reduced()
            for f in ("family", "source", "n_layers", "d_model", "n_heads", "n_kv_heads",
                      "d_head", "d_ff", "vocab_size", "qk_norm", "rope_theta", "norm_eps",
                      "tie_embeddings", "first_k_dense", "dense_ff", "sliding_window", "dtype"):
                assert getattr(cfg, f) == getattr(jcfg, f), (name, red, f)
            for sub in ("moe", "mla"):
                mine, theirs = getattr(cfg, sub), getattr(jcfg, sub)
                assert (mine is None) == (theirs is None), (name, red, sub)
                if mine is not None:
                    assert mine.__dict__ == theirs.__dict__, (name, red, sub)
            assert cfg.num_params() == jcfg.num_params(), (name, red)
            assert cfg.num_active_params() == jcfg.num_active_params(), (name, red)
    ds = get_arch("deepseek-v2-lite-16b")
    assert round(ds.num_params() / 1e9, 2) == 15.71
    assert get_arch("llama4-scout-17b-a16e").num_active_params() < get_arch(
        "llama4-scout-17b-a16e").num_params()


def test_params_cross_unchanged_and_init_matches_their_shapes(jx, pairs):
    """params_from_jax carries dense_blocks / moe_blocks as they are; the
    port's LM.init builds the same tree (shapes and dtypes: the router f32)."""
    for name in NAMES:
        _, _, jp, cfg, m, p = pairs[name]
        assert ("dense_blocks" in p) == bool(cfg.first_k_dense)
        assert p["moe_blocks"]["moe"]["router"].dtype == torch.float32
        np.testing.assert_array_equal(p["moe_blocks"]["moe"]["w_in"].numpy(),
                                      np.asarray(jp["moe_blocks"]["moe"]["w_in"]))
        own = m.init(torch.Generator().manual_seed(0))
        spec = jx["jax"].tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
        assert jx["jax"].tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                                  own) == spec
        bf16 = LM(replace(cfg, dtype="bfloat16"), device="cpu").init(
            torch.Generator().manual_seed(0))
        assert bf16["moe_blocks"]["moe"]["router"].dtype == torch.float32
        assert bf16["moe_blocks"]["moe"]["w_in"].dtype == torch.bfloat16


def test_family_refusals():
    """ssm and hybrid are not ported; a moe config without its MoEConfig
    is refused."""
    cfg = get_arch("llama4-scout-17b-a16e").reduced()
    for family in ("ssm", "hybrid"):
        with pytest.raises(NotImplementedError):
            LM(replace(cfg, family=family), device="cpu")
    with pytest.raises(ValueError, match="MoEConfig"):
        LM(replace(cfg, moe=None), device="cpu")
    with pytest.raises(ValueError, match="MoEConfig"):
        replace(cfg, moe=None).num_params()
    m = LM(cfg, device="cpu")
    assert (m.supports_packed, m.has_positional_kv, m.family_tag) == (True, True, "moe")
    ds = LM(get_arch("deepseek-v2-lite-16b").reduced(), device="cpu")
    assert (ds.supports_packed, ds.has_positional_kv, ds.family_tag) == (True, False, "moe+mla")


# -------------------------------------------------------- the MoE block


def _tied(cfg, jl, tl, rng):
    """Layer 0's router with columns 1..k+1 equal, and inputs in steps of
    1/8: every logit is exact whatever the summation order, so tied experts
    tie exactly and top-k must take the lower index."""
    k = cfg.moe.top_k
    r = rng.integers(-1, 2, size=(cfg.d_model, cfg.moe.n_routed)).astype(np.float32) / 64
    r[:, 1: k + 2] = np.abs(r[:, :1]) * 4  # k + 1 equal columns, the largest for x > 0
    x = rng.integers(0, 9, size=(3, 7, cfg.d_model)).astype(np.float32) / 8
    jl = dict(jl, router=r)
    tl = dict(tl, router=torch.from_numpy(r))
    return jl, tl, x


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["plain", "drop", "tie"])
def test_moe_apply_vs_jax(jx, pairs, monkeypatch, name, case):
    jnp = jx["jnp"]
    jcfg, _, jp, cfg, _, p = pairs[name]
    jl, tl = _layer0(jp["moe_blocks"]["moe"]), _layer0(p["moe_blocks"]["moe"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 7, cfg.d_model)).astype(np.float32)
    if case == "drop":
        jcfg = replace(jcfg, moe=replace(jcfg.moe, capacity_factor=0.25))
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=0.25))
        x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)  # T = 96: C = 16
    if case == "tie":
        jl, tl, x = _tied(cfg, jl, tl, rng)
    kept = _Kept(monkeypatch)
    jo, jaux = jx["moe"]["moe_apply"](jl, jcfg, jnp.asarray(x))
    o, aux = moe_mod.moe_apply(tl, cfg, torch.from_numpy(x))
    assert o.shape == x.shape and o.dtype == torch.float32
    _close(o, jo)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL, rtol=0)
    assert len(kept.calls) == 1
    t = x.shape[0] * x.shape[1]
    assert kept.calls[0][0] == t * cfg.moe.top_k
    if case == "drop":
        assert moe_mod._capacity(t, cfg) == 16
        assert kept.dropped > 0
    if case == "plain":
        assert kept.dropped == 0
    if case == "tie":
        k = cfg.moe.top_k
        probs, _, top_e = moe_mod._route(torch.from_numpy(x.reshape(t, -1)), tl["router"], k)
        assert torch.equal(probs[:, 1], probs[:, k + 1])  # an exact tie
        # every token's top-k is the k lowest of the tied block (x >= 0 here)
        assert torch.equal(top_e.sort(-1).values,
                           torch.arange(1, k + 1).expand(t, k)), top_e


def test_moe_reference_dense_vs_jax(jx, pairs):
    jnp = jx["jnp"]
    x = np.random.default_rng(8).standard_normal((2, 5, 64)).astype(np.float32)
    for name in NAMES:
        jcfg, _, jp, cfg, _, p = pairs[name]
        jl, tl = _layer0(jp["moe_blocks"]["moe"]), _layer0(p["moe_blocks"]["moe"])
        want = jx["moe"]["moe_reference_dense"](jl, jcfg, jnp.asarray(x))
        got = moe_mod.moe_reference_dense(tl, cfg, torch.from_numpy(x))
        _close(got, want)
        # no drop at these 10 tokens: the dispatched block is the oracle
        _close(moe_mod.moe_apply(tl, cfg, torch.from_numpy(x))[0], want)


def test_capacity_is_the_jax_rule(jx):
    for name in NAMES:
        jcfg, cfg = jx["configs"].get_arch(name), get_arch(name)
        for t in (1, 4, 5, 16, 17, 24, 64, 128, 700, 4096):
            assert moe_mod._capacity(t, cfg) == jx["moe"]["_capacity"](t, jcfg), (name, t)
    # deepseek-v2-lite: a decode step of 4 slots takes C = T (nothing drops)
    assert moe_mod._capacity(4, get_arch("deepseek-v2-lite-16b")) == 4


# ---------------------------------------------------------- the model


@pytest.mark.parametrize("name", NAMES)
def test_lm_logits(jx, pairs, name):
    """Prefill (3 prompts of 11), two decode steps at ragged lengths, then a
    pack of two chunks through pack_slots padded to a 16-token bucket, with
    out_rows; the cache after the pack (live rows)."""
    jnp = jx["jnp"]
    _, jm, jp, cfg, m, p = pairs[name]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, size=(3, 11)).astype(np.int32)
    jit = jx["jax"].jit  # one compile a step instead of op-by-op dispatch
    prefill, decode = jit(jm.prefill, static_argnums=2), jit(jm.decode_step)
    packed = jit(jm.packed_step, static_argnames="max_len")
    jlog, jcache = prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    log, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    _close(log, jlog, LOGIT_TOL)
    cur = np.asarray([11, 7, 0], np.int32)
    t1 = rng.integers(0, 256, size=(3, 1)).astype(np.int32)
    for _ in range(2):
        jlog, jcache = decode(jp, jcache, {"tokens": jnp.asarray(t1)}, jnp.asarray(cur))
        log, cache = m.decode_step(p, cache, {"tokens": torch.from_numpy(t1)},
                                   torch.from_numpy(cur))
        _close(log, jlog, LOGIT_TOL)
        t1 = np.array(jnp.argmax(jlog, -1), np.int32)
        cur = cur + 1
    local = [0] * 6 + [1] * 5 + [0] * 5
    pos = list(range(13, 19)) + list(range(11, 16)) + [MAX_LEN] * 5
    args = (rng.integers(0, 256, size=len(local)).astype(np.int32),
            np.asarray(local, np.int32), np.asarray(pos, np.int32))
    out_rows, ps = np.asarray([5, 10, 2], np.int32), np.asarray([2, 0], np.int32)
    jlog, jcache = packed(jp, jcache, *map(jnp.asarray, args), out_rows=jnp.asarray(out_rows),
                          pack_slots=jnp.asarray(ps), max_len=MAX_LEN)
    log, cache = m.packed_step(p, cache, *map(torch.from_numpy, args),
                               out_rows=torch.from_numpy(out_rows),
                               pack_slots=torch.from_numpy(ps), max_len=MAX_LEN)
    _close(log, jlog, LOGIT_TOL)
    for leaf in cache:
        _close(cache[leaf], jcache[leaf], LOGIT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_packed_step_that_drops_entries(jx, pairs, monkeypatch, name):
    """A 64-token pack (56 live tokens of two slots, 8 of padding after
    them) at capacity factor 0.25: C = 16 a routed expert, so entries drop;
    every live row's logits equal JAX's."""
    jnp = jx["jnp"]
    _, jm, jp, cfg, m, p = _at_capacity(jx, pairs[name], 0.25)
    rng = np.random.default_rng(9)
    jcache, cache = jm.init_cache(2, MAX_LEN), m.init_cache(2, MAX_LEN)
    slot = [0] * 40 + [1] * 16 + [0] * 8
    pos = list(range(40)) + list(range(16)) + [MAX_LEN] * 8
    args = (rng.integers(0, 256, size=64).astype(np.int32), np.asarray(slot, np.int32),
            np.asarray(pos, np.int32))
    live = np.arange(56)
    kept = _Kept(monkeypatch)
    packed = jx["jax"].jit(jm.packed_step, static_argnames="max_len")
    jlog, jcache = packed(jp, jcache, *map(jnp.asarray, args), max_len=MAX_LEN)
    log, cache = m.packed_step(p, cache, *map(torch.from_numpy, args), max_len=MAX_LEN)
    assert [n for n, _ in kept.calls] == [64 * cfg.moe.top_k] * (cfg.n_layers - cfg.first_k_dense)
    assert kept.dropped > 0
    _close(log[live], np.asarray(jlog)[live], LOGIT_TOL)
    for leaf in cache:
        _close(cache[leaf][:, :, :40], np.asarray(jcache[leaf])[:, :, :40], LOGIT_TOL)


# --------------------------------------------------------- the engine

# straddle the prefill budget of 16: prompts of up to 16 tokens take fused
# admissions (bucket-padded, every bucket token routed), longer ones packs
# padded to T buckets; every other prompt sits behind a shared 16-token
# prefix (the paged lane's prefix hits)
PROMPT_LENS = (5, 23, 11, 31, 8, 17)
BUDGET = 16


def _prompts(seed=13, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    base = [rng.integers(0, 256, size=s).astype(np.int32) for s in lens]
    return [np.concatenate([base[3][:16], pr]) if i % 2 else pr for i, pr in enumerate(base)]


def _jax_streams(jx, jm, jp, prompts, **kw):
    js = jx["serve"]
    eng = js.ServeEngine(jm, jp, batch_slots=3, max_len=MAX_LEN, **{"prefill_budget": BUDGET, **kw})
    for i, pr in enumerate(prompts):
        eng.submit(js.Request(rid=i, prompt=pr, params=js.SamplingParams(max_new=4 + i % 3)))
    eng.run()
    return {r.rid: r.generated for r in eng.finished}


def _streams(m, p, prompts, **kw):
    eng = ServeEngine(m, p, batch_slots=3, max_len=MAX_LEN, device="cpu",
                      **{"prefill_budget": BUDGET, **kw})
    for i, pr in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=pr, params=SamplingParams(max_new=4 + i % 3)))
    stats = eng.run()
    assert stats.total_requests == len(prompts)
    return {r.rid: r.generated for r in eng.finished}, eng, stats


@pytest.fixture(scope="module")
def jax_streams(jx, pairs):
    """The JAX engine's greedy streams of both configs over ``_prompts()``."""
    return {name: _jax_streams(jx, *pairs[name][1:3], _prompts()) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_engine_streams_equal_the_jax_engine(pairs, jax_streams, monkeypatch, name):
    """Greedy streams through fused admissions and packs; both routes ran."""
    _, _, _, _, m, p = pairs[name]
    kept = _Kept(monkeypatch)
    got, _, _ = _streams(m, p, _prompts())
    assert got == jax_streams[name]
    n_moe = m.cfg.n_layers - m.cfg.first_k_dense
    routed = {n // m.cfg.moe.top_k for n, _ in kept.calls[::n_moe]}
    assert routed == {3, 8, 16}  # every slot of a decode step; buckets 8 and 16, 16-token packs


def test_engine_streams_that_drop_entries(jx, pairs, monkeypatch):
    """deepseek-v2-lite at capacity factor 0.25 with a 32-token budget:
    fused admissions of up to 32 tokens and packs up to a 64-token bucket
    drop entries; the streams still equal the JAX engine's."""
    _, jm, jp, _, m, p = _at_capacity(jx, pairs["deepseek-v2-lite-16b"], 0.25)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, 256, size=s).astype(np.int32) for s in (30, 45, 20, 60)]
    want = _jax_streams(jx, jm, jp, prompts, prefill_budget=32)
    kept = _Kept(monkeypatch)
    got, _, _ = _streams(m, p, prompts, prefill_budget=32)
    assert kept.dropped > 0
    assert got == want


@pytest.mark.parametrize("lane", ["paged_prefix", "int8_weights", "ngram"])
def test_scout_lanes_equal_the_jax_engine(jx, pairs, jax_streams, lane):
    """llama4-scout (GQA MoE) over a paged pool with prefix reuse, with int8
    weights (the expert stacks read through qweight, the shared expert
    through matmul_q8; held against the JAX engine with int8 weights), and
    with n-gram speculation (held against the JAX engine without it)."""
    name = "llama4-scout-17b-a16e"
    _, jm, jp, _, m, p = pairs[name]
    if lane == "paged_prefix":
        got, eng, _ = _streams(m, p, _prompts(), kv_block_size=8, prefix_cache=True)
        assert eng.prefix.stats().hit_tokens > 0
        assert got == jax_streams[name]
    elif lane == "int8_weights":
        got, eng, _ = _streams(m, p, _prompts(), weight_dtype="int8")
        w = eng.params["moe_blocks"]["moe"]
        assert set(w["w_in"]) == {"q8", "scale"} and w["router"].dtype == torch.float32
        assert set(w["shared"]["w_in"]) == {"q8", "scale"}
        assert got == _jax_streams(jx, jm, jp, _prompts(), weight_dtype="int8")
    else:
        got, _, stats = _streams(m, p, _prompts(), speculate="ngram")
        assert stats.spec_proposed > 0
        assert got == jax_streams[name]


# ---------------------------------------------------------- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_moe_apply_is_deterministic():
    """deepseek-v2-lite's expert widths (64 routed, top-6, 2 shared, d 2048,
    ff 1408) at bf16 over a 128-token pack: two runs are bitwise equal, and
    the card agrees with the CPU's plain result within the bf16 tolerance
    (2e-2 of the output's scale)."""
    dev = _cuda()
    cfg = get_arch("deepseek-v2-lite-16b")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = _layer0(moe_mod.moe_init(cfg, gen, torch.bfloat16, dev, 1))
    x = torch.randn(128, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    a, _ = moe_mod.moe_apply(p, cfg, x)
    b, _ = moe_mod.moe_apply(p, cfg, x)
    assert torch.equal(a, b)
    cpu = moe_mod.moe_apply(_to(p, "cpu"), cfg, x.cpu())[0].float()
    scale = cpu.abs().max()
    assert (a.cpu().float() - cpu).abs().max() <= 2e-2 * scale


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
