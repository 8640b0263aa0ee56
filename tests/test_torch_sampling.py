"""The port's sampler zoo (``repro_torch/serve/sampling.py``) and its seeded
serving against the JAX package.

* ``fused_sample`` at smodes 0, 1 and 2, ``_keep_mask`` and ``spec_verify``
  against JAX's on the same numpy-made inputs: the tokens, masks, accepted
  runs and commits must be EQUAL. Held off rounding boundaries by
  construction: each top-p threshold sits midway between two exclusive
  cumulative masses (computed in float64) that are at least 1e-3 apart,
  where the two float32 softmax/cumsum orders differ by ~1e-7; the gumbel
  draws differ by at most 4 float32 steps (``tests/test_torch_prng.py``),
  and no case's winning margin is that thin (asserted).
* The engine's streams for mixed seeded traffic (greedy, temperature,
  top-k/top-p, logit bias, ``seed=None`` under the engine's ``seed``) equal
  the JAX engine's token for token: dense at ``max_chunk`` 1 and 8, paged
  with prefix reuse, and int8 KV with int8 weights; a cancelled slot leaves
  its neighbours' streams alone.

JAX is imported inside the CPU tests only, so the ``cuda`` test also runs
where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.serve import Request, SamplingParams, ServeEngine
from repro_torch.serve import sampling as S

V = 300
SLOTS, MAX_LEN, MAX_NEW = 4, 96, 10
PROMPT_LENS = (5, 8, 11, 13, 16, 19, 23, 27, 31, 34)
BAN, BOOST = 17, 42


def _jax_sampling():
    """JAX's sampler, each function jitted (one program a shape and smode
    instead of one per op)."""
    import jax

    from repro.serve import sampling as js

    class Jitted:
        fused_sample = jax.jit(js.fused_sample, static_argnames="smode")
        spec_verify = jax.jit(js.spec_verify, static_argnames="smode")
        _keep_mask = jax.jit(js._keep_mask)

    return Jitted


# ----------------------------------------------------------- fused_sample


def _rows(b: int, seed: int, bias: bool = True):
    """Sampler rows over ``b`` rows: greedy rows, temperatures, top-k 0/1/5
    (a tie at the 5th value), top-p off / near 0 / between two masses, and
    bias lanes with duplicates, the padding id, -1 and -V (which JAX wraps),
    V and 2**30 (which it drops); ``bias=False`` leaves every lane padded."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, V)).astype(np.float32) * 3
    logits[:, :64] = np.round(logits[:, :64] * 2) / 2  # ties among the largest
    temps = rng.choice([0.0, 0.5, 0.8, 1.0, 1.7], size=b).astype(np.float32)
    temps[:2] = (0.0, 1.0)
    top_k = rng.choice([0, 1, 5, 40], size=b).astype(np.int32)
    seeds = rng.integers(-(2**31), 2**31 - 1, size=b).astype(np.int32)
    pos = rng.integers(0, 4096, size=b).astype(np.int32)
    btok = np.full((b, S.MAX_LOGIT_BIAS), S._BIAS_PAD, np.int32)
    bval = np.zeros((b, S.MAX_LOGIT_BIAS), np.float32)
    lanes = [(3, 1.5), (3, -0.25), (-1, 2.0), (-V, 0.75), (V, 9.0), (2**30, 9.0),
             (BAN, -1e9), (7, 0.5)]
    for i in range(b if bias else 0):
        for j, (t, v) in enumerate(lanes[: i % (len(lanes) + 1)]):
            btok[i, j], bval[i, j] = t, v
    # the biased, scaled logits, in float64, to place each top-p threshold
    biased = logits.astype(np.float64).copy()
    for i in range(b):
        for t, v in zip(btok[i], bval[i]):
            if -V <= t < V:
                biased[i, t % V] += v
    scaled = biased / np.maximum(temps, 1e-6)[:, None]
    top_p = np.ones(b, np.float32)
    for i in range(b):
        kind = i % 3
        if kind == 1:
            top_p[i] = 1e-6
        elif kind == 2:
            srt = np.sort(scaled[i])[::-1]
            p = np.exp(srt - srt[0])
            p /= p.sum()
            cum = np.cumsum(p) - p
            gaps = np.flatnonzero((np.diff(cum) > 1e-3) & (cum[1:] < 0.999))
            if gaps.size:
                j = gaps[min(2, gaps.size - 1)]
                top_p[i] = np.float32((cum[j] + cum[j + 1]) / 2)
    return logits, temps, top_k, top_p, seeds, pos, btok, bval


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("smode", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_sample_matches_jax(smode, seed):
    import jax.numpy as jnp

    js = _jax_sampling()
    arrays = _rows(48, seed)
    want = np.asarray(js.fused_sample(*[jnp.asarray(a) for a in arrays], smode=smode))
    got = S.fused_sample(*_t(*arrays), smode=smode).numpy()
    np.testing.assert_array_equal(got, want)
    if smode == S.SMODE_MASKED:
        assert BAN not in got  # a banned token is never drawn
    if smode:
        # the draws are not decided by a gumbel difference within its bound
        logits, temps, top_k, top_p = (torch.from_numpy(a) for a in arrays[:4])
        biased = logits.clone()
        if smode == S.SMODE_MASKED:
            S._add_bias(biased, *_t(arrays[6], arrays[7]))
        scaled = biased / temps.clamp_min(1e-6)[:, None]
        if smode == S.SMODE_MASKED:
            scaled = torch.where(S._keep_mask(scaled, top_k, top_p), scaled, -torch.inf)
        g = S.prng.gumbel(S._fold_keys(*_t(arrays[4], arrays[5])), V)
        top2 = (scaled + g).topk(2, dim=-1).values
        live = temps > 0
        margin = (top2[live, 0] - top2[live, 1]).min().item()
        assert margin > 4 * np.spacing(np.float32(64.0))


def test_keep_mask_matches_jax():
    """Every row off its rounding boundary: a top-p below 1 midway between
    two masses (``_rows``), and at top-p 1 a spread of 5 across the row (its
    smallest probability >= e^-5 / V, far above a float32 step of 1)."""
    import jax.numpy as jnp

    js = _jax_sampling()
    logits, temps, top_k, top_p = _rows(48, 3, bias=False)[:4]
    scaled = logits / np.where(temps > 0, temps, 1.0)[:, None]
    lo, hi = scaled.min(-1, keepdims=True), scaled.max(-1, keepdims=True)
    scaled = np.where((top_p >= 1.0)[:, None], (scaled - lo) / (hi - lo) * 5,
                      scaled).astype(np.float32)
    want = np.asarray(js._keep_mask(jnp.asarray(scaled), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = S._keep_mask(*_t(scaled, top_k, top_p)).numpy()
    np.testing.assert_array_equal(got, want)
    # ties at the k-th value are kept: a row with top-k 5 and no nucleus
    # keeps exactly its values >= the 5th largest
    rows = np.flatnonzero((top_k == 5) & (top_p >= 1.0))
    assert rows.size
    for i in rows:
        kth = np.sort(scaled[i])[::-1][4]
        np.testing.assert_array_equal(got[i], scaled[i] >= kth)
        assert got[i].sum() >= 5
    assert got.sum(-1).min() >= 1


def test_top_p_one_keeps_every_token():
    """The intended difference at top-p 1: the port keeps every token (the
    exclusive mass of each is below 1 in exact arithmetic). JAX's float32
    sum can reach 1.0 before a wide row's tail and drop the tokens there;
    a seeded draw differs only where it would have taken one of them, with
    probability below their mass (here < 1e-5)."""
    import jax.numpy as jnp

    js = _jax_sampling()
    scaled = np.linspace(10.0, -30.0, V, dtype=np.float32)[None]
    one, none = np.ones(1, np.float32), np.zeros(1, np.int32)
    got = S._keep_mask(*_t(scaled, none, one)).numpy()
    want = np.asarray(js._keep_mask(jnp.asarray(scaled), jnp.asarray(none), jnp.asarray(one)))
    assert got.all() and not want.all()
    p = np.exp(scaled[0].astype(np.float64) - scaled.max())
    assert (p / p.sum())[~want[0]].sum() < 1e-5


def test_duplicate_bias_lanes_add_in_lane_order():
    """(1 + 2^-24) + 2^-24 + 2^-23 in lane order is 1 + 2^-23, which ties
    token 1 (first index wins); any other order gives 1 + 2^-22."""
    import jax.numpy as jnp

    js = _jax_sampling()
    logits = np.array([[1.0, 1.0 + 2.0**-23]], np.float32)
    btok = np.full((1, S.MAX_LOGIT_BIAS), S._BIAS_PAD, np.int32)
    bval = np.zeros((1, S.MAX_LOGIT_BIAS), np.float32)
    btok[0, :3] = 0
    bval[0, :3] = (2.0**-24, 2.0**-24, 2.0**-23)
    rest = (np.zeros(1, np.float32), np.zeros(1, np.int32), np.ones(1, np.float32),
            np.zeros(1, np.int32), np.zeros(1, np.int32))
    args = (logits, rest[0], rest[1], rest[2], rest[3], rest[4], btok, bval)
    want = np.asarray(js.fused_sample(*[jnp.asarray(a) for a in args], smode=2))
    got = S.fused_sample(*_t(*args), smode=2).numpy()
    assert got.tolist() == want.tolist() == [0]


@pytest.mark.parametrize("smode", [0, 2])
def test_spec_verify_matches_jax(smode):
    import jax.numpy as jnp

    js = _jax_sampling()
    b, k = 6, 4
    logits, temps, top_k, top_p, seeds, _, btok, bval = _rows(b * (k + 1), 5)
    temps, top_k, top_p, seeds = temps[:b], top_k[:b], top_p[:b], seeds[:b]
    btok, bval = btok[:b], bval[:b]
    pos0 = np.array([3, 50, 0, 90, 7, 11], np.int32)
    depth = np.array([4, 4, 2, 0, 3, 4], np.int32)
    active = np.array([1, 1, 1, 1, 0, 1], np.int32)
    # drafts: the targets themselves up to a per-slot break, so runs of 0..4
    # are accepted
    pos = (pos0[:, None] + np.arange(k + 1)).reshape(-1)
    rep = lambda a: np.repeat(a, k + 1, axis=0)  # noqa: E731
    tg = S.fused_sample(*_t(logits, rep(temps), rep(top_k), rep(top_p), rep(seeds), pos,
                            rep(btok), rep(bval)), smode=smode).numpy().reshape(b, k + 1)
    drafts = tg[:, :k].copy()
    for i, cut in enumerate([4, 1, 0, 2, 3, 2]):
        if cut < k:
            drafts[i, cut] = (drafts[i, cut] + 1) % V
    args = (logits, drafts, depth, active, temps, top_k, top_p, seeds, pos0, btok, bval)
    want = [np.asarray(x) for x in js.spec_verify(*[jnp.asarray(a) for a in args], smode=smode)]
    got = [x.numpy() for x in S.spec_verify(*_t(*args), smode=smode)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].tolist() == [4, 1, 0, 0, 3, 2] and got[2].tolist() == [5, 2, 1, 1, 0, 3]


def test_greedy_draws_no_random_bits(monkeypatch):
    """smode 0 runs argmax only: no key, no bits, no sort."""
    def boom(*a, **k):
        raise AssertionError("smode 0 drew random bits or sorted")

    monkeypatch.setattr(S.prng, "threefry2x32", boom)
    monkeypatch.setattr(S, "_keep_mask", boom)
    logits = torch.from_numpy(_rows(8, 0)[0])
    assert torch.equal(S.fused_sample(logits), logits.argmax(-1).to(torch.int32))


# ----------------------------------------------------------- engine streams


def _params(i: int, cls):
    """The mixed traffic: greedy, temperature, top-k/top-p, greedy with a
    ban and a boost (duplicate and padded lanes), and seed=None."""
    kind = i % 5
    if kind == 0:
        return cls(max_new=MAX_NEW)
    if kind == 1:
        return cls(max_new=MAX_NEW, temperature=0.8, seed=100 + i)
    if kind == 2:
        return cls(max_new=MAX_NEW, temperature=1.0, top_k=40, top_p=0.9, seed=-200 - i)
    if kind == 3:
        return cls(max_new=MAX_NEW, logit_bias=((BAN, -1e9), (BOOST, 1.0), (BOOST, 0.5)))
    return cls(max_new=MAX_NEW, temperature=0.9, top_p=0.8)


def mixed_prompts() -> list:
    """PROMPT_LENS prompts; those past 16 tokens share a 16-token prefix
    (prefix reuse at 16-position blocks)."""
    rng = np.random.default_rng(0)
    common = rng.integers(0, 256, size=16)
    out = []
    for i, s in enumerate(PROMPT_LENS):
        p = rng.integers(0, 256, size=s)
        if s > 16:
            p[:16] = common
        out.append(p.astype(np.int32))
    return out


@pytest.fixture(scope="module")
def models():
    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro.models import LM as JaxLM
    from repro_torch.configs import get_arch
    from repro_torch.models import LM, params_from_jax

    jm = JaxLM(jax_get_arch("codeqwen1.5-7b").reduced())
    jp = jm.init(jax.random.key(0))
    m = LM(get_arch("codeqwen1.5-7b").reduced(), device="cpu")
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, m, p


ENGINE = dict(batch_slots=SLOTS, max_len=MAX_LEN, prefill_budget=8, seed=7)


def jax_streams(jm, jp, prompts, **kw):
    from repro.serve import Request as JaxRequest
    from repro.serve import SamplingParams as JaxSamplingParams
    from repro.serve import ServeEngine as JaxServeEngine

    eng = JaxServeEngine(jm, jp, **{**ENGINE, "max_chunk": 1, **kw})
    for i, pr in enumerate(prompts):
        eng.submit(JaxRequest(rid=i, prompt=pr, params=_params(i, JaxSamplingParams)))
    stats = eng.run()
    return {r.rid: r.generated for r in eng.finished}, stats


def port_engine(m, p, prompts, **kw):
    eng = ServeEngine(m, p, device="cpu", **{**ENGINE, **kw})
    handles = [eng.submit(Request(rid=i, prompt=pr, params=_params(i, SamplingParams)))
               for i, pr in enumerate(prompts)]
    return eng, handles


def port_streams(m, p, prompts, **kw):
    eng, _ = port_engine(m, p, prompts, **kw)
    stats = eng.run()
    assert stats.total_requests == len(prompts)
    return {r.rid: r.generated for r in eng.finished}, stats


@pytest.fixture(scope="module")
def jax_mixed(models):
    jm, jp, _, _ = models
    return jax_streams(jm, jp, mixed_prompts())[0]


@pytest.mark.parametrize("max_chunk", [8, 1])
def test_mixed_streams_match_jax(models, jax_mixed, max_chunk):
    """Chunking never changes a seeded stream: both depths equal the one JAX
    run at max_chunk 1; seed=None requests draw the JAX engine's seeds."""
    _, _, m, p = models
    got, _ = port_streams(m, p, mixed_prompts(), max_chunk=max_chunk)
    assert got == jax_mixed
    assert all(len(t) == MAX_NEW for t in got.values())
    assert all(BAN not in got[i] for i in got if i % 5 == 3)
    assert any(BOOST in got[i] for i in got if i % 5 == 3)


def test_paged_prefix_streams_match_jax(models, jax_mixed):
    """Paged with prefix reuse serves the same streams as the dense JAX
    engine (the JAX engine's paged streams equal its dense ones)."""
    _, _, m, p = models
    eng, _ = port_engine(m, p, mixed_prompts(), kv_block_size=16, prefix_cache=True)
    eng.run()
    assert {r.rid: r.generated for r in eng.finished} == jax_mixed
    assert eng.prefix.stats().hit_tokens > 0


def test_int8_kv_and_weights_match_jax(models):
    jm, jp, m, p = models
    kw = dict(kv_dtype="int8", weight_dtype="int8")
    want, _ = jax_streams(jm, jp, mixed_prompts(), **kw)
    got, _ = port_streams(m, p, mixed_prompts(), **kw)
    assert got == want


def test_engine_seed_draws_the_unseeded(models, jax_mixed):
    """Another engine seed changes only the seed=None streams."""
    _, _, m, p = models
    got, _ = port_streams(m, p, mixed_prompts(), seed=8)
    for i, toks in got.items():
        if i % 5 == 4:
            assert toks != jax_mixed[i]
        else:
            assert toks == jax_mixed[i]


def test_cancel_leaves_neighbours(models, jax_mixed):
    """Cancelling rid 1 (temperature, seeded) mid-decode: every other stream
    stays the uncancelled JAX run's; the cancelled one is a prefix of its."""
    _, _, m, p = models
    eng, handles = port_engine(m, p, mixed_prompts(), max_chunk=1)
    it = handles[0].tokens()
    first = [next(it) for _ in range(3)]
    handles[1].cancel()
    assert first + list(it) == jax_mixed[0]
    for h in handles[2:]:
        assert h.result() == jax_mixed[h.rid]
    cut = handles[1].request.generated
    assert handles[1].finish_reason == "cancelled" and len(cut) < MAX_NEW
    assert cut == jax_mixed[1][: len(cut)]


def test_sampled_prewarm_leaves_streams(models, jax_mixed):
    """prewarm(sampling=True) runs every variant of every route on an idle
    engine without touching what it then serves."""
    _, _, m, p = models
    eng, _ = port_engine(m, p, mixed_prompts())
    eng.prewarm(sampling=True)
    eng.run()
    assert {r.rid: r.generated for r in eng.finished} == jax_mixed


@pytest.mark.cuda
def test_cuda_fused_sample_equals_cpu():
    """smode 2 at V 92,416 on the card against the CPU: the same tokens
    (keys and uniforms are bitwise; the margins are checked on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    b, v = 16, 92416
    logits = rng.normal(size=(b, v)).astype(np.float32) * 4
    temps = np.full(b, 0.8, np.float32)
    temps[0] = 0.0
    top_k = np.array([0, 40] * 8, np.int32)
    top_p = np.array([0.9, 1.0] * 8, np.float32)
    seeds = rng.integers(0, 2**31 - 1, size=b).astype(np.int32)
    pos = rng.integers(0, 4096, size=b).astype(np.int32)
    btok = np.full((b, S.MAX_LOGIT_BIAS), S._BIAS_PAD, np.int32)
    bval = np.zeros((b, S.MAX_LOGIT_BIAS), np.float32)
    btok[:, 0], bval[:, 0] = 5, -1e9
    args = _t(logits, temps, top_k, top_p, seeds, pos, btok, bval)
    want = S.fused_sample(*args, smode=2)
    got = S.fused_sample(*[a.cuda() for a in args], smode=2)
    assert torch.equal(got.cpu(), want)

