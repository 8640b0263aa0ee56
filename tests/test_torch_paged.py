"""The port's block-paged KV serving against the JAX package.

CPU:
- ``BlockPool`` and ``RadixPrefixCache``: the port's copies hand out the
  same block ids, refcounts, match lengths and evictions as JAX's under one
  op sequence.
- The plain ``paged_ragged_attention`` / ``paged_decode_attention`` (plain
  and over a quantized pool) against ``repro.kernels.ops.*(mode=
  "interpret")`` within ``TOL`` at f32 — f32 softmax over <= 32 keys,
  differing in summation order only.
- A write whose table entry is the sentinel, or whose position lies past the
  table, lands in the pool's scratch block and leaves every live block
  untouched.
- Reduced codeqwen engine streams EQUAL to the JAX paged engine's:
  ``kv_block_size=8`` with mid-stream admissions and a prompt over the
  budget, a mid-stream cancel, prefix on and off (with the same hit counts),
  a pool that makes admissions wait; an infeasible submit raises; no block
  leaks. One JAX run per reference, shared through module fixtures.

CUDA (``-m cuda``, skipped without a card): the paged kernel against its
plain version on the card over f32, bf16, int8 and fp8 pools.
"""

import numpy as np
import pytest
import torch

from repro_torch.dist.compression import quantize_rows
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pk
from repro_torch.serve import BlockPool, RadixPrefixCache, blocks_for

TOL = 1e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.ops)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops

    return jnp, jops


# --------------------------------------------------------- host structures


def test_pool_and_prefix_tree_match_jax_under_one_op_sequence():
    pytest.importorskip("jax")
    from repro.serve import kv_pool as jpool_mod
    from repro.serve import prefix_cache as jprefix_mod

    bs = 4
    pools = [BlockPool(12, bs), jpool_mod.BlockPool(12, bs)]
    trees = [RadixPrefixCache(pools[0], bs), jprefix_mod.RadixPrefixCache(pools[1], bs)]
    rng = np.random.default_rng(0)
    sys_p = rng.integers(0, 50, size=9).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(0, 50, size=n).astype(np.int32)])
               for n in (3, 5, 2, 7)]
    prompts.append(rng.integers(0, 50, size=10).astype(np.int32))

    def trace(pool, tree):
        log, live = [], []
        for pr in prompts:
            shared, matched = tree.match(pr)
            need = blocks_for(len(pr), 4, 32, bs) - len(shared)
            if not pool.can_alloc(need):
                log.append(("evict", tree.evict(need - pool.free)))
            if not pool.can_alloc(need):
                pool.alloc_failures += 1
                pool.release_all(shared)
                log.append(("wait", len(pr)))
                pool.release_all(live.pop(0))  # the oldest request finishes
                continue
            blocks = shared + pool.alloc(need)
            log.append(("admit", matched, list(blocks)))
            log.append(("insert", tree.insert(pr, blocks)))
            live.append(blocks)
        for blocks in live:
            pool.release_all(blocks)
        log.append(("evict", tree.evict(3)))
        st = tree.stats()
        log.append((pool.refcount.tolist(), pool.free, pool.alloc_failures,
                    st.lookups, st.hits, st.hit_tokens, st.inserts, st.nodes, st.evictions))
        tree.clear()
        log.append((pool.free, pool.refcount.tolist()))
        return log

    port, ref_log = trace(pools[0], trees[0]), trace(pools[1], trees[1])
    assert port == ref_log
    assert any(e[0] == "admit" and e[1] > 0 for e in port if isinstance(e, tuple))
    assert pools[0].stats().free_blocks == 12
    assert blocks_for(10, 5, 12, 4) == jpool_mod.blocks_for(10, 5, 12, 4) == 3


# ---------------------------------------------------- paged attention (CPU)


def _paged_case(rng, kv, g, d, quant=None):
    """A fragmented pool: two sequences with scrambled, partial tables
    (sentinel nb past their ends), a decode singleton and a prefill chunk."""
    nb, bs = 7, 8
    k, v = _np(rng, nb, bs, kv, d), _np(rng, nb, bs, kv, d)
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    scales = {}
    if quant is not None:
        k, ks = quantize_rows(k, quant)
        v, vs = quantize_rows(v, quant)
        scales = dict(k_scale=ks, v_scale=vs)
    btab = torch.tensor([[4, 1, 6], [0, 5, nb]], dtype=torch.int32)
    tok_seq = torch.tensor([0, 1, 1, 1, 1], dtype=torch.int32)
    tok_pos = torch.tensor([20, 9, 10, 11, 12], dtype=torch.int32)
    q = torch.from_numpy(_np(rng, 5, kv * g, d))
    return q, k, v, tok_seq, tok_pos, btab, scales


def _jax_args(jnp, *ts):
    out = []
    for t in ts:
        if t.dtype == torch.float8_e4m3fn:
            out.append(jnp.asarray(t.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn))
        else:
            out.append(jnp.asarray(t.numpy()))
    return out


@pytest.mark.parametrize("quant", [None, torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("kv,g,window", [(4, 1, 0), (2, 2, 0), (2, 2, 6)])
def test_paged_ragged_plain_vs_jax_interpret(quant, kv, g, window, jx):
    jnp, jops = jx
    rng = np.random.default_rng(1)
    q, k, v, seq, pos, btab, scales = _paged_case(rng, kv, g, 16, quant)
    got = ops.paged_ragged_attention(q, k, v, seq, pos, btab, window=window, **scales)
    jsc = dict(zip(scales, _jax_args(jnp, *scales.values())))
    want = jops.paged_ragged_attention(
        *_jax_args(jnp, q, k, v, seq, pos, btab), window=window, mode="interpret", **jsc
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("quant", [None, torch.int8, torch.float8_e4m3fn])
def test_paged_decode_plain_vs_jax_interpret(quant, jx):
    jnp, jops = jx
    rng = np.random.default_rng(2)
    _, k, v, _, _, btab, scales = _paged_case(rng, 2, 2, 16, quant)
    q = torch.from_numpy(_np(rng, 2, 4, 16))
    cl = torch.tensor([17, 13], dtype=torch.int32)
    got = ops.paged_decode_attention(q, k, v, cl, btab, **scales)
    jsc = dict(zip(scales, _jax_args(jnp, *scales.values())))
    jargs = _jax_args(jnp, q, k, v, cl, btab)
    want = jops.paged_decode_attention(*jargs, mode="interpret", **jsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    # the plain path is the dense oracle over the gathered view, exactly
    dense = ops.decode_attention(
        q, ref.paged_gather(k, btab), ref.paged_gather(v, btab), cl,
        **{n: ref.paged_gather(s, btab) for n, s in scales.items()},
    )
    assert torch.equal(got, dense)


def test_identity_tables_make_the_pool_the_dense_cache():
    rng = np.random.default_rng(3)
    b, s_max, kv, d, bs = 2, 24, 2, 16, 8
    k, v = torch.from_numpy(_np(rng, b, s_max, kv, d)), torch.from_numpy(_np(rng, b, s_max, kv, d))
    maxb = s_max // bs
    btab = torch.arange(b * maxb, dtype=torch.int32).reshape(b, maxb)
    seq = torch.tensor([0, 1, 1], dtype=torch.int32)
    pos = torch.tensor([7, 13, 14], dtype=torch.int32)
    q = torch.from_numpy(_np(rng, 3, 4, d))
    got = ops.paged_ragged_attention(q, k.reshape(b * maxb, bs, kv, d),
                                     v.reshape(b * maxb, bs, kv, d), seq, pos, btab)
    assert torch.equal(got, ops.ragged_attention(q, k, v, seq, pos))


def test_sentinel_writes_leave_every_live_block_untouched():
    """Paged decode and packed steps whose rows are ALL sentinel (released
    slots) or past the table (bucket padding) write only the scratch block;
    a mixed pack writes exactly its real rows."""
    from repro_torch.configs import get_arch
    from repro_torch.models import LM

    m = LM(get_arch("codeqwen1.5-7b").reduced(), device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    nb, bs, b, maxb = 6, 8, 2, 3
    for kv_dtype in (None, torch.int8):
        cache = m.init_kv_pool(nb, bs, kv_dtype=kv_dtype)
        gen = torch.Generator().manual_seed(1)
        for name, leaf in cache.items():  # live blocks hold distinct values
            leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
        before = {n: t[:, :nb].clone() for n, t in cache.items()}
        sentinel = torch.full((b, maxb), nb, dtype=torch.int32)
        m.decode_step(p, cache, {"tokens": torch.tensor([[3], [4]])},
                      torch.tensor([5, 17], dtype=torch.int32), block_tables=sentinel)
        pos = torch.tensor([0, 9, 3 * bs, 3 * bs + 5], dtype=torch.int32)  # 2 past the table
        m.packed_step(p, cache, torch.tensor([1, 2, 3, 4]), torch.zeros(4, dtype=torch.int32),
                      pos, block_tables=sentinel)
        for n, t in cache.items():
            assert torch.equal(t[:, :nb], before[n]), n
        # one live row of a real table among padding rows: only (block 2, 1)
        btab = torch.tensor([[2, 0, nb], [nb, nb, nb]], dtype=torch.int32)
        m.packed_step(p, cache, torch.tensor([7, 8, 9]), torch.zeros(3, dtype=torch.int32),
                      torch.tensor([1, 3 * bs, 3 * bs], dtype=torch.int32), block_tables=btab)
        for n, t in cache.items():
            changed = (t[:, :nb] != before[n]).reshape(t.shape[0], nb, bs, -1).any(-1).any(0)
            assert changed.nonzero().tolist() == [[2, 1]], n


def test_paged_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(4)
    q, k, v, seq, pos, btab, _ = _paged_case(rng, 2, 1, 64)
    n0 = (pk.launches, pk.launches_q8)
    ops.paged_ragged_attention(q.reshape(5, 2, 64), k, v, seq, pos, btab)
    assert (pk.launches, pk.launches_q8) == n0
    with pytest.raises(ValueError, match="CUDA"):
        pk.paged_attention(q.reshape(5, 2, 1, 64), k, v, seq, pos, btab)


# ------------------------------------------------------- engine vs JAX (CPU)


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
    return jm, jp, m, p


def _prompts(sizes, seed, prefix=None):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, size=s).astype(np.int32) for s in sizes]
    if prefix is not None:
        out = [np.concatenate([prefix, pr]) for pr in out]
    return out


# (prompts, engine kwargs, max_new) of each reference run
STEADY = ((6, 13, 40, 9, 21), 11)  # 40 > prefill_budget 16: fed in three packs
SHARED = np.random.default_rng(3).integers(0, 256, size=24).astype(np.int32)
CASES = {
    "paged": (_prompts(*STEADY), dict(kv_block_size=8), 8),
    "prefix": (_prompts((6, 6, 9, 6), 5, SHARED), dict(kv_block_size=8, prefix_cache=True), 6),
    # every request needs 4 blocks of 8: 9 blocks hold two residents of four slots
    "pressure": (_prompts((24, 26, 25, 27), 9), dict(kv_block_size=8, num_blocks=9,
                                                     batch_slots=4), 6),
}


def _engine_kw(kw):
    return dict(dict(batch_slots=2, max_len=64, prefill_budget=16), **kw)


@pytest.fixture(scope="module")
def jax_runs(models):
    from repro.serve import Request as JaxRequest
    from repro.serve import SamplingParams as JaxSamplingParams
    from repro.serve import ServeEngine as JaxServeEngine

    jm, jp, _, _ = models
    out = {}
    for name, (prompts, kw, max_new) in CASES.items():
        eng = JaxServeEngine(jm, jp, **_engine_kw(kw))
        for i, pr in enumerate(prompts):
            eng.submit(JaxRequest(rid=i, prompt=pr, params=JaxSamplingParams(max_new=max_new)))
        stats = eng.run()
        out[name] = ({r.rid: r.generated for r in eng.finished}, eng, stats)
    return out


def _port_engine(models, name, **override):
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    _, _, m, p = models
    prompts, kw, max_new = CASES[name]
    eng = ServeEngine(m, p, device="cpu", **_engine_kw(dict(kw, **override)))
    handles = [eng.submit(Request(rid=i, prompt=pr, params=SamplingParams(max_new=max_new)))
               for i, pr in enumerate(prompts)]
    return eng, handles


def _streams(eng):
    return {r.rid: r.generated for r in eng.finished}


@pytest.mark.parametrize("max_chunk", [8, 1])
def test_paged_streams_match_jax(models, jax_runs, max_chunk):
    eng, _ = _port_engine(models, "paged", max_chunk=max_chunk)
    packs = []
    tick = eng._packed_tick
    eng._packed_tick = lambda stats: (packs.append(1), tick(stats))
    stats = eng.run()
    want, jeng, _ = jax_runs["paged"]
    assert _streams(eng) == want
    assert all(len(t) == 8 for t in want.values()) and len(packs) >= 7
    assert eng.pool.free == eng.num_blocks == jeng.num_blocks
    assert eng.pool.bytes_per_block == jeng.pool.bytes_per_block
    assert stats.kv_bytes_resident > 0 and eng.kv_bytes_resident() == 0
    assert stats.peak_residents == eng.B == 2  # five requests through two slots


def test_paged_equals_dense_port(models, jax_runs):
    eng, _ = _port_engine(models, "paged", kv_block_size=None)
    eng.run()
    assert not eng.paged and _streams(eng) == jax_runs["paged"][0]


def test_paged_mid_stream_cancel(models, jax_runs):
    """Cancelling rid 1 mid-decode frees its blocks; every other stream stays
    equal to the uncancelled JAX run, the cancelled one is a prefix of it."""
    want = jax_runs["paged"][0]
    eng, handles = _port_engine(models, "paged")
    it = handles[0].tokens()
    first = [next(it) for _ in range(2)]
    handles[1].cancel()
    assert first + list(it) == want[0]
    for h in handles[2:]:
        assert h.result() == want[h.rid]
    cut = handles[1].request.generated
    assert handles[1].finish_reason == "cancelled" and cut == want[1][: len(cut)]
    assert len(cut) < 8 and eng.stream_stats.cancelled == 1
    assert eng.pool.free == eng.num_blocks


@pytest.mark.parametrize("prefix", [True, False])
def test_prefix_cache_streams_and_hits_match_jax(models, jax_runs, prefix):
    want, jeng, _ = jax_runs["prefix"]
    eng, _ = _port_engine(models, "prefix", prefix_cache=prefix)
    eng.run()
    assert _streams(eng) == want
    if prefix:
        assert vars(eng.prefix.stats()) == vars(jeng.prefix.stats())
        assert eng.prefix.stats().hit_tokens >= 24
        # the tree keeps its nodes resident, each with only its own reference
        assert eng.pool.used == eng.prefix.stats().nodes
        assert eng.pool.refcount.tolist() == jeng.pool.refcount.tolist()
    else:
        assert eng.prefix is None and eng.pool.free == eng.num_blocks


def test_pool_pressure_waits_and_matches_jax(models, jax_runs):
    want, jeng, jstats = jax_runs["pressure"]
    eng, _ = _port_engine(models, "pressure")
    stats = eng.run()
    assert _streams(eng) == want
    assert stats.alloc_failures == jstats.alloc_failures >= 1
    assert stats.peak_residents == 2  # the pool, not the four slots, bounds residency
    assert eng.pool.free == eng.num_blocks


def test_infeasible_submit_and_bad_configs_raise(models):
    from repro_torch.serve import AdmissionRejected, Request, SamplingParams, ServeEngine

    _, _, m, p = models
    eng = ServeEngine(m, p, batch_slots=2, max_len=64, kv_block_size=8, num_blocks=2,
                      device="cpu")
    with pytest.raises(AdmissionRejected, match="KV blocks") as exc:
        eng.submit(Request(rid=0, prompt=np.zeros(20, np.int32),
                           params=SamplingParams(max_new=30)))
    assert exc.value.reason == "infeasible" and not eng.waiting
    with pytest.raises(ValueError, match="multiple"):
        ServeEngine(m, p, max_len=60, kv_block_size=8, device="cpu")
    with pytest.raises(ValueError, match="kv_block_size"):
        ServeEngine(m, p, max_len=64, prefix_cache=True, device="cpu")


def test_paged_prewarm_leaves_the_pool_untouched(models, jax_runs):
    eng, _ = _port_engine(models, "paged")
    before = {n: t[:, : eng.num_blocks].clone() for n, t in eng.cache.items()}
    eng.prewarm()
    for n, t in eng.cache.items():
        assert torch.equal(t[:, : eng.num_blocks], before[n])
    eng.run()
    assert _streams(eng) == jax_runs["paged"][0]


# ------------------------------------------------------------- CUDA kernels


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# f32: both sides f32 math in another order; bf16 queries and stores: one
# bf16 rounding of the output; a quantized pool folds its scales into the
# kernel's math where the plain version scales the widened rows first
PAGED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,store", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.int8), (torch.bfloat16, torch.int8),
    (torch.bfloat16, torch.float8_e4m3fn), (torch.float32, torch.float8_e4m3fn),
])
@pytest.mark.parametrize("kv,g,d,bs,window", [(4, 1, 128, 16, 0), (2, 8, 128, 32, 0),
                                               (2, 2, 64, 8, 11)])
def test_cuda_paged_vs_plain(qdtype, store, kv, g, d, bs, window):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(2)
    nb, maxb = 40, 12
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    btab = torch.full((3, maxb), nb, dtype=torch.int32, device=dev)
    btab[0, :10], btab[1, :4], btab[2, :12] = perm[:10], perm[10:14], perm[14:26]
    lens = (10 * bs - 3, 4 * bs, 12 * bs - 1)  # positions each table covers
    slots = [0] * 9 + [1] + [2] * 5 + [0, 0]
    poss = list(range(lens[0] - 9, lens[0])) + [lens[1] - 1] + list(range(3, 8)) + \
        [maxb * bs] * 2
    ts = torch.tensor(slots, dtype=torch.int32, device=dev)
    tp = torch.tensor(poss, dtype=torch.int32, device=dev)
    q = torch.randn(len(slots), kv, g, d, generator=gen, device=dev).to(qdtype)
    k = torch.randn(nb, bs, kv, d, generator=gen, device=dev)
    v = torch.randn(nb, bs, kv, d, generator=gen, device=dev)
    scales = {}
    if store in (torch.int8, torch.float8_e4m3fn):
        k, ks = quantize_rows(k, store)
        v, vs = quantize_rows(v, store)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(store), v.to(store)
    counter = "launches_q8" if scales else "launches"
    n0 = getattr(pk, counter)
    got = pk.paged_attention(q, k, v, ts, tp, btab, window=window, **scales)
    want = ref.paged_ragged_attention(q, k, v, ts, tp, btab, window=window, **scales)
    torch.cuda.synchronize()
    assert getattr(pk, counter) == n0 + 1
    real = tp < maxb * bs  # padding rows: zeros from the kernel, never read
    assert (got[real].float() - want[real].float()).abs().max().item() <= PAGED_TOL[qdtype]
    assert not got[~real].any()
