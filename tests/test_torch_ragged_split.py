"""Dense ragged attention on the split-KV body: ``csrc/split_attention.cuh``
under ``csrc/ragged_slots.cuh``'s dense row policy (``RaggedSlots``), a
pack's tokens sharing their K/V stages in tiles of 8 / GC.

CPU (runs anywhere):
- ``ref.ragged_attention_split`` (the split body's arithmetic: per-span
  partials merged in span order, each token alone) against the JAX
  package's ``ops.ragged_attention`` in ``interpret`` and ``ref`` modes and
  the port's ``ref.ragged_attention``, over f32/bf16 queries, plain, int8
  and fp8 stores, G 1/4/8, a window, padding tokens, a tile spanning two
  slots, 8 decode singletons of 8 slots and splits 1/2/4. Tolerance: 2e-5
  absolute at f32 (softmax over <= 40 keys, summation order only) and 2e-2
  at a bf16 output (one bf16 rounding of an f32 result), as
  ``tests/test_torch_tc_paged.py``.
- What the wrapper hands the C library (a stand-in records the calls): the
  tile, span, splits, scratch and ticket pointer come from host values
  only, ``splits=`` forces a count, and every engine T bucket launches.

CUDA (``-m cuda``, skipped without a card): the kernel against the plain
version at the serving shape and forced splits, over the (D, G) domain with
and without a window, a pack of singletons over offset views of the cache at
both tiles, and a CUDA-graph replay bitwise equal to eager.
Tolerances are ``chip_smoke.py``'s: 1e-4 (f32) and 2e-2 (bf16) absolute.
"""

import numpy as np
import pytest
import torch

from repro_torch.dist.compression import quantize_rows
from repro_torch.kernels import _checks, ref
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import paged_attention as pk
from repro_torch.kernels import ragged_attention as rk
from test_torch_tc_paged import STORES, TOL, _jax, fake_c, jx  # noqa: F401

# 8 cache slots of 40 positions; a pack of 7 tokens of slot 2 (a tile of 8 at
# G = 1 reaches the first token of slot 5 too), 5 of slot 5 and 4 padding
# tokens (position 40) riding slot 2; 8 decode singletons, one a slot
B, S = 8, 40
PACK_SLOT = [2] * 7 + [5] * 5 + [2] * 4
PACK_POS = list(range(20, 27)) + list(range(11, 16)) + [S] * 4
SINGLE_SLOT = list(range(B))
SINGLE_POS = [33, 0, 17, 39, 5, 28, 12, 1]


def _cache(rng, store, dtype, kv, d, b=B, s=S):
    """A dense K/V cache in the model dtype, or quantized rows with their
    scales."""
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(np.float32))
            for _ in "kv")
    if STORES[store] is None:
        return k.to(dtype), v.to(dtype), {}
    (k, ks), (v, vs) = quantize_rows(k, STORES[store]), quantize_rows(v, STORES[store])
    return k, v, dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("dtype,store,kv,g,d,window,kind,splits", [
    ("float32", "plain", 2, 1, 16, 0, "pack", 2),
    ("float32", "plain", 1, 4, 16, 6, "pack", 4),
    ("float32", "plain", 2, 8, 32, 0, "singles", 2),
    ("bfloat16", "plain", 2, 1, 16, 0, "singles", 4),
    ("float32", "int8", 2, 4, 16, 0, "pack", 1),
    ("bfloat16", "int8", 1, 1, 32, 5, "pack", 2),
    ("float32", "fp8", 2, 8, 16, 0, "pack", 4),
    ("bfloat16", "fp8", 1, 4, 16, 9, "singles", 1),
])
def test_ragged_split_plain_vs_jax(jx, dtype, store, kv, g, d, window, kind, splits):
    jnp, jref, jops = jx
    rng = np.random.default_rng(kv * 100 + g * 10 + d + splits)
    tdt = getattr(torch, dtype)
    k, v, sc = _cache(rng, store, tdt, kv, d)
    slot, pos = (PACK_SLOT, PACK_POS) if kind == "pack" else (SINGLE_SLOT, SINGLE_POS)
    ts, tp = torch.tensor(slot, dtype=torch.int32), torch.tensor(pos, dtype=torch.int32)
    t = len(slot)
    q = torch.from_numpy(rng.standard_normal((t, kv, g, d)).astype(np.float32)).to(tdt)
    got = ref.ragged_attention_split(q, k, v, ts, tp, splits, window=window, block_s=8, **sc)
    assert got.dtype == tdt and got.shape == q.shape
    real = tp < S
    assert not got[~real].any()  # padding: zeros, no key read
    jargs = [_jax(jnp, x) for x in (q.reshape(t, kv * g, d), k, v, ts, tp)]
    jsc = {n: _jax(jnp, x) for n, x in sc.items()}
    mine = got.float().reshape(t, kv * g, d).numpy()[real.numpy()]
    for mode in ("interpret", "ref"):
        want = jops.ragged_attention(*jargs, window=window, mode=mode, **jsc)
        np.testing.assert_allclose(mine, np.asarray(want, np.float32)[real.numpy()],
                                   atol=TOL[dtype], rtol=0)
    plain = ref.ragged_attention(q, k, v, ts, tp, window=window, **sc)
    np.testing.assert_allclose(got.float()[real].numpy(), plain.float()[real].numpy(),
                               atol=TOL[dtype], rtol=0)


def test_ragged_split_of_singletons_is_the_decode_split():
    """A pack of one token per slot at cur_len is the split decode: the two
    twins agree bit for bit (the same spans, the same merge)."""
    rng = np.random.default_rng(5)
    k, v, sc = _cache(rng, "int8", torch.float32, 2, 16)
    q = torch.from_numpy(rng.standard_normal((B, 2, 4, 16)).astype(np.float32))
    cl = torch.tensor(SINGLE_POS, dtype=torch.int32)
    got = ref.ragged_attention_split(q, k, v, torch.arange(B, dtype=torch.int32), cl, 3,
                                     window=7, block_s=8, **sc)
    want = ref.decode_attention_split(q, k, v, cl, 3, window=7, block_s=8, **sc)
    assert torch.equal(got, want)


# ------------------------------------------- what the wrapper hands the C library


def _call(t, kv, g, d=64, s_max=1024, dtype=torch.bfloat16, store=None, **kw):
    """One wrapper call through the stand-in library over a zero cache of 4
    slots; returns the wrapper's output."""
    q = torch.zeros(t, kv, g, d, dtype=dtype)
    sc = {}
    if store is None:
        k = torch.zeros(4, s_max, kv, d, dtype=dtype)
    else:
        k = torch.zeros(4, s_max, kv, d, dtype=store)
        sc = dict(k_scale=torch.ones(4, s_max, kv), v_scale=torch.ones(4, s_max, kv))
    ts, tp = torch.zeros(t, dtype=torch.int32), torch.zeros(t, dtype=torch.int32)
    return rk.ragged_attention(q, k, k, ts, tp, **sc, **kw)


@pytest.mark.parametrize("t,kv,g,store,kw,want", [
    # (tokens a tile, span, splits): phase 4's 64-token pack at 32 heads: 8
    # tiles of 8, 256 blocks, one an SM of 132 at least: one span
    (64, 32, 1, None, {}, (8, 1024, 1)),
    (64, 32, 1, torch.int8, {}, (8, 1024, 1)),  # phase 5 (c): the same tiles
    (64, 8, 4, None, {}, (2, 1024, 1)),  # 32 tiles of 2 tokens
    (64, 8, 8, torch.float8_e4m3fn, {}, (1, 1024, 1)),  # a group chunk of 8: one token
    (8, 32, 1, None, {}, (8, 256, 4)),  # 32 blocks: every span of 256 a split
    # f32 queries over int8 rows: one token a tile (ragged_attention.one_token_tiles)
    (64, 32, 1, torch.int8, dict(dtype=torch.float32), (1, 1024, 1)),
    (64, 32, 1, None, dict(splits=2), (8, 512, 2)),
    (8, 32, 1, None, dict(splits=3), (8, 512, 2)),  # asked for 3: spans of 512, so 2
    (512, 32, 1, None, {}, (8, 1024, 1)),  # 2048 blocks fill the waves alone
])
def test_ragged_wrapper_tile_span_and_scratch_from_host_values(fake_c, t, kv, g, store, kw,
                                                               want):
    n0 = (rk.launches, rk.launches_q8, rk.launches_split)
    _call(t, kv, g, store=store, window=7, **kw)
    assert (rk.launches, rk.launches_q8, rk.launches_split) == (
        n0[0] + (store is None), n0[1] + (store is not None), n0[2] + 1)
    tt, span, n_splits = want
    q_dtype = kw.get("dtype", torch.bfloat16)
    one_token = rk.one_token_tiles(q_dtype, store or q_dtype)
    assert rk.plan(1024, t, kv, g, 132, one_token, kw.get("splits")) == want
    (name, args), = fake_c
    # (q, k, v, ks, vs, tok_slot, tok_pos, ws, counters, out, T, S, KV, G, D, window, span,
    #  tile_tokens, qdtype, sdtype, stream)
    assert name == "repro_ragged_attention"
    assert args[10:18] == (t, 1024, kv, g, 64, 7, span, 1 if one_token else 0)
    assert (args[3] is not None) == (store is not None)
    assert (args[7] is not None, args[8] is not None) == (n_splits > 1,) * 2
    if n_splits > 1:  # the stream's ticket counters
        assert args[8] == _checks.tickets(torch.device("cpu"), 0).data_ptr()
    assert tt == pk.tile_tokens(g, one_token)


@pytest.mark.parametrize("kv,g", [(32, 1), (8, 8)])
def test_every_engine_bucket_launches(fake_c, kv, g):
    """Every T bucket of the engine's packs (8 to 128, then doubling), and a
    pack past the ticket counters, launches without raising; past them the
    launch takes one split, and only a forced count raises."""
    for t in (8, 16, 24, 32, 48, 64, 96, 128, 256, 512):
        _call(t, kv, g, d=16)
    assert [a[10] for _, a in fake_c] == [8, 16, 24, 32, 48, 64, 96, 128, 256, 512]
    fake_c.clear()
    # f32 queries over int8 rows: one token a tile
    big = -(-_checks.TICKETS // (kv * -(-g // dk.group_chunk(g)))) + 1
    _call(big, kv, g, d=16, dtype=torch.float32, store=torch.int8)
    (_, args), = fake_c
    assert args[16] == 1024 and args[17] == 1 and args[7] is None  # one split, no scratch
    with pytest.raises(ValueError, match="split launch"):
        _call(big, kv, g, d=16, dtype=torch.float32, store=torch.int8, splits=2)
    with pytest.raises(ValueError, match="splits"):
        _call(8, kv, g, d=16, splits=0)


def test_empty_packs_make_no_call(fake_c):
    """A pack of no token returns at once, ragged and paged alike, with no C
    call and no launch counted."""
    n0 = (rk.launches_split, pk.launches_split_pack)
    assert _call(0, 4, 1).shape == (0, 4, 1, 64)
    q = torch.zeros(0, 4, 1, 64)
    k = torch.zeros(8, 16, 4, 64)
    i32 = torch.zeros(0, dtype=torch.int32)
    assert pk.paged_attention(q, k, k, i32, i32, torch.zeros(2, 4, dtype=torch.int32)).shape == \
        q.shape
    assert (rk.launches_split, pk.launches_split_pack) == n0 and not fake_c


# ----------------------------------------------------------------------- CUDA


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dense_case(dev, seed, b, s_max, kv, d, store, dtype):
    gen = torch.Generator(device=dev).manual_seed(seed)
    k, v = (torch.randn(b, s_max, kv, d, generator=gen, device=dev) for _ in "kv")
    if store == "plain":
        return k.to(dtype), v.to(dtype), {}, gen
    (k, ks), (v, vs) = quantize_rows(k, STORES[store]), quantize_rows(v, STORES[store])
    return k, v, dict(k_scale=ks, v_scale=vs), gen


def _check(got, want, tp, s_max, dtype):
    real = tp < s_max
    assert not got[~real].any(), "padding rows must be zero"
    err = (got[real].float() - want[real].float()).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err


def _ints(xs, dev):
    return torch.tensor(xs, dtype=torch.int32, device=dev)


# chip_smoke.py's serving pack: 40 prompt tokens of slot 1, 16 of slot 3 at
# 600-615 and 8 padding tokens riding slot 1, over 4 slots of 1024 positions
SERVE_SLOT = [1] * 40 + [3] * 16 + [1] * 8
SERVE_POS = list(range(0, 40)) + list(range(600, 616)) + [1024] * 8


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["plain", "int8"])
@pytest.mark.parametrize("splits", [None, 1, 2, 4])
def test_cuda_ragged_serving_shape(store, splits):
    dev = _cuda()
    k, v, sc, gen = _dense_case(dev, 7, 4, 1024, 32, 128, store, torch.bfloat16)
    ts, tp = _ints(SERVE_SLOT, dev), _ints(SERVE_POS, dev)
    q = torch.randn(64, 32, 1, 128, generator=gen, device=dev).to(torch.bfloat16)
    n0 = rk.launches_split
    got = rk.ragged_attention(q, k, v, ts, tp, splits=splits, **sc)
    assert rk.launches_split == n0 + 1
    _check(got, ref.ragged_attention(q, k, v, ts, tp, **sc), tp, 1024, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", _checks.HEAD_DIMS)
def test_cuda_ragged_domain(d):
    """G 1/4/8/12 at head width d over bf16 and int8 stores under bf16
    queries and a plain f32 store, with and without a window: a pack whose
    tiles span two slots, with padding, against the plain version."""
    dev = _cuda()
    slot = [0] * 13 + [2] * 6 + [1] * 9 + [0] * 3
    pos = list(range(300, 313)) + list(range(100, 106)) + list(range(0, 9)) + [320] * 3
    ts, tp = _ints(slot, dev), _ints(pos, dev)
    for store, dtype in (("plain", torch.bfloat16), ("int8", torch.bfloat16),
                         ("plain", torch.float32)):
        for g in (1, 4, 8, 12):
            k, v, sc, gen = _dense_case(dev, d + g, 3, 320, 2, d, store, dtype)
            q = torch.randn(len(slot), 2, g, d, generator=gen, device=dev).to(dtype)
            for window in (0, 40):
                got = rk.ragged_attention(q, k, v, ts, tp, window=window, splits=2, **sc)
                want = ref.ragged_attention(q, k, v, ts, tp, window=window, **sc)
                _check(got, want, tp, 320, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("store,dtype", [("plain", torch.bfloat16), ("fp8", torch.bfloat16),
                                         ("int8", torch.float32)])
def test_cuda_ragged_singletons_and_offset_views(store, dtype):
    """A pack of one token from each of 8 slots, over offset views of the
    cache and the queries (a slice past the first slot): pack tiles over bf16
    queries, one token a tile for f32 queries over int8 rows."""
    dev = _cuda()
    k, v, sc, gen = _dense_case(dev, 3, 9, 512, 4, 64, store, dtype)
    k, v = k[1:], v[1:]
    sc = {n: s[1:] for n, s in sc.items()}
    assert k.storage_offset() > 0
    ts, tp = _ints(list(range(8)), dev), _ints([511, 0, 255, 256, 17, 300, 5, 480], dev)
    q = torch.randn(9, 4, 4, 64, generator=gen, device=dev).to(dtype)[1:]
    got = rk.ragged_attention(q, k, v, ts, tp, window=100, **sc)
    _check(got, ref.ragged_attention(q, k, v, ts, tp, window=100, **sc), tp, 512, dtype)


@pytest.mark.cuda
def test_cuda_graph_replays_ragged_bitwise():
    """The serving pack over bf16 and int8 caches, at the kernel's own
    split and at four, captured in one CUDA graph and replayed: bitwise the
    eager results, twice."""
    dev = _cuda()
    k, v, _, gen = _dense_case(dev, 8, 4, 1024, 32, 128, "plain", torch.bfloat16)
    k8, v8, sc, _ = _dense_case(dev, 9, 4, 1024, 32, 128, "int8", torch.bfloat16)
    ts, tp = _ints(SERVE_SLOT, dev), _ints(SERVE_POS, dev)
    q = torch.randn(64, 32, 1, 128, generator=gen, device=dev).to(torch.bfloat16)

    def step():
        return (rk.ragged_attention(q, k, v, ts, tp),
                rk.ragged_attention(q, k8, v8, ts, tp, splits=4, **sc))

    eager = step()
    torch.cuda.synchronize()
    n0 = rk.launches_split
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    assert rk.launches_split == n0 + 2
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)
