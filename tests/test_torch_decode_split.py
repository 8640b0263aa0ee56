"""The two decode-step kernel bodies redesigned for Hopper: split-KV decode
attention with an ordered merge (``csrc/decode_attention.cu``) and the
tensor-core decode GEMV for int8 and bf16 weights (``csrc/matmul.cu``'s
``gemv_tc``).

CPU (runs anywhere):
- ``ref.decode_attention_split`` (the split body's arithmetic: per-span
  partials (m, l, acc) with the row scales folded in, merged in span order)
  against ``repro.kernels.ops.decode_attention(mode="interpret",
  block_s=8)`` and the JAX oracle, at f32 and bf16 queries, plain, int8 and
  fp8 stores, a window, cur_len 0, mid-span and full, spans past the live
  range, G 1, 4 and 5 and D 16 and 128. Tolerance: 2e-5 absolute at f32
  (``tests/test_torch_kernels.py``: f32 softmax over <= 40 keys, summation
  order only) and 2e-2 at a bf16 output (one bf16 rounding of an f32 result,
  ``tests/test_torch_ops.py``).
- ``ref.matmul_slices`` (the split GEMVs' slice-ordered sum, scaled once)
  against ``repro.kernels.ops.matmul_q8`` / ``matmul`` in interpret mode and
  ``ref.matmul_q8``: 2e-4 of max |output| at f32, ``tests/test_torch_gemm.py``'s.
- The int8 -> bf16 bit recipe of the GEMV, exact over all 256 bytes.
- The GEMV's fragment recipe emulated lane by lane (``mma.sync.m16n8k16``'s
  fragment layouts): it computes the tile product, and its swizzled loads
  are free of shared-memory bank conflicts.
- The split count and span from host values, and what the wrappers hand
  the C library (a stand-in library records the calls).

CUDA (``-m cuda``, skipped without a card): each body against its plain
version at the serving shapes, at forced splits, over the whole (D, G)
domain, on offset views and with cur_len past S_max; launches counted on
the right body; both bodies captured in one CUDA graph and replayed, bitwise
equal to eager. Tolerances are ``chip_smoke.py``'s: 1e-4 (f32) and 2e-2
(bf16) absolute for attention, 1e-2 of max |plain| for the bf16 GEMV.
"""

import numpy as np
import pytest
import torch

from repro_torch.dist.compression import quantize_rows
from repro_torch.kernels import _build, _checks, ref
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import matmul as mmk

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MATMUL_TOL = 2e-4
STORES = {"plain": None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.ref, repro.kernels.ops)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jref, jops


def _jax(jnp, t: torch.Tensor):
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _cache(rng, store, dtype, *shape):
    """K and V of ``shape`` in the model dtype, or quantized rows with scales."""
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in "kv")
    if STORES[store] is None:
        return k.to(dtype), v.to(dtype), {}
    (k, ks), (v, vs) = quantize_rows(k, STORES[store]), quantize_rows(v, STORES[store])
    return k, v, dict(k_scale=ks, v_scale=vs)


# ------------------------------------------------- split decode vs the JAX package


@pytest.mark.parametrize("dtype,store,kv,g,d,window,cur,splits", [
    ("float32", "plain", 2, 1, 16, 0, (0, 13, 39), 5),  # spans past slot 0's one key
    ("float32", "plain", 1, 4, 16, 7, (3, 20, 39), 3),  # a window
    ("float32", "plain", 1, 5, 128, 0, (0, 8, 39), 2),
    ("bfloat16", "plain", 2, 4, 128, 0, (5, 31, 39), 4),
    ("float32", "int8", 2, 5, 16, 0, (0, 13, 39), 5),
    ("float32", "fp8", 1, 4, 128, 9, (7, 22, 39), 3),
    ("bfloat16", "int8", 2, 1, 128, 0, (0, 17, 39), 1),
    ("float32", "fp8", 2, 1, 16, 0, (12, 4, 39), 8),  # more splits asked than spans
])
def test_split_plain_vs_jax(jx, dtype, store, kv, g, d, window, cur, splits):
    jnp, jref, jops = jx
    rng = np.random.default_rng(kv * 100 + g * 10 + d)
    b, s_max = len(cur), 40
    tdt = getattr(torch, dtype)
    k, v, sc = _cache(rng, store, tdt, b, s_max, kv, d)
    q = torch.from_numpy(rng.standard_normal((b, kv, g, d)).astype(np.float32)).to(tdt)
    cl = torch.tensor(cur, dtype=torch.int32)
    got = ref.decode_attention_split(q, k, v, cl, splits, window=window, block_s=8, **sc)
    assert got.dtype == tdt and got.shape == q.shape
    jargs = [_jax(jnp, t) for t in (q.reshape(b, kv * g, d), k, v, cl)]
    jsc = {n: _jax(jnp, t) for n, t in sc.items()}
    want = jops.decode_attention(*jargs, window=window, mode="interpret", block_s=8, **jsc)
    oracle = jops.decode_attention(*jargs, window=window, mode="ref", **jsc)
    for w in (want, oracle):
        np.testing.assert_allclose(got.float().reshape(b, kv * g, d).numpy(),
                                   np.asarray(w, np.float32), atol=TOL[dtype], rtol=0)
    if store == "plain":
        np.testing.assert_allclose(
            got.float().numpy(), ref.decode_attention(q, k, v, cl, window=window).float().numpy(),
            atol=TOL[dtype], rtol=0)


def test_split_with_no_valid_key_writes_zeros():
    """A slot whose range is empty in every span (cur_len past the cache
    with a window that ends before it) gets zeros, as the kernel writes;
    the other slots match the one-pass plain version."""
    rng = np.random.default_rng(7)
    k, v, _ = _cache(rng, "plain", torch.float32, 3, 40, 2, 16)
    q = torch.from_numpy(rng.standard_normal((3, 2, 4, 16)).astype(np.float32))
    cl = torch.tensor([10, 60, 39], dtype=torch.int32)
    got = ref.decode_attention_split(q, k, v, cl, 3, window=5, block_s=8)
    assert not got[1].any()
    want = ref.decode_attention(q, k, v, cl, window=5)
    torch.testing.assert_close(got[[0, 2]], want[[0, 2]], atol=TOL["float32"], rtol=0)


@pytest.mark.parametrize("s_max,splits,want", [
    (1024, 4, (256, 4)), (1024, 3, (512, 2)), (1024, 1, (1024, 1)), (300, 2, (256, 2)),
    (96, 8, (256, 1)), (0, 1, (256, 1)), (32768, 43, (768, 43)), (32768, 33, (1024, 32)),
])
def test_split_span(s_max, splits, want):
    assert dk.split_span(s_max, splits) == want


@pytest.mark.parametrize("s_max,b,kv,g,sms,want", [
    (1024, 4, 32, 1, 132, 4),  # phase 4's decode: 128 blocks -> 512
    (1024, 4, 32, 16, 132, 2),  # two chunks of the group: 256 blocks -> 512
    (1024, 8, 8, 8, 132, 4),  # 64 blocks: every 256-position span
    (1024, 16, 32, 1, 132, 1),  # 512 blocks fill two waves alone
    (96, 4, 4, 1, 132, 1),  # the reduced configs: one span holds the slot
    (0, 4, 32, 1, 132, 1),
    (32768, 1, 8, 8, 132, 43),  # a long slot: the first span count to fill 264
    (1024, 4, 32, 1, 66, 2),
])
def test_split_count_fills_two_waves(s_max, b, kv, g, sms, want):
    got = dk.split_count(s_max, b, kv, g, sms)
    assert got == want
    blocks = b * kv * -(-g // dk.group_chunk(g))
    span, eff = dk.split_span(s_max, got)
    assert eff == got and span % dk.BLOCK_S == 0
    assert blocks * got >= dk.WAVES * sms or span == dk.BLOCK_S or got == 1
    if got > 1:  # the fewest: one split fewer does not fill the waves
        assert blocks * dk.split_span(s_max, got - 1)[1] < dk.WAVES * sms


# ------------------------------------------------ the GEMV's arithmetic, plain


@pytest.mark.parametrize("rows", [16, 32, 64, 96])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_matmul_slices_vs_jax(jx, m, rows):
    """The slice-ordered sum of split-K partials, scaled once, against the
    Pallas bodies in interpret mode and the oracles, int8 and f32 weights."""
    jnp, jref, jops = jx
    from repro_torch.models.quant import quantize_leaf

    rng = np.random.default_rng(m * rows)
    a = torch.from_numpy(rng.standard_normal((m, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 48)).astype(np.float32))
    leaf = quantize_leaf(w[None], (1,))
    q8, scale = leaf["q8"][0], leaf["scale"][0].reshape(48)
    got = ref.matmul_slices(a, q8, scale, rows)
    ja, jq, js = jnp.asarray(a.numpy()), jnp.asarray(q8.numpy()), jnp.asarray(scale.numpy())
    for want in (jops.matmul_q8(ja, jq, js, mode="interpret", block=32),
                 jref.matmul_q8(ja, jq, js), ref.matmul_q8(a, q8, scale)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=MATMUL_TOL * np.abs(want).max())
    got = ref.matmul_slices(a, w, None, rows)
    want = np.asarray(jops.matmul(ja, jnp.asarray(w.numpy()), mode="interpret", block=32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MATMUL_TOL * np.abs(want).max())


def test_int8_bf16_bits_exact_over_all_bytes():
    x = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    got = ref.int8_bf16_bits(x)
    assert torch.equal(got, x.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(got.view(torch.bfloat16).float(), x.float())


def _mma_16816(a_regs, b_regs):
    """mma.sync.m16n8k16 over one warp's fragments, as PTX lays them out:
    a_regs [32][4] pairs (rows g / g + 8, columns 2t, 2t + 1 / + 8), b_regs
    [32][2] pairs (rows 2t, 2t + 1 / + 8, column g). Returns each lane's
    four accumulators (row g / g + 8, columns 2t, 2t + 1)."""
    a, b = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, (r, c) in enumerate([(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                      (g + 8, 2 * t + 8)]):
            a[r, c], a[r, c + 1] = a_regs[lane][reg]
        for reg, r in enumerate([2 * t, 2 * t + 8]):
            b[r, g], b[r + 1, g] = b_regs[lane][reg]
    d = a @ b
    return [(d[lane >> 2, 2 * (lane & 3)], d[lane >> 2, 2 * (lane & 3) + 1],
             d[(lane >> 2) + 8, 2 * (lane & 3)], d[(lane >> 2) + 8, 2 * (lane & 3) + 1])
            for lane in range(32)]


def _ldmatrix(smem, rows, trans):
    """ldmatrix.m8n8.b16 from the byte array ``smem``: rows[j][i] is the
    address of row i (16 bytes) of matrix j. Returns each lane's registers
    as 4 bytes each, [32][len(rows)][4], and checks that each matrix's eight
    rows fall in 32 different banks."""
    regs = np.zeros((32, len(rows), 4), np.uint8)
    for j, addrs in enumerate(rows):
        banks = {(a // 4 + w) % 32 for a in addrs for w in range(4)}
        assert len(banks) == 32, f"bank conflict in matrix {j}"
        mat = np.stack([smem[a:a + 16] for a in addrs])  # [8][16 bytes]: 8 x 8 b16
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            if trans:  # b16 (2t, g) low, (2t + 1, g) high
                regs[lane, j] = np.concatenate([mat[2 * t, 2 * g:2 * g + 2],
                                                mat[2 * t + 1, 2 * g:2 * g + 2]])
            else:  # b16 (g, 2t) low, (g, 2t + 1) high
                regs[lane, j] = mat[g, 4 * t:4 * t + 4]
    return regs


@pytest.mark.parametrize("elem", [1, 2])  # int8 or bf16 weights
def test_gemv_tc_fragments_compute_the_panel_product(elem):
    """One K step of csrc/matmul.cu's gemv_tc_kernel, lane by lane: the
    weight panel (an 8 KB step of 128 columns: 64 int8 or 32 bf16 rows,
    row-major, chunk c of row r at c ^ (r & 7)) and the tokens' slice
    ([8][KS + 8] bf16) staged as the kernel stages them, each warp's
    fragments taken by ldmatrix as tc_fragments takes them (int8: even and
    odd bytes of each .trans register are the pairs of columns 2g and 2g +
    1), two mmas a 16-row step, the accumulators placed by tc_col. The
    block's 8 x 128 output is the panel product, and no ldmatrix meets a
    bank conflict. Integer-valued data, so every product is exact."""
    ks, cols = 8192 // (128 * elem), 128  # an 8 KB step: 64 int8 or 32 bf16 rows
    a_row = ks + 8
    rng = np.random.default_rng(elem)
    w = rng.integers(-128, 128, (ks, cols))
    x = rng.integers(-50, 50, (8, ks))
    dt = np.int8 if elem == 1 else np.int16
    row_bytes = cols * elem
    panel = np.zeros(ks * row_bytes, np.uint8)
    for r in range(ks):
        raw = w[r].astype(dt).view(np.uint8)
        for c in range(row_bytes // 16):
            dst = r * row_bytes + ((c ^ (r & 7)) << 4)
            panel[dst:dst + 16] = raw[16 * c:16 * c + 16]
    sa = np.zeros((8, a_row), np.int16)
    sa[:, :ks] = x
    sa = sa.reshape(-1).view(np.uint8)

    def pair(reg, lo, hi):  # two elements of a register's bytes
        v = reg.view(np.int8) if elem == 1 else reg.view(np.int16)
        return (float(v[lo]), float(v[hi])) if elem == 1 else (float(v[0]), float(v[1]))

    out = np.zeros((8, cols))
    for warp in range(4):
        acc = [np.zeros((32, 4)), np.zeros((32, 4))]
        for kk in range(0, ks, 16):
            b = _ldmatrix(sa, [[i * a_row * 2 + (kk + 8 * j) * 2 for i in range(8)]
                               for j in range(2)], trans=False)
            bfr = [[tuple(float(v) for v in b[lane, j].view(np.int16)) for j in range(2)]
                   for lane in range(32)]
            if elem == 1:
                rows = [[(kk + 8 * (j & 1) + i) * row_bytes
                         + (((2 * warp + (j >> 1)) ^ ((kk + 8 * (j & 1) + i) & 7)) << 4)
                         for i in range(8)] for j in range(4)]
                r = _ldmatrix(panel, rows, trans=True)
                frags = [[[pair(r[lane, 2 * q], 0, 2), pair(r[lane, 2 * q], 1, 3),
                           pair(r[lane, 2 * q + 1], 0, 2), pair(r[lane, 2 * q + 1], 1, 3)]
                          for lane in range(32)] for q in range(2)]
            else:
                frags = []
                for q in range(2):
                    rows = [[(kk + 8 * (j >> 1) + i) * row_bytes
                             + (((4 * warp + 2 * q + (j & 1)) ^ ((kk + 8 * (j >> 1) + i) & 7))
                                << 4) for i in range(8)] for j in range(4)]
                    r = _ldmatrix(panel, rows, trans=True)
                    frags.append([[pair(r[lane, j], 0, 1) for j in range(4)]
                                  for lane in range(32)])
            for q in range(2):
                acc[q] += np.asarray(_mma_16816(frags[q], bfr))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for q in range(2):
                for e in range(4):
                    half = e >> 1
                    col = 16 * q + (2 * g + half if elem == 1 else 8 * half + g)
                    out[2 * t + (e & 1), 32 * warp + col] = acc[q][lane, e]
    np.testing.assert_array_equal(out, x @ w)


# ------------------------------------------- what the wrappers hand the C library


@pytest.fixture
def fake_c(monkeypatch):
    """CPU tensors pass the device checks, and every C entry point returns 0
    without touching memory; each call is recorded as (name, args)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_checks, "cuda_operands", lambda *a: None)
    monkeypatch.setattr(_checks, "aligned_rows", lambda *a: None)
    monkeypatch.setattr(_checks, "stream", lambda t: 0)
    monkeypatch.setattr(_checks, "_tickets", {})
    monkeypatch.setattr(_build, "load", Lib)
    return calls


@pytest.mark.parametrize("splits,want_span,scratch", [(1, 1024, False), (4, 256, True),
                                                      (3, 512, True)])
def test_decode_wrapper_passes_span_and_scratch(fake_c, splits, want_span, scratch):
    q = torch.zeros(4, 2, 1, 64, dtype=torch.bfloat16)
    k = torch.zeros(4, 1024, 2, 64, dtype=torch.bfloat16)
    cl = torch.zeros(4, dtype=torch.int32)
    n0 = (dk.launches, dk.launches_q8, dk.launches_split)
    dk.decode_attention(q, k, k, cl, splits=splits)
    assert (dk.launches, dk.launches_q8, dk.launches_split) == (n0[0] + 1, n0[1], n0[2] + 1)
    (name, args), = fake_c
    # (q, k, v, k_scale, v_scale, cur_len, ws, counters, out, B, S, KV, G, D, window, span, ...)
    assert name == "repro_decode_attention" and args[9:16] == (4, 1024, 2, 1, 64, 0, want_span)
    assert (args[6] is not None, args[7] is not None) == (scratch, scratch)
    with pytest.raises(ValueError, match="splits"):
        dk.decode_attention(q, k, k, cl, splits=0)


@pytest.mark.parametrize("m,a_dt,b_dt,body", [
    (4, torch.bfloat16, torch.int8, "gemv_tc"), (1, torch.bfloat16, torch.bfloat16, "gemv_tc"),
    (8, torch.float32, torch.int8, "gemv"),
])
def test_matmul_wrapper_launches_the_routed_gemv(fake_c, m, a_dt, b_dt, body):
    a = torch.zeros(m, 4096, dtype=a_dt)
    b = torch.zeros(4096, 4096, dtype=b_dt)
    n0 = getattr(mmk, f"launches_{body}")
    if b_dt == torch.int8:
        mmk.matmul_q8(a, b, torch.ones(4096))
    else:
        mmk.matmul(a, b)
    assert getattr(mmk, f"launches_{body}") == n0 + 1
    names = [name for name, _ in fake_c]
    assert names == ["repro_matmul_workspace", "repro_matmul"]
    # workspace: (M, K, N, route, split_k, block_n, bdtype)
    assert fake_c[0][1] == (m, 4096, 4096, mmk.ROUTES.index(body), 0, 0,
                            _checks.DTYPE_CODES[b_dt])
    assert fake_c[1][1][4] is not None  # the GEMVs' ticket counters
    mmk._workspace_elems.cache_clear()


# ----------------------------------------------------------------------- CUDA


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


SERVE_POS = (0, 333, 700, 1023)  # chip_smoke.DECODE_POS: an empty prefix to a full slot


def _decode_inputs(dev, seed, b, s_max, kv, g, d, store, dtype, cur):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, kv, g, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, s_max, kv, d, generator=gen, device=dev) for _ in "kv")
    if store == "plain":
        k, v, sc = k.to(dtype), v.to(dtype), {}
    else:
        (k, ks), (v, vs) = quantize_rows(k, STORES[store]), quantize_rows(v, STORES[store])
        sc = dict(k_scale=ks, v_scale=vs)
    return q, k, v, torch.tensor(cur, dtype=torch.int32, device=dev), sc


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("store,dtype", [("plain", torch.bfloat16), ("int8", torch.bfloat16),
                                         ("fp8", torch.float32), ("plain", torch.float32)])
def test_cuda_split_decode_serving_shape(store, dtype, splits):
    """Phase 4's shape (4 slots x 1024 positions, 32 KV heads, G 1, D 128)
    at the kernel's own and forced splits; every launch on the split body."""
    dev = _cuda()
    q, k, v, cl, sc = _decode_inputs(dev, 0, 4, 1024, 32, 1, 128, store, dtype, SERVE_POS)
    n0 = (dk.launches_split, dk.launches_q8 if sc else dk.launches)
    got = dk.decode_attention(q, k, v, cl, splits=splits, **sc)
    assert (dk.launches_split, dk.launches_q8 if sc else dk.launches) == (n0[0] + 1, n0[1] + 1)
    want = ref.decode_attention(q, k, v, cl, **sc)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _kernel_tol(dtype)
    split = ref.decode_attention_split(q, k, v, cl, splits or 4, **sc)
    assert (got.float() - split.float()).abs().max().item() <= _kernel_tol(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", _checks.HEAD_DIMS)
def test_cuda_split_decode_whole_domain(d):
    """Every group 1..16 at head width d over bf16 and int8 stores, split
    over 300 positions (two spans), with a window on odd groups and one
    slot's cur_len past S_max (the whole slot)."""
    dev = _cuda()
    for g in range(1, _checks.MAX_GROUP + 1):
        for store in ("plain", "int8"):
            window = 37 if g % 2 else 0
            q, k, v, cl, sc = _decode_inputs(dev, g, 3, 300, 2, g, d, store, torch.bfloat16,
                                             (0, 299, 400))
            for splits in (1, 2):
                got = dk.decode_attention(q, k, v, cl, window=window, splits=splits, **sc)
                want = ref.decode_attention_split(q, k, v, cl, splits, window=window, **sc)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                assert err <= 2e-2, (d, g, store, splits, err)


@pytest.mark.cuda
def test_cuda_split_decode_offset_views_and_past_the_cache():
    """q, k, v and the scales as views at an offset into larger buffers, and
    every slot's cur_len past S_max: the whole slot is valid."""
    dev = _cuda()
    q, k, v, cl, sc = _decode_inputs(dev, 3, 5, 640, 4, 4, 128, "int8", torch.bfloat16,
                                     (700, 640, 5000, 639, 1000))
    qv, kv_, vv = q[1:], k[1:], v[1:]
    scv = {n: t[1:] for n, t in sc.items()}
    assert qv.storage_offset() and kv_.storage_offset()
    got = dk.decode_attention(qv, kv_, vv, cl[1:], **scv)
    want = ref.decode_attention(qv, kv_, vv, cl[1:], **scv)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def _gemv_operands(dev, seed, m, k, n, b_dtype):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(m + 1, k, generator=gen, device=dev).to(torch.bfloat16)[1:]  # an offset view
    w = torch.randn(k, n, generator=gen, device=dev)
    if b_dtype == torch.int8:
        from repro_torch.models.quant import quantize_leaf

        leaf = quantize_leaf(w[None], (1,))
        return a, leaf["q8"][0], leaf["scale"][0].reshape(n)
    return a, w.to(torch.bfloat16), None


@pytest.mark.cuda
@pytest.mark.parametrize("split_k", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("kn", [(4096, 13440), (13440, 4096), (4096, 4096), (4096, 48)])
@pytest.mark.parametrize("b_dtype", [torch.int8, torch.bfloat16])
def test_cuda_gemv_tc_vs_plain(b_dtype, kn, split_k):
    """M 1, 4 and 8 over the serving widths (and a 48-column tail strip), on
    the tensor-core GEMV at the kernel's own and forced K splits; the
    offset view of a as the activations."""
    dev = _cuda()
    k, n = kn
    for m in (1, 4, 8):
        a, b, scale = _gemv_operands(dev, m + split_k, m, k, n, b_dtype)
        assert a.storage_offset() and mmk.route(m, k, n, a.dtype, b.dtype) == "gemv_tc"
        n0 = mmk.launches_gemv_tc
        if scale is None:
            got, want = mmk.matmul(a, b, split_k=split_k), ref.matmul(a, b)
        else:
            got, want = mmk.matmul_q8(a, b, scale, split_k=split_k), ref.matmul_q8(a, b, scale)
        assert mmk.launches_gemv_tc == n0 + 1
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item(), (m, kn, split_k, err)


@pytest.mark.cuda
def test_cuda_gemv_keeps_f32_and_tails_on_cuda_cores():
    dev = _cuda()
    for m, k, n, a_dt in [(4, 4096, 4096, torch.float32), (4, 4100, 4104, torch.bfloat16),
                          (8, 4096, 4104, torch.bfloat16)]:
        a, b, scale = _gemv_operands(dev, m, m, k, n, torch.int8)
        a = a.to(a_dt).clone()  # aligned: the offset view of a K-tail row is not
        n0 = (mmk.launches_gemv, mmk.launches_gemv_tc)
        got = mmk.matmul_q8(a, b, scale)
        assert (mmk.launches_gemv, mmk.launches_gemv_tc) == (n0[0] + 1, n0[1])
        want = ref.matmul_q8(a, b, scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item()


@pytest.mark.cuda
def test_cuda_graph_replays_both_bodies_bitwise():
    """A decode step's two new bodies (split decode over bf16 and int8
    stores, the int8 and bf16 tensor-core GEMVs, each split) captured in one
    CUDA graph and replayed: bitwise the eager results, twice."""
    dev = _cuda()
    q, k, v, cl, _ = _decode_inputs(dev, 5, 4, 1024, 32, 1, 128, "plain", torch.bfloat16,
                                    SERVE_POS)
    _, k8, v8, _, sc = _decode_inputs(dev, 6, 4, 1024, 32, 1, 128, "int8", torch.bfloat16,
                                      SERVE_POS)
    a, q8, scale = _gemv_operands(dev, 7, 4, 4096, 13440, torch.int8)
    _, wb, _ = _gemv_operands(dev, 8, 4, 13440, 4096, torch.bfloat16)
    ab = torch.randn(4, 13440, device=dev).to(torch.bfloat16)

    def step():
        return (dk.decode_attention(q, k, v, cl), dk.decode_attention(q, k8, v8, cl, **sc),
                mmk.matmul_q8(a, q8, scale), mmk.matmul(ab, wb))

    assert dk.split_count(1024, 4, 32, 1, dk._sms(dev.index)) > 1
    eager = step()
    torch.cuda.synchronize()
    n0 = (dk.launches_split, mmk.launches_gemv_tc)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    assert (dk.launches_split, mmk.launches_gemv_tc) == (n0[0] + 2, n0[1] + 2)
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)
