"""The int8-weight product at 9-64 rows and paged attention, redesigned for
Hopper: the multi-row tensor-core GEMV (``csrc/matmul.cu``'s
``gemv_tc_rows``: ``gemv_tc_kernel`` staging 16, 32 or 64 tokens) and the
split-KV paged body (``csrc/split_attention.cuh`` under
``csrc/paged_attention.cu``'s table policy: decode one token a tile, a
pack's tokens sharing their K/V stages).

CPU (runs anywhere):
- The multi-row GEMV's fragments emulated lane by lane (ldmatrix and
  ``mma.sync.m16n8k16`` as PTX lays them out, the helpers of
  ``tests/test_torch_decode_split.py``): at MR 16, 32 and 64 over int8 and
  bf16 weights a whole launch (two strips of 128 columns, two K steps), its
  activation fragments from ldmatrix.x4 pairs, the weight fragment widened
  once and fed to every token tile; exact on integer data, and within
  2e-4 of max |output| (``tests/test_torch_gemm.py``'s f32 tolerance) of
  ``ref.matmul_q8`` / ``ref.matmul`` and of the JAX package's
  ``ops.matmul_q8`` / ``ops.matmul`` in interpret mode at bf16 activations,
  no ldmatrix meeting a bank conflict.
- ``ref.paged_attention_split`` (the split body's arithmetic: per-span
  partials merged in span order) against the JAX package's
  ``ops.paged_ragged_attention`` in ``interpret`` and ``ref`` modes and the
  port's ``ref.paged_ragged_attention``, over f32/bf16 queries, plain, int8
  and fp8 pools, G 1/4/8, windows, padding tokens, sentinel entries and a
  tile spanning two sequences. Tolerance: 2e-5 absolute at f32 (softmax over
  <= 40 keys, summation order only) and 2e-2 at a bf16 output (one bf16
  rounding of an f32 result), as ``tests/test_torch_decode_split.py``.
- What the wrappers hand the C library (a stand-in records the calls): the
  tile, the span and the scratch come from host values only.

CUDA (``-m cuda``, skipped without a card): each body against its plain
version at the serving shapes and the domain's edges (and a paged pack of a
prompt's first 40 tokens over fp8 rows, within 2e-2 since P's remainder
rides a second mma), and both bodies
captured in one CUDA graph and replayed, bitwise equal to eager. Tolerances
are ``chip_smoke.py``'s: 1e-2 of max |plain| for the matmul, 1e-4 (f32) and
2e-2 (bf16) absolute for attention.
"""

import numpy as np
import pytest
import torch

from repro_torch.dist.compression import quantize_rows
from repro_torch.kernels import _build, _checks, ops, ref
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import paged_attention as pk
from test_torch_decode_split import _ldmatrix, _mma_16816

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


# ------------------------------------------- the multi-row GEMV, lane by lane


def _gemv_tc_emulated(x: np.ndarray, w: np.ndarray, elem: int, mr: int) -> np.ndarray:
    """csrc/matmul.cu's gemv_tc_kernel at MR token rows, one K split, lane by
    lane: x [M, K] (M <= mr) and w [K, N] of values that bf16 holds
    exactly (w int8 at elem 1, bf16 at elem 2), K a multiple of the step's
    KS rows and N of 128. Each block (a strip of 128 columns) stages a step's
    weight panel (row-major, chunk c of row r at c ^ (r & 7)) and the tokens'
    slice ([mr][KS + 8] bf16, rows past M zero) as the kernel stages them;
    each warp takes its weight fragments by ldmatrix .trans as tc_fragments
    does (int8: even and odd bytes of a register are columns 2g and 2g + 1),
    its token fragments as tc_token_fragments does (ldmatrix.x2 at one token
    tile, ldmatrix.x4 pairs past it), two mmas a token tile a 16-row step,
    the accumulators placed by tc_col at token 8j + 2t (+ 1). Returns the
    f64 sum of the products [M, N]; asserts no ldmatrix meets a bank
    conflict."""
    m, k = x.shape
    n = w.shape[1]
    ks, cols, nt = 8192 // (128 * elem), 128, mr // 8
    a_row = ks + 8
    row_bytes = cols * elem

    def bits(a):  # bf16 bit patterns of exactly representable values
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).view(
            torch.int16).numpy()

    xb = bits(x)
    wb = w.astype(np.int8) if elem == 1 else bits(w)
    out = np.zeros((m, n))

    def bf16_pair(reg):  # a register of two bf16
        v = torch.from_numpy(reg.view(np.int16).copy()).view(torch.bfloat16).double().numpy()
        return float(v[0]), float(v[1])

    def pair(reg, lo, hi):  # two weights of a register's bytes
        if elem == 1:
            v = reg.view(np.int8)
            return float(v[lo]), float(v[hi])
        return bf16_pair(reg)

    for n0 in range(0, n, cols):
        acc = np.zeros((4, 2, nt, 32, 4))  # [warp][weight tile][token tile][lane][accumulator]
        for k0 in range(0, k, ks):
            panel = np.zeros(ks * row_bytes, np.uint8)
            for r in range(ks):
                raw = wb[k0 + r, n0:n0 + cols].view(np.uint8)
                for c in range(row_bytes // 16):
                    dst = r * row_bytes + ((c ^ (r & 7)) << 4)
                    panel[dst:dst + 16] = raw[16 * c:16 * c + 16]
            sa = np.zeros((mr, a_row), np.int16)
            sa[:m, :ks] = xb[:, k0:k0 + ks]
            sa = sa.reshape(-1).view(np.uint8)
            for warp in range(4):
                for kk in range(0, ks, 16):
                    bfr = [None] * nt
                    if nt == 1:
                        b = _ldmatrix(sa, [[(i * a_row + kk + 8 * jm) * 2 for i in range(8)]
                                           for jm in range(2)], trans=False)
                        bfr[0] = [[bf16_pair(b[lane, jm]) for jm in range(2)]
                                  for lane in range(32)]
                    else:
                        for j in range(0, nt, 2):  # matrix jm: tile j + (jm >> 1), k half jm & 1
                            b = _ldmatrix(sa, [[((8 * (j + (jm >> 1)) + i) * a_row + kk
                                                 + 8 * (jm & 1)) * 2 for i in range(8)]
                                               for jm in range(4)], trans=False)
                            bfr[j] = [[bf16_pair(b[lane, 0]), bf16_pair(b[lane, 1])]
                                      for lane in range(32)]
                            bfr[j + 1] = [[bf16_pair(b[lane, 2]), bf16_pair(b[lane, 3])]
                                          for lane in range(32)]
                    if elem == 1:
                        rows = [[(kk + 8 * (jm & 1) + i) * row_bytes
                                 + (((2 * warp + (jm >> 1)) ^ ((kk + 8 * (jm & 1) + i) & 7)) << 4)
                                 for i in range(8)] for jm in range(4)]
                        r = _ldmatrix(panel, rows, trans=True)
                        frags = [[[pair(r[lane, 2 * q], 0, 2), pair(r[lane, 2 * q], 1, 3),
                                   pair(r[lane, 2 * q + 1], 0, 2), pair(r[lane, 2 * q + 1], 1, 3)]
                                  for lane in range(32)] for q in range(2)]
                    else:
                        frags = []
                        for q in range(2):
                            rows = [[(kk + 8 * (jm >> 1) + i) * row_bytes
                                     + (((4 * warp + 2 * q + (jm & 1))
                                         ^ ((kk + 8 * (jm >> 1) + i) & 7)) << 4)
                                     for i in range(8)] for jm in range(4)]
                            r = _ldmatrix(panel, rows, trans=True)
                            frags.append([[pair(r[lane, jm], 0, 1) for jm in range(4)]
                                          for lane in range(32)])
                    for q in range(2):  # each widened weight fragment feeds every token tile
                        for j in range(nt):
                            acc[warp, q, j] += np.asarray(_mma_16816(frags[q], bfr[j]))
        for warp in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for q in range(2):
                    for j in range(nt):
                        for e in range(4):
                            row = 8 * j + 2 * t + (e & 1)
                            half = e >> 1
                            col = 16 * q + (2 * g + half if elem == 1 else 8 * half + g)
                            if row < m:
                                out[row, n0 + 32 * warp + col] = acc[warp, q, j, lane, e]
    return out


@pytest.mark.parametrize("elem", [1, 2])  # int8 or bf16 weights
@pytest.mark.parametrize("mr,m", [(16, 9), (16, 16), (32, 29), (64, 37), (64, 64)])
def test_gemv_tc_rows_fragments_compute_the_product(elem, mr, m):
    """Integer-valued tokens and weights: every product and sum is exact, so
    the emulated launch equals x @ w."""
    rng = np.random.default_rng(mr * 10 + m + elem)
    ks = 8192 // (128 * elem)
    x = rng.integers(-50, 50, (m, 2 * ks))
    w = rng.integers(-128, 128, (2 * ks, 256))
    np.testing.assert_array_equal(_gemv_tc_emulated(x, w, elem, mr), x @ w)


@pytest.mark.parametrize("mr,m", [(16, 12), (32, 32), (64, 53)])
def test_gemv_tc_rows_vs_jax(jx, mr, m):
    """bf16 activations: the emulated launch over int8 weights, scaled once
    per column as the kernel's flush does, against ``ref.matmul_q8`` and the
    JAX package's Pallas body in interpret mode; over bf16 weights against
    ``ref.matmul`` and the JAX matmul."""
    jnp, jref, jops = jx
    from repro_torch.models.quant import quantize_leaf

    rng = np.random.default_rng(mr + m)
    k, n = 128, 256  # two int8 K steps, two 128-column strips
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    leaf = quantize_leaf(w[None], (1,))
    q8, scale = leaf["q8"][0], leaf["scale"][0].reshape(n)
    got = _gemv_tc_emulated(a.float().numpy(), q8.numpy(), 1, mr)
    got = (torch.from_numpy(got).float() * scale).numpy()
    ja, jq, js = _jax(jnp, a), jnp.asarray(q8.numpy()), jnp.asarray(scale.numpy())
    for want in (ref.matmul_q8(a.float(), q8, scale),
                 jops.matmul_q8(ja.astype(jnp.float32), jq, js, mode="interpret", block=32),
                 jref.matmul_q8(ja.astype(jnp.float32), jq, js)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=MATMUL_TOL * np.abs(want).max())
    # bf16 weights: the same fragments over 16-bit columns (32 rows a K step)
    wb = w.to(torch.bfloat16)
    got = _gemv_tc_emulated(a.float().numpy(), wb.float().numpy(), 2, mr)
    for want in (ref.matmul(a.float(), wb.float()),
                 jops.matmul(ja.astype(jnp.float32), _jax(jnp, wb).astype(jnp.float32),
                             mode="interpret", block=32)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=MATMUL_TOL * np.abs(want).max())


# ------------------------------- the paged body's rows on tensor cores, lane by lane


def _stage(rows: np.ndarray, elem: int) -> tuple[np.ndarray, int]:
    """16 staged K or V rows of ``rows`` [16, D] (int8 at elem 1, bf16 at
    elem 2) as split_attention.cuh's Ring<..., kPad> lays them out: each row
    kStride bytes apart, one 16-byte chunk of padding where the row's chunks
    are even in number. Returns (bytes, kStride)."""
    d = rows.shape[1]
    row = d * elem
    stride = row + 16 if (row // 16) % 2 == 0 else row
    raw = (rows.astype(np.int8).view(np.uint8) if elem == 1 else
           torch.from_numpy(rows.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
           .numpy().view(np.uint8))
    out = np.zeros(16 * stride, np.uint8)
    for r in range(16):
        out[r * stride:r * stride + row] = raw[r]
    return out, stride


def _bf16_pair(reg):
    v = torch.from_numpy(reg.view(np.int16).copy()).view(torch.bfloat16).double().numpy()
    return float(v[0]), float(v[1])


@pytest.mark.parametrize("elem", [1, 2])  # an int8 or a bf16 pool
@pytest.mark.parametrize("d", [16, 80, 128])
def test_paged_mma_rows_fragments(elem, d):
    """One 16-key sub-step of split_attention.cuh's MmaRows, lane by lane:
    Q's A fragments by ldmatrix from the rows init stages (int8: each
    chunk's even dims first, so a register holds the dims (4t, 4t + 2) or
    (4t + 1, 4t + 3)), K^T's B fragments by
    ldmatrix from the padded stage rows (int8: x2, the bytes (0, 2) and (1,
    3) of a register widened), S = Q K^T over the D / 16 k-steps; then P's A
    fragments from S's accumulator layout and V's B fragments by ldmatrix
    .trans (int8: x2, one matrix feeding the even- and the odd-dim tiles),
    O = P V, the accumulators placed by MmaRows::dim. Integer data: S and O
    are exact; no ldmatrix meets a bank conflict."""
    rng = np.random.default_rng(d + elem)
    q = rng.integers(-8, 8, (8, d))
    kr, vr = rng.integers(-100, 100, (16, d)), rng.integers(-100, 100, (16, d))
    pm = rng.integers(0, 4, (8, 16))  # the weights P V takes (rows x keys)
    sk, stride = _stage(kr, elem)
    sv, _ = _stage(vr, elem)
    ks = d // 16
    # the queries as MmaRows::init stages them: int8 and fp8 pools put each
    # 16-dim chunk's even dims first, so a register holds (4t, 4t + 2) and
    # (4t + 1, 4t + 3), K's order
    cols = [dd - dd % 16 + (8 if dd % 2 else 0) + dd % 16 // 2 if elem == 1 else dd
            for dd in range(d)]
    qs = np.zeros((8, d))
    qs[:, cols] = q
    sq, q_stride = _stage(np.concatenate([qs, np.zeros((8, d))]), 2)
    qa = [[None] * ks for _ in range(32)]  # lane -> k-step -> (reg 0 pair, reg 2 pair)
    for s in range(ks):  # matrix j: rows 0-7, columns 16 s + 8 j .. + 7
        r = _ldmatrix(sq, [[i * q_stride + (16 * s + 8 * j) * 2 for i in range(8)]
                           for j in range(2)], trans=False)
        for lane in range(32):
            qa[lane][s] = (_bf16_pair(r[lane, 0]), _bf16_pair(r[lane, 1]))

    def bytes_pair(reg, shift):  # byte_pair_bf16x2(reg >> 8 * shift): bytes (0, 2) or (1, 3)
        v = reg.view(np.int8)
        return float(v[shift]), float(v[2 + shift])

    sacc = [np.zeros((32, 4)), np.zeros((32, 4))]  # [key tile] -> lane -> accumulators
    for s in range(ks):
        a = [[qa[lane][s][0], (0, 0), qa[lane][s][1], (0, 0)] for lane in range(32)]
        if elem == 1:  # matrix j: keys 8j .. + 7, bytes 16 s .. + 15
            r = _ldmatrix(sk, [[(8 * j + i) * stride + 16 * s for i in range(8)]
                               for j in range(2)], trans=False)
            b = [[[bytes_pair(r[lane, j], 0), bytes_pair(r[lane, j], 1)] for lane in range(32)]
                 for j in range(2)]
        else:  # matrix j: keys 8 (j >> 1) .. + 7, dims 16 s + 8 (j & 1) .. + 7
            r = _ldmatrix(sk, [[(8 * (j >> 1) + i) * stride + (16 * s + 8 * (j & 1)) * 2
                                for i in range(8)] for j in range(4)], trans=False)
            b = [[[_bf16_pair(r[lane, 2 * j]), _bf16_pair(r[lane, 2 * j + 1])]
                  for lane in range(32)] for j in range(2)]
        for j in range(2):
            sacc[j] += np.asarray(_mma_16816(a, b[j]))
    want_s = q @ kr.T
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(2):
            for e in range(2):
                assert sacc[j][lane, e] == want_s[g, 8 * j + 2 * t + e]
    # O = P V, P's A fragment from the accumulator layout of S
    pa = [[(pm[lane >> 2, 2 * (lane & 3)], pm[lane >> 2, 2 * (lane & 3) + 1]), (0, 0),
           (pm[lane >> 2, 2 * (lane & 3) + 8], pm[lane >> 2, 2 * (lane & 3) + 9]), (0, 0)]
          for lane in range(32)]
    out = np.zeros((8, d))
    for s in range(ks):
        if elem == 1:  # matrix j: keys 8j .. + 7, bytes 16 s .. + 15
            r = _ldmatrix(sv, [[(8 * j + i) * stride + 16 * s for i in range(8)]
                               for j in range(2)], trans=True)
            b = [[[bytes_pair(r[lane, 0], h), bytes_pair(r[lane, 1], h)] for lane in range(32)]
                 for h in range(2)]  # tiles of the even, then the odd dims
        else:  # matrix j: keys 8 (j & 1) .. + 7, dims 16 s + 8 (j >> 1) .. + 7
            r = _ldmatrix(sv, [[(8 * (j & 1) + i) * stride + (16 * s + 8 * (j >> 1)) * 2
                                for i in range(8)] for j in range(4)], trans=True)
            b = [[[_bf16_pair(r[lane, 2 * h]), _bf16_pair(r[lane, 2 * h + 1])]
                  for lane in range(32)] for h in range(2)]
        for h in range(2):
            acc = np.asarray(_mma_16816(pa, b[h]))
            jt = 2 * s + h
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                dim = 16 * (jt >> 1) + 4 * t + (jt & 1) if elem == 1 else 8 * jt + 2 * t
                out[g, dim] = acc[lane, 0]
                out[g, dim + (2 if elem == 1 else 1)] = acc[lane, 1]
                assert acc[lane, 2] == acc[lane, 3] == 0  # rows 8-15: zero
    np.testing.assert_array_equal(out, pm @ vr)


# ---------------------------------------------- the paged split body, plain


def _pool(rng, store, dtype, nb, bs, kv, d):
    """A K/V pool in the model dtype, or quantized rows with their scales;
    nb + 1 blocks (the last: the sentinel's scratch block)."""
    k, v = (torch.from_numpy(rng.standard_normal((nb + 1, bs, kv, d)).astype(np.float32))
            for _ in "kv")
    if STORES[store] is None:
        return k.to(dtype), v.to(dtype), {}
    (k, ks), (v, vs) = quantize_rows(k, STORES[store]), quantize_rows(v, STORES[store])
    return k, v, dict(k_scale=ks, v_scale=vs)


# three table rows over a shuffled pool of 12 blocks of 8 (40 positions a
# row; row 2 ends in the sentinel 12); a pack of 7 tokens of row 0 (a tile
# of 8 at G = 1 reaches the first token of row 2 too), 5 of row 2 and 4
# padding tokens (position 40), and a decode of one token per row
TABLES = [[7, 2, 9, 0, 11], [4, 10, 1, 6, 3], [5, 8, 12, 12, 12]]
PACK_SEQ = [0] * 7 + [2] * 5 + [0] * 4
PACK_POS = list(range(20, 27)) + list(range(11, 16)) + [40] * 4
DECODE_POS = [33, 0, 17]


@pytest.mark.parametrize("dtype,store,kv,g,d,window,kind,splits", [
    ("float32", "plain", 2, 1, 16, 0, "pack", 2),
    ("float32", "plain", 1, 4, 16, 6, "pack", 3),
    ("float32", "plain", 2, 8, 32, 0, "decode", 2),
    ("bfloat16", "plain", 2, 1, 16, 0, "decode", 5),
    ("float32", "int8", 2, 4, 16, 0, "decode", 1),
    ("bfloat16", "int8", 1, 1, 32, 5, "pack", 2),
    ("float32", "fp8", 2, 8, 16, 0, "pack", 4),
    ("bfloat16", "fp8", 1, 4, 16, 0, "decode", 3),
])
def test_paged_split_plain_vs_jax(jx, dtype, store, kv, g, d, window, kind, splits):
    jnp, jref, jops = jx
    rng = np.random.default_rng(kv * 100 + g * 10 + d + splits)
    tdt = getattr(torch, dtype)
    k, v, sc = _pool(rng, store, tdt, 12, 8, kv, d)
    tables = torch.tensor(TABLES, dtype=torch.int32)
    seq, pos = (PACK_SEQ, PACK_POS) if kind == "pack" else ([0, 1, 2], DECODE_POS)
    ts, tp = torch.tensor(seq, dtype=torch.int32), torch.tensor(pos, dtype=torch.int32)
    t = len(seq)
    q = torch.from_numpy(rng.standard_normal((t, kv, g, d)).astype(np.float32)).to(tdt)
    got = ref.paged_attention_split(q, k, v, ts, tp, tables, splits, window=window, block_s=8,
                                    **sc)
    assert got.dtype == tdt and got.shape == q.shape
    real = tp < tables.shape[1] * 8
    assert not got[~real].any()  # padding: zeros, no key read
    jargs = [_jax(jnp, x) for x in (q.reshape(t, kv * g, d), k, v, ts, tp, tables)]
    jsc = {n: _jax(jnp, x) for n, x in sc.items()}
    mine = got.float().reshape(t, kv * g, d).numpy()[real.numpy()]
    for mode in ("interpret", "ref"):
        want = jops.paged_ragged_attention(*jargs, window=window, mode=mode, **jsc)
        np.testing.assert_allclose(mine, np.asarray(want, np.float32)[real.numpy()],
                                   atol=TOL[dtype], rtol=0)
    plain = ref.paged_ragged_attention(q, k, v, ts, tp, tables, window=window, **sc)
    np.testing.assert_allclose(got.float()[real].numpy(), plain.float()[real].numpy(),
                               atol=TOL[dtype], rtol=0)


def test_paged_split_decode_matches_the_paged_decode_oracle():
    """A decode through the split twin equals ``ref.paged_decode_attention``
    (the dense decode oracle over the gathered view) wherever a key exists."""
    rng = np.random.default_rng(3)
    k, v, sc = _pool(rng, "int8", torch.float32, 12, 8, 2, 16)
    tables = torch.tensor(TABLES, dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((3, 2, 4, 16)).astype(np.float32))
    cl = torch.tensor(DECODE_POS, dtype=torch.int32)
    seq = torch.arange(3, dtype=torch.int32)
    got = ref.paged_attention_split(q, k, v, seq, cl, tables, 3, block_s=8, **sc)
    want = ref.paged_decode_attention(q, k, v, cl, tables, **sc)
    torch.testing.assert_close(got, want, atol=TOL["float32"], rtol=0)


# ------------------------------------------- what the wrappers hand the C library


@pytest.fixture
def fake_c(monkeypatch):
    """CPU tensors pass the device checks, the card has 132 SMs, and every C
    entry point returns 0 without touching memory; each call is recorded as
    (name, args)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_checks, "cuda_operands", lambda *a: None)
    monkeypatch.setattr(_checks, "aligned_rows", lambda *a: None)
    monkeypatch.setattr(_checks, "stream", lambda t: 0)
    monkeypatch.setattr(_checks, "_tickets", {})
    monkeypatch.setattr(dk, "_sms", lambda index: 132)
    monkeypatch.setattr(_build, "load", Lib)
    return calls


@pytest.mark.parametrize("t,g,decode,splits,want", [
    # (tokens a tile, span, splits): phase 5's decode at 8 sequences x 32
    # heads: 256 blocks, each of the 4 spans of 256 positions a split (1024
    # blocks, within 8 waves of 132 SMs)
    (8, 1, True, None, (1, 256, 4)),
    # a 64-token pack at G 1: 8 tiles of 8 tokens, the same 256 blocks
    (64, 1, False, None, (8, 256, 4)),
    (16, 1, True, None, (1, 512, 2)),  # 512 blocks: two spans fit 8 waves
    (64, 4, False, None, (2, 1024, 1)),  # 32 tiles of 2: 1024 blocks fill the waves
    (64, 8, False, None, (1, 1024, 1)),  # 2048 blocks fill the waves alone
    (8, 12, True, 3, (1, 512, 2)),  # asked for 3: spans of 512, so 2
    (5, 1, False, 1, (8, 1024, 1)),
])
def test_paged_wrapper_tile_span_and_scratch_from_host_values(fake_c, t, g, decode, splits,
                                                              want):
    kv, d, bs, maxb = 32, 64, 32, 32  # 1024 positions a table row
    q = torch.zeros(t, kv, g, d, dtype=torch.bfloat16)
    k = torch.zeros(40, bs, kv, d, dtype=torch.bfloat16)
    tables = torch.zeros(4, maxb, dtype=torch.int32)
    ts, tp = torch.zeros(t, dtype=torch.int32), torch.zeros(t, dtype=torch.int32)
    n0 = (pk.launches, pk.launches_q8, pk.launches_split_decode, pk.launches_split_pack)
    pk.paged_attention(q, k, k, ts, tp, tables, decode=decode, splits=splits, window=7)
    assert (pk.launches, pk.launches_q8, pk.launches_split_decode, pk.launches_split_pack) == (
        n0[0] + 1, n0[1], n0[2] + decode, n0[3] + (not decode))
    tt, span, n_splits = want
    if splits is None:
        assert pk.plan(maxb * bs, t, kv, g, 132, decode) == want
    (name, args), = fake_c
    # (q, k, v, ks, vs, tok_seq, tok_pos, tables, ws, counters, out, T, NB, bs, max_blocks,
    #  KV, G, D, window, span, tile_tokens, qdtype, sdtype, stream)
    assert name == "repro_paged_attention"
    assert args[11:21] == (t, 40, bs, maxb, kv, g, d, 7, span, 1 if decode else 0)
    assert (args[8] is not None, args[9] is not None) == (n_splits > 1,) * 2
    assert tt == pk.tile_tokens(g, decode)
    with pytest.raises(ValueError, match="splits"):
        pk.paged_attention(q, k, k, ts, tp, tables, splits=0)


def test_paged_decode_op_takes_one_token_a_tile(fake_c, monkeypatch):
    """``ops.paged_decode_attention`` on the card: the kernel's decode tile
    (tile_tokens 1) over table rows 0..B-1 at cur_len; the pack op a pack's."""
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(ops, "_seq_ids", lambda b, dev: torch.arange(b, dtype=torch.int32))
    q = torch.zeros(4, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(40, 16, 2, 64, dtype=torch.bfloat16)
    tables = torch.zeros(4, 8, dtype=torch.int32)
    cl = torch.tensor([3, 9, 0, 127], dtype=torch.int32)
    assert ops.paged_decode_attention(q, k, k, cl, tables).shape == q.shape
    assert ops.paged_ragged_attention(q, k, k, cl, cl, tables).shape == q.shape
    (_, dec), (_, pack) = fake_c
    assert (dec[20], pack[20]) == (1, 0)
    assert (dec[11], dec[16]) == (4, 4)  # 4 tokens, G = 8 / 2


@pytest.mark.parametrize("m", [9, 16, 37, 64])
def test_matmul_q8_wrapper_launches_the_multi_row_gemv(fake_c, m):
    a = torch.zeros(m, 4096, dtype=torch.bfloat16)
    b = torch.zeros(4096, 13440, dtype=torch.int8)
    n0 = (mmk.launches_gemv_tc_rows, mmk.launches_mma_pipe, mmk.launches_q8)
    mmk.matmul_q8(a, b, torch.ones(13440))
    assert (mmk.launches_gemv_tc_rows, mmk.launches_mma_pipe, mmk.launches_q8) == (
        n0[0] + 1, n0[1], n0[2] + 1)
    (_, ws_args), (_, args) = fake_c
    route = mmk.ROUTES.index("gemv_tc_rows")
    assert ws_args == (m, 4096, 13440, route, 0, 0, _checks.DTYPE_CODES[torch.int8])
    assert args[4] is not None and args[11] == route  # the GEMVs' ticket counters
    mmk._workspace_elems.cache_clear()


# ----------------------------------------------------------------------- CUDA


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int8_weight(dev, seed, k, n):
    from repro_torch.models.quant import quantize_leaf

    w = torch.randn(k, n, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    leaf = quantize_leaf(w[None], (1,))
    return leaf["q8"][0], leaf["scale"][0].reshape(n)


@pytest.mark.cuda
@pytest.mark.parametrize("split_k", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("kn", [(4096, 13440), (13440, 4096), (4096, 4096), (4096, 48)])
def test_cuda_gemv_tc_rows_vs_plain(kn, split_k):
    """M 9 to 64 over the serving widths (and a 48-column tail strip), on the
    multi-row GEMV at the kernel's own and forced K splits; an offset view
    of a as the activations; M 65 on the pipelined tile."""
    dev = _cuda()
    k, n = kn
    q8, scale = _int8_weight(dev, k + n, k, n)
    gen = torch.Generator(device=dev).manual_seed(split_k)
    for m in (9, 16, 17, 32, 37, 64, 65):
        a = torch.randn(m + 1, k, generator=gen, device=dev).to(torch.bfloat16)[1:]
        body = mmk.route(m, k, n, a.dtype, q8.dtype)
        assert body == ("gemv_tc_rows" if m <= 64 else "mma_pipe")
        n0 = getattr(mmk, f"launches_{body}")
        got = mmk.matmul_q8(a, q8, scale, split_k=split_k)
        assert getattr(mmk, f"launches_{body}") == n0 + 1
        want = ref.matmul_q8(a, q8, scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item(), (m, kn, split_k, err)


def _paged_case(dev, seed, nseq, maxb, bs, kv, g, d, store, dtype):
    """A shuffled pool of nseq rows of maxb blocks (the last entries of
    every other row left at the sentinel) and its tables."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = nseq * maxb
    k, v = (torch.randn(nb + 1, bs, kv, d, generator=gen, device=dev) for _ in "kv")
    if store == "plain":
        k, v, sc = k.to(dtype), v.to(dtype), {}
    else:
        (k, ks), (v, vs) = quantize_rows(k, STORES[store]), quantize_rows(v, STORES[store])
        sc = dict(k_scale=ks, v_scale=vs)
    tables = torch.randperm(nb, generator=torch.Generator().manual_seed(seed)).to(
        torch.int32).reshape(nseq, maxb)
    tables[1::2, maxb // 2 + 1:] = nb  # the sentinel past those rows' prefixes
    return k, v, sc, tables.to(dev), gen


def _check_paged(got, want, tp, s_pos, dtype):
    real = tp < s_pos
    assert not got[~real].any(), "padding rows must be zero"
    err = (got[real].float() - want[real].float()).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("g", [1, 4, 8, 12])
@pytest.mark.parametrize("store,dtype", [("plain", torch.bfloat16), ("int8", torch.bfloat16),
                                         ("fp8", torch.float32), ("plain", torch.float32)])
def test_cuda_paged_split_vs_plain(bs, g, store, dtype):
    """A pack whose tiles span two sequences, with padding tokens and the
    sentinel in half the tables, and a decode, with and without a window, at
    the kernel's own and forced splits."""
    dev = _cuda()
    maxb = 512 // bs
    k, v, sc, tables, gen = _paged_case(dev, bs + g, 4, maxb, bs, 2, g, 64, store, dtype)
    s_pos = maxb * bs
    # 13 tokens of row 0, 6 of row 1 (inside its prefix), 9 of row 2, 3 padding
    seq = [0] * 13 + [1] * 6 + [2] * 9 + [0] * 3
    pos = list(range(300, 313)) + list(range(100, 106)) + list(range(0, 9)) + [s_pos] * 3
    ts = torch.tensor(seq, dtype=torch.int32, device=dev)
    tp = torch.tensor(pos, dtype=torch.int32, device=dev)
    q = torch.randn(len(seq), 2, g, 64, generator=gen, device=dev).to(dtype)
    cl = torch.tensor([511, 200, 5, 0], dtype=torch.int32, device=dev)
    qd = torch.randn(4, 2, g, 64, generator=gen, device=dev).to(dtype)
    rows = torch.arange(4, dtype=torch.int32, device=dev)
    for window in (0, 40):
        for splits in (None, 1, 2):
            n0 = pk.launches_split_pack
            got = pk.paged_attention(q, k, v, ts, tp, tables, window=window, splits=splits, **sc)
            assert pk.launches_split_pack == n0 + 1
            want = ref.paged_ragged_attention(q, k, v, ts, tp, tables, window=window, **sc)
            _check_paged(got, want, tp, s_pos, dtype)
            got = pk.paged_attention(qd, k, v, rows, cl, tables, window=window, splits=splits,
                                     decode=True, **sc)
            want = ref.paged_decode_attention(qd, k, v, cl, tables, window=window, **sc)
            _check_paged(got, want, cl, s_pos, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", _checks.HEAD_DIMS)
def test_cuda_paged_split_whole_domain(d):
    """Every group 1..16 at head width d, bf16 and int8 pools, a pack and a
    decode against the split twin, two spans."""
    dev = _cuda()
    for g in range(1, _checks.MAX_GROUP + 1):
        for store in ("plain", "int8"):
            k, v, sc, tables, gen = _paged_case(dev, g, 3, 20, 16, 2, g, d, store,
                                                torch.bfloat16)
            seq = [0] * 9 + [2] * 4
            pos = list(range(250, 259)) + list(range(60, 64))
            ts = torch.tensor(seq, dtype=torch.int32, device=dev)
            tp = torch.tensor(pos, dtype=torch.int32, device=dev)
            q = torch.randn(len(seq), 2, g, d, generator=gen, device=dev).to(torch.bfloat16)
            got = pk.paged_attention(q, k, v, ts, tp, tables, splits=2, **sc)
            want = ref.paged_attention_split(q, k, v, ts, tp, tables, 2, **sc)
            _check_paged(got, want, tp, 320, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_paged_pack_at_a_prompts_first_positions_fp8():
    """``chip_smoke.py`` phase 2's paged fault case: a 64-token pack over
    fp8 rows whose first 40 tokens sit at positions 0-39 of one sequence
    (one to 40 keys: outputs nearly V rows), 16 of another, 8 padding, bf16
    queries, KV 32, d 128, 32-position blocks, V rows of N(0, 1.5^2) so that
    those outputs reach 4-8, where a bf16 step is 0.031. One bf16 rounding
    of P (2^-9 of a V row) crossed such a step, 0.031 off the plain
    version; P's remainder in a second mma (``PagedTable::kMmaSplitP``)
    keeps it within 2e-2."""
    dev = _cuda()
    k, v, _, tables, gen = _paged_case(dev, 7, 8, 32, 32, 32, 1, 128, "plain", torch.float32)
    (k, ks), (v, vs) = (quantize_rows(t, torch.float8_e4m3fn) for t in (k, v * 1.5))
    sc = dict(k_scale=ks, v_scale=vs)
    ts = torch.tensor([6] * 40 + [2] * 16 + [6] * 8, dtype=torch.int32, device=dev)
    tp = torch.tensor(list(range(40)) + list(range(545, 561)) + [1024] * 8, dtype=torch.int32,
                      device=dev)
    q = torch.randn(64, 32, 1, 128, generator=gen, device=dev).to(torch.bfloat16)
    got = pk.paged_attention(q, k, v, ts, tp, tables, **sc)
    want = ref.paged_ragged_attention(q, k, v, ts, tp, tables, **sc)
    _check_paged(got, want, tp, 1024, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_graph_replays_both_bodies_bitwise():
    """The multi-row GEMV (M 16 and 64, split) and the paged split body
    (a decode and a pack over an int8 pool, split) captured in one CUDA
    graph and replayed: bitwise the eager results, twice."""
    dev = _cuda()
    q8, scale = _int8_weight(dev, 1, 4096, 13440)
    q8d, scaled = _int8_weight(dev, 2, 13440, 4096)
    gen = torch.Generator(device=dev).manual_seed(3)
    a16 = torch.randn(16, 4096, generator=gen, device=dev).to(torch.bfloat16)
    a64 = torch.randn(64, 13440, generator=gen, device=dev).to(torch.bfloat16)
    k, v, sc, tables, _ = _paged_case(dev, 4, 8, 32, 32, 32, 1, 128, "int8", torch.bfloat16)
    ts = torch.tensor([6] * 40 + [1] * 16 + [6] * 8, dtype=torch.int32, device=dev)
    tp = torch.tensor(list(range(600, 640)) + list(range(545, 561)) + [1024] * 8,
                      dtype=torch.int32, device=dev)
    q = torch.randn(64, 32, 1, 128, generator=gen, device=dev).to(torch.bfloat16)
    qd = torch.randn(8, 32, 1, 128, generator=gen, device=dev).to(torch.bfloat16)
    cl = torch.tensor([540, 560, 580, 600, 5, 300, 700, 1023], dtype=torch.int32, device=dev)
    rows = torch.arange(8, dtype=torch.int32, device=dev)

    def step():
        return (mmk.matmul_q8(a16, q8, scale), mmk.matmul_q8(a64, q8d, scaled),
                pk.paged_attention(qd, k, v, rows, cl, tables, decode=True, **sc),
                pk.paged_attention(q, k, v, ts, tp, tables, **sc))

    assert pk.plan(1024, 64, 32, 1, dk._sms(dev.index), False)[2] > 1
    eager = step()
    torch.cuda.synchronize()
    n0 = (mmk.launches_gemv_tc_rows, pk.launches_split_decode, pk.launches_split_pack)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    assert (mmk.launches_gemv_tc_rows, pk.launches_split_decode, pk.launches_split_pack) == (
        n0[0] + 2, n0[1] + 1, n0[2] + 1)
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)
