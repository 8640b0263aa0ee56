"""The port's attention kernels against the JAX package.

CPU: the plain PyTorch versions (``repro_torch.kernels.ref``, what
``repro_torch.kernels.ops`` runs for CPU tensors) against ``repro.kernels.ref``
at several shapes and against the Pallas kernels in interpret mode at one
tiny shape, on the same numpy inputs. Tolerance: 2e-5 absolute at f32 — both
sides are f32 softmax attention over <= 64 keys, differing only in summation
order.

CUDA (``-m cuda``, skipped without a card): each hand-written kernel against
its plain version on the card, f32 and bf16. JAX is imported inside the CPU
tests only, so the CUDA tests also run where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ragged_attention as rk

TOL = 2e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.ref, repro.kernels.ops)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jref, jops


# ---------------------------------------------------------------- plain vs JAX


@pytest.mark.parametrize(
    "kv,g,s_max,window,cur",
    [
        (2, 1, 37, 0, (0, 17, 36)),  # MHA, S not a tile multiple, cur_len 0 and S-1
        (2, 4, 40, 0, (5, 39, 21)),  # GQA group of 4
        (1, 4, 33, 7, (3, 32, 12)),  # window
        (2, 2, 24, 0, (30, 23, 0)),  # cur_len past the cache: whole slot valid
    ],
)
def test_decode_plain_vs_jax_ref(kv, g, s_max, window, cur, jx):
    jnp, jref, _ = jx
    rng = np.random.default_rng(0)
    b, d = len(cur), 16
    q, k, v = _np(rng, b, kv, g, d), _np(rng, b, s_max, kv, d), _np(rng, b, s_max, kv, d)
    cl = np.asarray(cur, np.int32)
    want = jref.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cl), window=window
    )
    got = ref.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(cl),
        window=window,
    )
    _close(got, want)


def _pack(s_max, chunks):
    """Descriptors of a pack: (slot, first pos, n tokens) chunks + 3 padding
    tokens at pos = s_max (slot 0), as the engine builds them."""
    slots, poss = [], []
    for slot, p0, n in chunks:
        slots += [slot] * n
        poss += list(range(p0, p0 + n))
    slots += [0, 0, 0]
    poss += [s_max] * 3
    return np.asarray(slots, np.int32), np.asarray(poss, np.int32)


@pytest.mark.parametrize(
    "kv,g,s_max,window",
    [(2, 1, 37, 0), (2, 4, 40, 0), (1, 4, 29, 5), (4, 2, 64, 0)],
)
def test_ragged_plain_vs_jax_ref(kv, g, s_max, window, jx):
    jnp, jref, _ = jx
    rng = np.random.default_rng(1)
    b, d = 3, 16
    slots, poss = _pack(s_max, [(2, 4, 6), (0, 11, 5), (1, 0, 1), (1, 20, 1)])
    t = len(slots)
    q, k, v = _np(rng, t, kv, g, d), _np(rng, b, s_max, kv, d), _np(rng, b, s_max, kv, d)
    want = jref.ragged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots), jnp.asarray(poss),
        window=window,
    )
    got = ref.ragged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(slots), torch.from_numpy(poss), window=window,
    )
    _close(got, want)
    mask_j = jref.ragged_valid_mask(jnp.asarray(slots), jnp.asarray(poss), b, s_max, window)
    mask_t = ref.ragged_valid_mask(torch.from_numpy(slots), torch.from_numpy(poss), b, s_max, window)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


@pytest.mark.parametrize(
    "bkv,g,sq,causal", [(2, 1, 37, True), (3, 4, 16, True), (2, 2, 21, False)]
)
def test_flash_plain_vs_jax_ref(bkv, g, sq, causal, jx):
    jnp, jref, _ = jx
    rng = np.random.default_rng(2)
    d = 16
    q, k, v = _np(rng, bkv, g, sq, d), _np(rng, bkv, sq, d), _np(rng, bkv, sq, d)
    want = jref.gqa_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = ref.gqa_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal
    )
    _close(got, want)


# ------------------------------------------------------ plain vs Pallas interpret


def test_ops_vs_pallas_interpret(jx):
    """One tiny shape per kernel: the port's ops (CPU -> plain version)
    against the JAX package's Pallas kernels run in interpret mode."""
    jnp, _, jops = jx
    rng = np.random.default_rng(3)
    b, kv, g, s_max, d = 2, 2, 2, 24, 16
    h = kv * g
    k, v = _np(rng, b, s_max, kv, d), _np(rng, b, s_max, kv, d)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)

    q = _np(rng, b, h, d)
    cl = np.asarray([9, 23], np.int32)
    want = jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cl),
        window=5, mode="interpret", block_s=8,
    )
    _close(ops.decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(cl), window=5), want)

    slots, poss = _pack(s_max, [(1, 3, 4), (0, 10, 2)])
    q = _np(rng, len(slots), h, d)
    want = jops.ragged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots), jnp.asarray(poss),
        mode="interpret", block_s=8,
    )
    got = ops.ragged_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(slots), torch.from_numpy(poss)
    )
    _close(got, want)

    sq = 13
    q, kk, vv = _np(rng, 1, h, sq, d), _np(rng, 1, kv, sq, d), _np(rng, 1, kv, sq, d)
    want = jops.gqa_flash_attention(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), causal=True, mode="interpret",
        block_q=8, block_k=8,
    )
    got = ops.gqa_flash_attention(torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(vv))
    _close(got, want)


# -------------------------------------------------- dispatch rules on the CPU


def test_cpu_tensors_never_reach_a_kernel():
    """ops routes CPU tensors to the plain version without counting a
    launch; the kernel wrappers themselves refuse CPU tensors."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_np(rng, *s)) for s in ((2, 2, 1, 64), (2, 8, 2, 64), (2, 8, 2, 64)))
    cl = torch.tensor([3, 7], dtype=torch.int32)
    before = (dk.launches, rk.launches, fk.launches)
    ops.decode_attention(q.reshape(2, 2, 64), k, v, cl)
    ops.ragged_attention(q.reshape(2, 2, 64), k, v, cl.clone().zero_(), cl)
    ops.gqa_flash_attention(q.reshape(1, 2, 2, 64), k[:1].permute(0, 2, 1, 3), v[:1].permute(0, 2, 1, 3))
    assert (dk.launches, rk.launches, fk.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        dk.decode_attention(q, k, v, cl)
    with pytest.raises(ValueError, match="CUDA"):
        rk.ragged_attention(q, k, v, cl, cl)
    with pytest.raises(ValueError, match="CUDA"):
        fk.gqa_flash_attention(q.reshape(1, 2, 2, 64), k[0], v[0])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()


def test_build_hash_covers_every_source():
    names = {p.name for p in _build.CSRC.iterdir()}
    assert {"decode_attention.cu", "ragged_attention.cu", "flash_attention.cu"} <= names
    assert _build.library_path().parent.name == _build.source_hash()


# ------------------------------------------------------------ CUDA kernels


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_tol(dtype):
    # f32: both sides f32 math, summation order differs; bf16: the kernel
    # and the plain version see the same bf16 inputs and both compute in
    # f32, so the gap is one bf16 rounding of the output (2^-8 relative)
    return 1e-4 if dtype == torch.float32 else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv,g,d,window", [(4, 1, 128, 0), (2, 8, 128, 0), (2, 4, 64, 9)])
def test_cuda_decode_vs_plain(dtype, kv, g, d, window):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s_max = 4, 300
    q = torch.randn(b, kv, g, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s_max, kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s_max, kv, d, generator=gen, device=dev).to(dtype)
    cl = torch.tensor([0, 77, 299, 400], dtype=torch.int32, device=dev)
    n0 = dk.launches
    got = dk.decode_attention(q, k, v, cl, window=window)
    torch.cuda.synchronize()
    assert dk.launches == n0 + 1
    want = ref.decode_attention(q, k, v, cl, window=window)
    # slot 3 (cur_len past the cache) with a window sees no key: the kernel
    # writes zeros (as the TPU kernel does), the plain version a uniform
    # average; serving never asks for it (prompt + tokens < max_len)
    real = (cl - window < s_max - 1) if window else torch.ones_like(cl, dtype=torch.bool)
    assert (got[real].float() - want[real].float()).abs().max().item() <= _kernel_tol(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv,g,d,window", [(4, 1, 128, 0), (2, 8, 128, 0), (2, 2, 64, 6)])
def test_cuda_ragged_vs_plain(dtype, kv, g, d, window):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s_max = 3, 200
    slots, poss = _pack(s_max, [(2, 5, 20), (0, 150, 9), (1, 0, 1)])
    t = len(slots)
    q = torch.randn(t, kv, g, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s_max, kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s_max, kv, d, generator=gen, device=dev).to(dtype)
    ts, tp = torch.from_numpy(slots).to(dev), torch.from_numpy(poss).to(dev)
    got = rk.ragged_attention(q, k, v, ts, tp, window=window)
    want = ref.ragged_attention(q, k, v, ts, tp, window=window)
    torch.cuda.synchronize()
    # padding rows (pos = s_max) are never read: the kernel reads no key for
    # them and writes zeros, the plain version attends the whole slot
    real = tp < s_max
    assert (got[real].float() - want[real].float()).abs().max().item() <= _kernel_tol(dtype)
    assert not got[~real].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bkv,g,s,d,causal", [(4, 1, 64, 128, True), (2, 8, 37, 128, True),
                                              (3, 2, 50, 64, False)])
def test_cuda_flash_vs_plain(dtype, bkv, g, s, d, causal):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(bkv, g, s, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(bkv, s, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(bkv, s, d, generator=gen, device=dev).to(dtype)
    got = fk.gqa_flash_attention(q, k, v, causal=causal)
    want = ref.gqa_flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _kernel_tol(dtype)
