"""The port's threefry PRNG (``repro_torch/serve/prng.py``) against
``jax.random`` under jax's default ``jax_threefry_partitionable=True``.

The keys, ``fold_in``, the 32-bit random bits and the uniforms must be
BITWISE equal. The gumbel values ``-log(-log(u))`` go through two float32
logs, which torch and XLA each round within an ulp of the exact value, so
two implementations may be up to 2 ulps apart per log. The inner log's
difference, relative to its value y, moves the outer result by about that
relative difference in absolute terms (d log y = dy / y): at most 2 ulps of
1. The outer log adds 2 ulps of |g|. So the bound held here is
|g_port - g_jax| <= 4 float32 steps of max(|g|, 1); the largest difference
measured over these cases is 2 steps.

JAX is imported inside the CPU tests only, so the ``cuda`` test also runs
where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.serve import prng

SEEDS = np.array([0, 1, -1, 2**31 - 1, -(2**31)], np.int32)
VOCABS = (1, 256, 1000, 92416)


def _np_positions(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4096, size=n).astype(np.int32)


def _jax_keys(seeds, pos):
    import jax
    import jax.numpy as jnp

    return jax.vmap(lambda s, p: jax.random.fold_in(jax.random.key(s), p))(
        jnp.asarray(seeds), jnp.asarray(pos))


def _words(k) -> np.ndarray:
    return torch.stack(k, -1).numpy()


def test_jax_is_partitionable():
    """The recipe ported is the partitionable one, jax's default."""
    import jax

    assert jax.config.jax_threefry_partitionable


def test_key_is_bitwise():
    import jax
    import jax.numpy as jnp

    got = _words(prng.key(torch.from_numpy(SEEDS)))
    want = np.asarray(jax.random.key_data(jax.vmap(jax.random.key)(jnp.asarray(SEEDS))))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_fold_in_every_position_is_bitwise():
    """Every position 0..4095 under each of the five seeds."""
    import jax
    import jax.numpy as jnp

    pos = np.tile(np.arange(4096, dtype=np.int32), len(SEEDS))
    seeds = np.repeat(SEEDS, 4096)
    got = _words(prng.fold_in(prng.key(torch.from_numpy(seeds)), torch.from_numpy(pos)))
    want = np.asarray(jax.random.key_data(_jax_keys(seeds, pos))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_threefry_matches_jax_primitive():
    """The raw hash against jax's own, on random words."""
    import jax.numpy as jnp
    from jax._src import prng as jprng

    rng = np.random.default_rng(1)
    w = rng.integers(0, 2**32, size=(4, 64), dtype=np.uint64).astype(np.uint32)
    want = jprng.threefry_2x32(jnp.asarray(w[:2, 0]), jnp.asarray(np.concatenate([w[2], w[3]])))
    t = torch.from_numpy(w.astype(np.int64))
    x0, x1 = prng.threefry2x32(t[0, 0], t[1, 0], t[2], t[3])
    np.testing.assert_array_equal(np.concatenate([x0.numpy(), x1.numpy()]),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("v", VOCABS)
def test_bits_and_uniform_are_bitwise(v):
    import jax
    import jax.numpy as jnp

    pos = _np_positions(len(SEEDS), seed=v)
    jk = _jax_keys(SEEDS, pos)
    k = prng.fold_in(prng.key(torch.from_numpy(SEEDS)), torch.from_numpy(pos))
    bits = prng.random_bits(k, v).numpy()
    jbits = np.asarray(jax.vmap(lambda kk: jax.random.bits(kk, (v,), jnp.uint32))(jk))
    np.testing.assert_array_equal(bits, jbits.astype(np.int64))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    for lo in (0.0, tiny):
        u = prng.uniform(k, v, lo).numpy()
        ju = np.asarray(jax.vmap(
            lambda kk: jax.random.uniform(kk, (v,), jnp.float32, minval=lo))(jk))
        np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))


@pytest.mark.parametrize("v", VOCABS)
def test_gumbel_within_four_steps(v):
    import jax
    import jax.numpy as jnp

    pos = _np_positions(len(SEEDS), seed=v + 1)
    jk = _jax_keys(SEEDS, pos)
    g = prng.gumbel(prng.fold_in(prng.key(torch.from_numpy(SEEDS)), torch.from_numpy(pos)), v)
    jg = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (v,), jnp.float32))(jk))
    g = g.numpy()
    assert np.isfinite(g).all()
    step = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert (np.abs(g - jg) <= 4 * step).all(), float((np.abs(g - jg) / step).max())


def test_batched_rows_are_independent_keys():
    """Row i of a batched draw is the draw of key i alone."""
    pos = torch.tensor([3, 3, 9], dtype=torch.int32)
    k = prng.fold_in(prng.key(torch.tensor([5, 6, 5], dtype=torch.int32)), pos)
    bits = prng.random_bits(k, 33)
    for i in range(3):
        one = prng.random_bits((k[0][i:i + 1], k[1][i:i + 1]), 33)
        assert torch.equal(bits[i:i + 1], one)
    assert not torch.equal(bits[0], bits[1]) and not torch.equal(bits[0], bits[2])


@pytest.mark.cuda
@pytest.mark.parametrize("v", (1, 1000, 92416))
def test_cuda_prng_equals_cpu(v):
    """On the card: keys, bits and uniforms bitwise the CPU's, gumbel within
    the same four steps (torch's CUDA log against its CPU log)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seeds = torch.from_numpy(np.repeat(SEEDS, 4))
    pos = torch.from_numpy(_np_positions(len(seeds), seed=v))
    kc = prng.fold_in(prng.key(seeds), pos)
    kg = prng.fold_in(prng.key(seeds.cuda()), pos.cuda())
    assert torch.equal(torch.stack(kg, -1).cpu(), torch.stack(kc, -1))
    assert torch.equal(prng.random_bits(kg, v).cpu(), prng.random_bits(kc, v))
    tiny = float(torch.finfo(torch.float32).tiny)
    assert torch.equal(prng.uniform(kg, v, tiny).cpu().view(torch.int32),
                       prng.uniform(kc, v, tiny).view(torch.int32))
    g, gc = prng.gumbel(kg, v).cpu(), prng.gumbel(kc, v)
    step = torch.from_numpy(np.spacing(np.maximum(gc.abs().numpy(), 1.0).astype(np.float32)))
    assert ((g - gc).abs() <= 4 * step).all()
