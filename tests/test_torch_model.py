"""The port's dense LM against the JAX ``LM``: the same reduced config and
the same params (carried over by ``params_from_jax``), the same numpy inputs,
f32 on the CPU.

Tolerance: 1e-4 absolute on logits and caches. The JAX prefill runs the
chunked online-softmax attention on the CPU while the port's plain path runs
a dense softmax, and matmuls sum in different orders; at f32 through two
layers that moves logits by ~1e-6, two orders below the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import LM as JaxLM
from repro_torch.configs import get_arch
from repro_torch.models import LM, params_from_jax

TOL = 1e-4
MAX_LEN = 32


@pytest.fixture(scope="module", params=["codeqwen1.5-7b", "qwen3-32b"])
def pair(request):
    jcfg = jax_get_arch(request.param).reduced()
    cfg = get_arch(request.param).reduced()
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.key(0))
    m = LM(cfg, device="cpu")
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, m, p


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def _tok(rng, *shape):
    return rng.integers(0, 256, size=shape).astype(np.int32)


def _prefilled(pair, rng, b=3, s=11):
    jm, jp, m, p = pair
    toks = _tok(rng, b, s)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    log, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    return jlog, jcache, log, cache


def test_config_and_params_match(pair):
    jm, jp, m, p = pair
    assert m.cfg.head_dim == jm.cfg.head_dim
    assert m.cfg.n_kv_heads == jm.cfg.n_kv_heads and m.cfg.qk_norm == jm.cfg.qk_norm
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), p)
    assert jshapes == tshapes
    own = m.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), own) == tshapes


def test_prefill_logits_and_cache(pair):
    jlog, jcache, log, cache = _prefilled(pair, np.random.default_rng(0))
    _close(log, jlog)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_decode_step_logits_and_cache(pair):
    jm, jp, m, p = pair
    rng = np.random.default_rng(1)
    _, jcache, _, cache = _prefilled(pair, rng)
    cur = np.asarray([11, 7, 0], np.int32)  # ragged lengths, incl. an empty slot
    toks = _tok(rng, 3, 1)
    for _ in range(2):
        jlog, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(toks)}, jnp.asarray(cur))
        log, cache = m.decode_step(p, cache, {"tokens": torch.from_numpy(toks)}, torch.from_numpy(cur))
        _close(log, jlog)
        toks = np.asarray(jnp.argmax(jlog, -1), np.int32)
        cur = cur + 1
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_packed_step_with_pack_slots_and_out_rows(pair):
    """A pack of two prefill chunks (slots 2 and 0 through pack_slots) and
    bucket padding at pos = max_len, unembedding only selected rows."""
    jm, jp, m, p = pair
    rng = np.random.default_rng(2)
    _, jcache, _, cache = _prefilled(pair, rng)
    local = [0] * 6 + [1] * 5 + [0] * 5  # 5 padding rows ride local slot 0
    pos = list(range(4, 10)) + list(range(11, 16)) + [MAX_LEN] * 5
    toks = _tok(rng, len(local))
    pack_slots = np.asarray([2, 0], np.int32)
    out_rows = np.asarray([5, 10, 12], np.int32)
    args = (toks, np.asarray(local, np.int32), np.asarray(pos, np.int32))
    jlog, jcache = jm.packed_step(
        jp, jcache, *map(jnp.asarray, args),
        out_rows=jnp.asarray(out_rows), pack_slots=jnp.asarray(pack_slots), max_len=MAX_LEN,
    )
    log, cache = m.packed_step(
        p, cache, *map(torch.from_numpy, args),
        out_rows=torch.from_numpy(out_rows), pack_slots=torch.from_numpy(pack_slots),
        max_len=MAX_LEN,
    )
    assert log.shape == (3, 256)
    # row 12 is padding: never read by the engine, but both sides compute it
    # the same way (all of slot 2's rows valid), so it is held too
    _close(log, jlog)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_pack_padding_rows_leave_cache_untouched(pair):
    """The smallest pack (one real row, seven padding rows riding the same
    slot) writes that one cache row and nothing else."""
    _, _, m, p = pair
    _, _, _, cache = _prefilled(pair, np.random.default_rng(3))
    before = {k: v.clone() for k, v in cache.items()}
    n = 8
    pos = torch.full((n,), MAX_LEN, dtype=torch.int32)
    pos[0] = 7
    m.packed_step(
        p, cache, torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32), pos,
        pack_slots=torch.tensor([1, 0], dtype=torch.int32),
    )
    for k in cache:
        changed = (cache[k] != before[k]).flatten(3).any(-1)  # [L, B, S]
        want = torch.zeros_like(changed)
        want[:, 1, 7] = True
        assert torch.equal(changed, want)


def test_decode_write_past_cache_is_clamped(pair):
    """cur_len >= S_max writes row S_max - 1, as dynamic_update_slice does."""
    jm, jp, m, p = pair
    rng = np.random.default_rng(4)
    _, jcache, _, cache = _prefilled(pair, rng)
    cur = np.asarray([MAX_LEN + 3, 5, MAX_LEN - 1], np.int32)
    toks = _tok(rng, 3, 1)
    _, jcache = jm.decode_step(jp, jcache, {"tokens": jnp.asarray(toks)}, jnp.asarray(cur))
    _, cache = m.decode_step(p, cache, {"tokens": torch.from_numpy(toks)}, torch.from_numpy(cur))
    _close(cache["k"], jcache["k"])


def test_sliding_window_prefill_refused():
    """A windowed prefill was refused until the port took JAX's route for it
    (the chunked attention over the window, ``models/attention.py``): it now
    runs, its logits ``LM.forward``'s bit for bit and its cache filled
    (``tests/test_torch_embeds.py`` holds both against JAX's)."""
    from dataclasses import replace

    cfg = replace(get_arch("codeqwen1.5-7b").reduced(), sliding_window=8)
    m = LM(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    toks = torch.arange(12, dtype=torch.int32)[None]
    logits, cache = m.prefill(p, {"tokens": toks}, 16)
    with torch.no_grad():
        assert torch.equal(logits, m.forward(p, {"tokens": toks})[0])
    assert cache["k"][:, 0, :12].abs().sum() > 0 and cache["k"][:, 0, 12:].abs().sum() == 0
