"""``embeds`` on the port's serving calls and the windowed prefill, against
the JAX ``LM`` on the CPU, f32, reduced configs, the same params
(``params_from_jax``).

- reduced musicgen-large (an audio arch: frames in, JAX's ``input_specs``
  gives it ``embeds``): ``prefill`` then 4 ``decode_step``\\ s on embeds
  equal JAX's logits and cache (``tests/test_torch_model.py``'s 1e-4
  absolute), on one lane and on the merged view over two CPU lanes; the
  embedding rows of a token stream give the token path's logits bitwise;
- reduced codeqwen1.5-7b with ``sliding_window=24``, S 96: ``prefill``'s
  logits and cache equal JAX's (both take the windowed chunked route; the
  flash kernels have no window), its logits equal ``LM.forward``'s bitwise.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import LM as JaxLM
from repro_torch.configs import get_arch
from repro_torch.dist.sharding import device_put, gather, serve_param_shardings, serving_mesh_info
from repro_torch.models import LM, params_from_jax

TOL = 1e-4
MAX_LEN = 40
S = 16
STEPS = 4


def _pair(name: str, **over):
    jcfg = replace(jax_get_arch(name).reduced(), **over)
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.key(0))
    m = LM(replace(get_arch(name).reduced(), **over), device="cpu")
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def musicgen():
    return _pair("musicgen-large")


def _close(got, want) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=0)


def _frames(rng, b, s, d):
    return rng.standard_normal((b, s, d)).astype(np.float32)


def _serve(m, p, first: dict, steps: list[dict]):
    """(prefill logits, each decode step's logits, the final cache)."""
    logits, cache = m.prefill(p, first, MAX_LEN)
    outs = []
    s = next(iter(first.values())).shape[1]
    for i, b in enumerate(steps):
        cur = torch.full((b[next(iter(b))].shape[0],), s + i, dtype=torch.int32)
        step, cache = m.decode_step(p, cache, b, cur)
        outs.append(step)
    return logits, outs, cache


def test_musicgen_embeds_prefill_and_decode_equal_jax(musicgen):
    jm, jp, m, p = musicgen
    rng = np.random.default_rng(0)
    d = m.cfg.d_model
    first = _frames(rng, 2, S, d)
    steps = [_frames(rng, 2, 1, d) for _ in range(STEPS)]
    jlog, jcache = jm.prefill(jp, {"embeds": jnp.asarray(first)}, MAX_LEN)
    jsteps = []
    for i, e in enumerate(steps):
        out, jcache = jm.decode_step(jp, jcache, {"embeds": jnp.asarray(e)}, jnp.int32(S + i))
        jsteps.append(out)
    log, outs, cache = _serve(m, p, {"embeds": torch.from_numpy(first)},
                              [{"embeds": torch.from_numpy(e)} for e in steps])
    _close(log, jlog)
    for got, want in zip(outs, jsteps):
        _close(got, want)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_embedding_rows_are_the_token_path_bitwise(musicgen):
    """The embedding rows of a token stream through ``embeds`` give the
    token path's logits and cache bit for bit."""
    _, _, m, p = musicgen
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, m.cfg.vocab_size, (2, S + STEPS)).astype(np.int32))
    tab = p["embed"]["tok"]
    runs = []
    for embeds in (False, True):
        def batch(t):
            return {"embeds": tab[t.long()]} if embeds else {"tokens": t}
        runs.append(_serve(m, p, batch(toks[:, :S]),
                           [batch(toks[:, S + i:S + i + 1]) for i in range(STEPS)]))
    (la, oa, ca), (lb, ob, cb) = runs
    assert torch.equal(la, lb) and all(torch.equal(a, b) for a, b in zip(oa, ob))
    assert torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"])


def test_merged_view_takes_embeds(musicgen):
    """The merged view over two CPU lanes on embeds: prefill and decode
    logits and the cache equal one lane's (f32 partial sums over the lanes
    in another order: 1e-5 of the largest logit)."""
    _, _, m, p = musicgen
    rng = np.random.default_rng(2)
    d = m.cfg.d_model
    first = {"embeds": torch.from_numpy(_frames(rng, 2, S, d))}
    steps = [{"embeds": torch.from_numpy(_frames(rng, 2, 1, d))} for _ in range(STEPS)]
    info = serving_mesh_info(["cpu", "cpu"])
    merged = LM(m.cfg, mesh_info=info)
    mp = device_put(p, serve_param_shardings(p, info))
    la, oa, ca = _serve(m, p, first, steps)
    lb, ob, cb = _serve(merged, mp, first, steps)
    for want, got in [(la, lb)] + list(zip(oa, ob)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    for k in ("k", "v"):
        assert (gather(cb[k]) - ca[k]).abs().max() <= 1e-5 * ca[k].abs().max()


def test_windowed_prefill_equals_jax():
    """Reduced codeqwen1.5-7b, window 24, S 96: the prefill no longer
    raises; its logits and cache equal JAX's, its logits ``LM.forward``'s
    bitwise (one route: the chunked attention over the window)."""
    jm, jp, m, p = _pair("codeqwen1.5-7b", sliding_window=24)
    toks = np.random.default_rng(3).integers(0, 256, (2, 96)).astype(np.int32)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 96)
    log, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)}, 96)
    _close(log, jlog)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    with torch.no_grad():
        fwd = m.forward(p, {"tokens": torch.from_numpy(toks)})[0]
    assert torch.equal(log, fwd)
