"""The port's unified ServeEngine against the JAX ServeEngine: the same
reduced codeqwen params (carried over through ``params_from_jax``), the same
prompts, greedy — the token streams must be EQUAL.

Cases: the serving_bench steady stream (prompt lengths PROMPT_LENS, 12 new
tokens, 4 slots, max_len 96: every prompt takes the fused admission), a
``prefill_budget=16`` variant that pushes most prompts through ragged packs,
a mid-stream cancel, and ``max_chunk`` 1 and 8. Each JAX engine compiles its
own programs, so each JAX reference run is shared through a module fixture.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import LM as JaxLM
from repro.serve import Request as JaxRequest
from repro.serve import SamplingParams as JaxSamplingParams
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_arch
from repro_torch.models import LM, params_from_jax
from repro_torch.serve import Request, SamplingParams, ServeEngine

# benchmarks/serving_bench.py's steady stream
PROMPT_LENS = (5, 8, 11, 13, 16, 19, 23, 27, 31, 34, 38, 43)
MAX_NEW = 12
SLOTS, MAX_LEN = 4, 96


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_arch("codeqwen1.5-7b").reduced()
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.key(0))
    m = LM(get_arch("codeqwen1.5-7b").reduced(), device="cpu")
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=s).astype(np.int32) for s in PROMPT_LENS]
    return jm, jp, m, p, prompts


def _jax_streams(models, **kw):
    jm, jp, _, _, prompts = models
    eng = JaxServeEngine(jm, jp, batch_slots=SLOTS, max_len=MAX_LEN, **kw)
    for i, pr in enumerate(prompts):
        eng.submit(JaxRequest(rid=i, prompt=pr, params=JaxSamplingParams(max_new=MAX_NEW)))
    eng.run()
    return {r.rid: r.generated for r in eng.finished}


def _port_engine(models, **kw):
    _, _, m, p, prompts = models
    eng = ServeEngine(m, p, batch_slots=SLOTS, max_len=MAX_LEN, device="cpu", **kw)
    handles = [
        eng.submit(Request(rid=i, prompt=pr, params=SamplingParams(max_new=MAX_NEW)))
        for i, pr in enumerate(prompts)
    ]
    return eng, handles


def _port_streams(models, **kw):
    eng, _ = _port_engine(models, **kw)
    stats = eng.run()
    assert stats.total_requests == len(PROMPT_LENS)
    return {r.rid: r.generated for r in eng.finished}


@pytest.fixture(scope="module")
def jax_steady(models):
    return _jax_streams(models)


@pytest.fixture(scope="module")
def jax_packed(models):
    return _jax_streams(models, prefill_budget=16)


@pytest.mark.parametrize("max_chunk", [8, 1])
def test_steady_stream_matches_jax(models, jax_steady, max_chunk):
    """The JAX streams are chunk-invariant, so both chunk depths of the port
    are held to the one JAX run at the default max_chunk=8."""
    got = _port_streams(models, max_chunk=max_chunk)
    assert all(len(t) == MAX_NEW for t in got.values())
    assert got == jax_steady


@pytest.mark.parametrize("max_chunk", [8, 1])
def test_forced_packs_match_jax(models, jax_packed, max_chunk):
    eng, _ = _port_engine(models, prefill_budget=16, max_chunk=max_chunk)
    packs = []
    tick = eng._packed_tick
    eng._packed_tick = lambda stats: (packs.append(1), tick(stats))
    eng.run()
    assert len(packs) >= 8  # prompts of 19..43 tokens need 2-3 packs each
    assert {r.rid: r.generated for r in eng.finished} == jax_packed


def test_forced_packs_equal_fused_admission(jax_steady, jax_packed):
    """Chunking is a scheduling choice in the reference too."""
    assert jax_steady == jax_packed


def test_mid_stream_cancel(models, jax_steady):
    """Cancelling rid 1 mid-decode frees its slot for the queue; every other
    stream stays equal to the uncancelled JAX run, and the cancelled stream
    is a prefix of its own."""
    eng, handles = _port_engine(models)
    it = handles[0].tokens()
    first = [next(it) for _ in range(3)]
    handles[1].cancel()
    assert first + list(it) == jax_steady[0]
    assert handles[1].finish_reason == "cancelled" and handles[1].done
    for h in handles[2:]:
        assert h.result() == jax_steady[h.rid]
    cut = handles[1].request.generated
    assert cut == jax_steady[1][: len(cut)] and len(cut) < MAX_NEW
    assert eng.stream_stats.cancelled == 1


def test_stats_and_stop_token(models, jax_steady):
    _, _, m, p, prompts = models
    eng = ServeEngine(m, p, batch_slots=SLOTS, max_len=MAX_LEN, device="cpu")
    eng.prewarm()
    stop = jax_steady[0][4]
    eng.submit(Request(rid=0, prompt=prompts[0], params=SamplingParams(max_new=MAX_NEW, stop=(stop,))))
    eng.submit(Request(rid=1, prompt=prompts[1], params=SamplingParams(max_new=MAX_NEW)))
    stats = eng.run()
    got = {r.rid: r for r in eng.finished}
    cut = jax_steady[0].index(stop) + 1
    assert got[0].generated == jax_steady[0][:cut] and got[0].finish_reason == "stop"
    assert got[1].generated == jax_steady[1] and got[1].finish_reason == "length"
    assert stats.total_requests == 2 and len(stats.ttfts) == 2
    assert stats.tokens_per_sec > 0 and stats.ttft_p50 > 0
    assert stats.kv_bytes_resident == 2 * 2 * SLOTS * MAX_LEN * 4 * 16 * 4


def test_refusals(models):
    _, _, m, p, prompts = models
    eng = ServeEngine(m, p, batch_slots=SLOTS, max_len=MAX_LEN, device="cpu")
    # a sampled request is served (tests/test_torch_sampling.py holds its stream)
    h = eng.submit(Request(rid=0, prompt=prompts[0], params=SamplingParams(temperature=0.7)))
    assert len(h.result()) == 16
    with pytest.raises(ValueError):
        eng.submit(Request(rid=1, prompt=np.zeros(MAX_LEN, np.int32)))
    with pytest.raises(RuntimeError if not torch.cuda.is_available() else ValueError):
        ServeEngine(m, p)  # device=None means the card
