"""The port's ServeCluster against the JAX ServeEngine: every stream a
cluster serves — split over ``["cpu", "cpu"]`` (two replicas, two controller
threads), merge and degenerate split over ``["cpu"]``, across mid-stream
reconfiguration, seeded sampling, speculation, cancels from another thread,
streaming handles, tenant defaults, admission and replica death — must EQUAL
the JAX engine's stream of the same request, weights carried across by
``params_from_jax``.

Reduced codeqwen1.5-7b, 2 slots, max_len 64. One JAX engine serves every
request group once (module fixture); a request's stream does not depend on
its batch-mates, and a group run at fewer new tokens is held to the prefix
of its JAX stream (greedy, and seeded draws keyed by position, are
prefix-stable). The heterogeneous cluster pairs reduced minicpm3-4b (MLA)
with reduced qwen3-32b (G = 4, qk_norm), and qwen3-32b with codeqwen over a
paged int8 pool with prefix reuse (MLA takes no paged or quantized KV).
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.modes import Mode
from repro_torch.models import LM, params_from_jax
from repro_torch.serve import (
    AdmissionPolicy,
    AdmissionRejected,
    FailurePolicy,
    NoModelReplica,
    ReconfigController,
    Request,
    SamplingParams,
    ServeCluster,
    ServeEngine,
    SwitchDecision,
)
from repro_torch.serve.backend import DeviceBackend, PlacementBackend, ShardedBackend

SLOTS, MAX_LEN = 2, 64
ENGINE = dict(batch_slots=SLOTS, max_len=MAX_LEN)
SPLIT2 = ["cpu", "cpu"]  # two replicas on one device
ONE = ["cpu"]  # degenerate split, or the pinned merge engine

# request groups: rid -> (prompt, SamplingParams kwargs, tenant)
GREEDY = range(0, 6)
SAMPLED = range(10, 16)
PATTERNED = range(20, 26)
SEEDED = range(30, 34)


def _specs(vocab: int) -> dict:
    specs = {}
    rng = np.random.default_rng(21)
    for rid, s in zip(GREEDY, (5, 23, 11, 8, 17, 7)):
        specs[rid] = (rng.integers(0, vocab, size=s), dict(max_new=8), None)
    rng = np.random.default_rng(51)
    kinds = [dict(), dict(temperature=0.9, top_p=0.85, seed=11),
             dict(temperature=1.1, top_k=6, seed=22),
             dict(temperature=1.0, top_k=9, top_p=0.9, seed=33)]
    for i, (rid, s) in enumerate(zip(SAMPLED, (5, 12, 8, 17, 9, 7))):
        specs[rid] = (rng.integers(0, vocab, size=s), dict(max_new=10, **kinds[i % 4]), None)
    rng = np.random.default_rng(61)
    for i, rid in enumerate(PATTERNED):  # repetitive prompts a drafter partly predicts
        prompt = np.tile(rng.integers(0, vocab, size=3), 5) if i % 2 == 0 else \
            rng.integers(0, vocab, size=11)
        specs[rid] = (prompt, dict(max_new=6, temperature=0.8 if i % 2 else 0.0,
                                   top_p=0.9 if i % 2 else 1.0, seed=80 + i), None)
    rng = np.random.default_rng(62)
    for i, rid in enumerate(SEEDED):
        specs[rid] = (rng.integers(0, vocab, size=6 + 3 * i),
                      dict(max_new=16, temperature=0.9, top_p=0.85, seed=500 + i), "ab"[i % 2])
    return {rid: (pr.astype(np.int32), kw, t) for rid, (pr, kw, t) in specs.items()}


def _jax_streams(jm, jp, specs, **kw):
    from repro.serve import Request as JaxRequest
    from repro.serve import SamplingParams as JaxSamplingParams
    from repro.serve import ServeEngine as JaxServeEngine

    eng = JaxServeEngine(jm, jp, **{**ENGINE, **kw})
    for rid, (prompt, params, tenant) in specs.items():
        eng.submit(JaxRequest(rid=rid, prompt=prompt, params=JaxSamplingParams(**params),
                              tenant=tenant))
    eng.run()
    return {r.rid: r.generated for r in eng.finished}


def _jax_pair(name: str, key: int):
    """(JAX LM, JAX params, port LM, port params) of the reduced ``name``."""
    import jax

    from repro.configs import get_arch as jax_get_arch
    from repro.models import LM as JaxLM

    jm = JaxLM(jax_get_arch(name).reduced())
    jp = jm.init(jax.random.key(key))
    m = LM(get_arch(name).reduced(), device="cpu")
    return jm, jp, m, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def world():
    """(port LM, port params, request specs, JAX streams, JAX LM, JAX params)."""
    jm, jp, m, p = _jax_pair("codeqwen1.5-7b", 0)
    specs = _specs(m.cfg.vocab_size)
    return m, p, specs, _jax_streams(jm, jp, specs), jm, jp


def _req(world, rid, max_new=None, **kw):
    specs = world[2]
    prompt, params, tenant = specs[rid]
    if max_new is not None:
        params = {**params, "max_new": max_new}
    return Request(rid=rid, prompt=prompt, params=SamplingParams(**params), tenant=tenant, **kw)


def _ref(world, rids, max_new=None):
    ref = world[3]
    return {rid: ref[rid][:max_new] if max_new else ref[rid] for rid in rids}


def _cluster(world, devices, mode=Mode.SPLIT, **kw):
    m, p = world[0], world[1]
    return ServeCluster(m, p, mode=mode, devices=devices, **{**ENGINE, **kw})


def _served(cl):
    return {r.rid: r.generated for r in cl.finished}


# ------------------------------------------------------------ the engine


def test_engine_hooks(world):
    """reset() replays a stream to the same tokens; run(deadline_s=0)
    pauses with the queue intact and resuming equals one run; a busy engine
    refuses reset; device= and backend= must agree; DeviceBackend defaults
    to the card and raises without one."""
    m, p = world[0], world[1]
    eng = ServeEngine(m, p, device="cpu", **ENGINE)
    assert isinstance(eng.backend, DeviceBackend) and eng.backend.stream is None
    reqs = [_req(world, rid, max_new=6) for rid in (0, 1, 2)]
    for r in reqs:
        eng.submit(r)
    eng.run(deadline_s=0.0)
    assert len(eng.waiting) + sum(r.finish_reason is not None for r in reqs) > 0
    eng.run()
    assert _served_engine(eng) == _ref(world, (0, 1, 2), 6)
    eng.reset()
    assert eng.finished == [] and not eng.waiting
    for rid in (0, 1, 2):
        eng.submit(_req(world, rid, max_new=6))
    eng.step()
    with pytest.raises(RuntimeError, match="busy"):
        eng.reset()
    eng.run()
    assert _served_engine(eng) == _ref(world, (0, 1, 2), 6)
    back = PlacementBackend("cpu")
    assert ServeEngine(m, p, backend=back, device="cpu", **ENGINE).backend is back
    assert back.put_params(m, p)["final_norm"] is p["final_norm"]  # already there: no copy
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            DeviceBackend()
        with pytest.raises(RuntimeError):
            ServeCluster(m, p, **ENGINE)  # devices=None means every card
    with pytest.raises(ValueError, match="disagrees"):
        ServeEngine(m, p, backend=back, device="cpu:1", **ENGINE)


def _served_engine(eng):
    return {r.rid: r.generated for r in eng.finished}


def test_cancel_from_another_thread_is_never_lost(world):
    """A thread cancels while another runs the engine: every cancelled
    request ends "cancelled" with a clean prefix of its stream, and every
    other stream is untouched."""
    m, p = world[0], world[1]
    eng = ServeEngine(m, p, device="cpu", **ENGINE)
    rids = list(GREEDY) + list(SAMPLED)
    reqs = {rid: _req(world, rid) for rid in rids}
    for r in reqs.values():
        eng.submit(r)
    victims = [1, 4, 11, 14, 15]

    def cancel_all():
        for rid in victims:
            time.sleep(0.01)
            eng.cancel(reqs[rid])

    t = threading.Thread(target=cancel_all)
    t.start()
    eng.run()
    t.join()
    eng.run()  # a cancel landing after the loop ended is applied here
    ref = _ref(world, rids)
    for rid, r in reqs.items():
        assert r.finish_reason is not None, rid
        if rid in victims and r.finish_reason == "cancelled":
            assert r.generated == ref[rid][: len(r.generated)]
            assert r.n_generated == len(r.generated)
        else:
            assert r.generated == ref[rid], rid
    assert not eng._cancels


# ------------------------------------------------------- cluster modes


@pytest.mark.parametrize("devices,mode", [(SPLIT2, Mode.SPLIT), (ONE, Mode.MERGE)])
def test_cluster_matches_single_engine(world, devices, mode):
    cl = _cluster(world, devices, mode)
    for rid in GREEDY:
        cl.submit(_req(world, rid, max_new=4))
    stats = cl.run()
    assert _served(cl) == _ref(world, GREEDY, 4)
    assert stats.total_requests == len(GREEDY) and stats.mode == str(mode)
    assert stats.total_tokens > 0 and stats.wall_seconds > 0
    if mode is Mode.SPLIT:
        assert cl.n_replicas == 2 and min(cl.router.assigned) >= 1
        assert cl.engines[0].params is cl.engines[1].params  # one copy of the weights


def test_placement_rules(world):
    """Merge over a repeated device is tensor-parallel serving over two lanes
    of it (a ShardedBackend, model axis 2), built at construction or by a
    switch from split that carries a queued request; both serve the JAX
    engine's streams."""
    m, p = world[0], world[1]
    cl = ServeCluster(m, p, mode=Mode.MERGE, devices=SPLIT2, **ENGINE)
    back = cl.engines[0].backend
    assert isinstance(back, ShardedBackend) and back.mesh_info.model_size == 2
    assert cl.n_replicas == 1 and cl.engines[0].model.merged
    for rid in GREEDY:
        cl.submit(_req(world, rid, max_new=4))
    cl.run()
    assert _served(cl) == _ref(world, GREEDY, 4)
    cl = _cluster(world, SPLIT2)
    r = _req(world, 0, max_new=3)
    cl.submit(r)
    rep = cl.reconfigure(Mode.MERGE)
    assert cl.mode is Mode.MERGE and not rep.cached and rep.bytes_moved > 0
    assert list(cl.engines[0].waiting) == [r]
    cl.run()
    assert r.generated == _ref(world, [0], 3)[0]


def test_reconfigure_carries_waiting(world):
    cl = _cluster(world, ONE)
    reqs = [_req(world, rid, max_new=4) for rid in (0, 1, 2, 3)]
    for r in reqs:
        cl.submit(r)
    t_before = [r.submitted_at for r in reqs]
    rep = cl.reconfigure(Mode.MERGE)
    assert cl.mode is Mode.MERGE and rep.place_seconds >= 0 and not rep.cached
    assert rep.bytes_moved == sum(t.numel() * t.element_size()
                                  for t in cl.engines[0].cache.values())
    assert [r.submitted_at for r in reqs] == t_before
    cl.run()
    assert _served(cl) == _ref(world, (0, 1, 2, 3), 4)
    rep2 = cl.reconfigure(Mode.SPLIT)  # warm: the fabric is kept
    assert rep2.cached and rep2.bytes_moved == 0 and len(cl.reconfigures) == 2


@pytest.mark.parametrize("group,kw", [(GREEDY, {}), (SAMPLED, {}),
                                      (PATTERNED, dict(speculate="ngram"))])
def test_mid_stream_reconfigure(world, group, kw):
    """SPLIT -> MERGE mid-stream (greedy, seeded, speculating): drain,
    re-home, resume; every stream equals the uninterrupted engine's."""
    cl = _cluster(world, ONE, **kw)
    n = 6 if group is PATTERNED else 5
    arrivals = [(i * 0.002, _req(world, rid, max_new=n)) for i, rid in enumerate(group)]
    stats = cl.run(arrivals=arrivals, reconfigure_schedule=[(0.005, Mode.MERGE)])
    assert _served(cl) == _ref(world, group, n)
    assert len(stats.reconfigures) == 1 and stats.mode == "split->merge"
    assert stats.total_requests == len(group)
    assert stats.wall_seconds >= stats.reconfigures[0].place_seconds
    if kw:
        assert stats.spec_ticks > 0 and stats.spec_accepted <= stats.spec_proposed


@pytest.mark.parametrize("devices,mode", [(SPLIT2, Mode.SPLIT), (ONE, Mode.MERGE)])
def test_seeded_sampling_and_speculation(world, devices, mode):
    cl = _cluster(world, devices, mode)
    for rid in SAMPLED:
        cl.submit(_req(world, rid, max_new=5))
    cl.run()
    assert _served(cl) == _ref(world, SAMPLED, 5)
    cl = _cluster(world, devices, mode, speculate="ngram")
    for rid in PATTERNED:
        cl.submit(_req(world, rid))
    stats = cl.run()
    assert _served(cl) == _ref(world, PATTERNED)
    assert stats.spec_ticks > 0 and stats.spec_accepted <= stats.spec_proposed


def test_tenant_defaults(world):
    """A request without sampling config takes its tenant's default, explicit
    params win, the defaults survive a reconfigure and apply to arrival
    streams too."""
    defaults = {"free": SamplingParams(max_new=2), "pro": SamplingParams(max_new=3)}
    cl = _cluster(world, ONE, tenant_defaults=defaults)
    prompt = lambda rid: world[2][rid][0]  # noqa: E731
    r_free = Request(rid=0, prompt=prompt(0), tenant="free")
    r_pro = Request(rid=1, prompt=prompt(1), tenant="pro")
    r_explicit = Request(rid=2, prompt=prompt(2), tenant="free",
                         params=SamplingParams(max_new=4))
    r_other = Request(rid=3, prompt=prompt(3), tenant="unknown",
                      params=SamplingParams(max_new=8))
    for r in (r_free, r_pro, r_explicit, r_other):
        cl.submit(r)
    assert r_free.params == defaults["free"] and r_pro.params == defaults["pro"]
    assert r_explicit.params.max_new == 4 and r_other.params.max_new == 8
    assert Request(rid=9, prompt=prompt(3), tenant="unknown").params == SamplingParams()
    cl.reconfigure(Mode.MERGE)
    assert r_free.params == defaults["free"]
    late = Request(rid=4, prompt=prompt(4), tenant="pro")
    cl.run(arrivals=[(0.0, late)])
    ref = _ref(world, range(5))
    got = {r.rid: r.generated for r in (r_free, r_pro, r_explicit, r_other, late)}
    assert got == {0: ref[0][:2], 1: ref[1][:3], 2: ref[2][:4], 3: ref[3], 4: ref[4][:3]}
    assert late.params == defaults["pro"]


def test_cancel_follows_reconfigure(world):
    cl = _cluster(world, ONE)
    reqs = [_req(world, rid, max_new=4) for rid in (0, 1, 2)]
    handles = [cl.submit(r) for r in reqs]
    cl.reconfigure(Mode.MERGE)
    handles[1].cancel()
    assert handles[1].finish_reason == "cancelled"
    cl.run()
    served = {r.rid: r.generated for r in cl.finished if r.finish_reason != "cancelled"}
    assert served == _ref(world, (0, 2), 4) and reqs[1].generated == []


def test_mid_stream_cancel_preserves_other_streams(world):
    """A cancel from another thread while two controller threads serve:
    the cancelled stream is a clean prefix, every neighbour is untouched."""
    cl = _cluster(world, SPLIT2)
    rids = (10, 11, 12, 13)
    handles = {rid: cl.submit(_req(world, rid)) for rid in rids}
    timer = threading.Timer(0.02, handles[12].cancel)
    timer.start()
    try:
        cl.run()
    finally:
        timer.cancel()
        timer.join()
    by = {r.rid: r for r in cl.finished}
    ref = _ref(world, rids)
    for rid in (10, 11, 13):
        assert by[rid].generated == ref[rid], rid
    cut = by[12].generated
    assert cut == ref[12][: len(cut)]
    if by[12].finish_reason == "cancelled":
        assert by[12].n_generated == len(cut)


@pytest.mark.parametrize("devices,mode", [(SPLIT2, Mode.SPLIT), (ONE, Mode.MERGE)])
def test_handle_streaming_without_run(world, devices, mode):
    cl = _cluster(world, devices, mode)
    handles = [cl.submit(_req(world, rid, max_new=5)) for rid in (3, 5)]
    ref = _ref(world, (3, 5), 5)
    assert list(handles[0].tokens()) == ref[3]
    assert handles[1].result() == ref[5]
    assert all(h.done for h in handles) and len(cl._where) == 0
    if mode is Mode.SPLIT:
        assert sorted(h.replica for h in handles) == [0, 1]


# ------------------------------- supervision: control loop, admission, failure


def test_run_controlled_matches_reference(world):
    """The control loop (intervals, observation) is invisible to the
    streams; on one device the perfmodel never finds a switch worth it."""
    cl = _cluster(world, ONE)
    ctl = ReconfigController.for_cluster(cl, interval_s=0.05)
    arrivals = [(i * 0.002, _req(world, rid, max_new=5)) for i, rid in enumerate(SAMPLED)]
    stats = cl.run_controlled(arrivals, controller=ctl)
    assert _served(cl) == _ref(world, SAMPLED, 5)
    assert stats.total_requests == len(SAMPLED)
    assert ctl.switch_times == [] and len(ctl.samples) > 0


def test_run_controlled_scripted_switch(world):
    class Scripted:
        interval_s = 0.03

        def __init__(self):
            self.observed, self.switched = 0, []

        def observe(self, sample, *, warm_target=False):
            self.observed += 1
            if self.observed == 2:
                return SwitchDecision(mode=Mode.MERGE, predicted_win_s=1.0, switch_cost_s=0.0)
            return None

        def note_switched(self, t, report=None):
            self.switched.append((t, report))

    cl = _cluster(world, ONE)
    ctl = Scripted()
    arrivals = [(i * 0.02, _req(world, rid, max_new=5)) for i, rid in enumerate(GREEDY)]
    stats = cl.run_controlled(arrivals, controller=ctl)
    assert _served(cl) == _ref(world, GREEDY, 5)
    assert cl.mode is Mode.MERGE and len(ctl.switched) == 1 and len(stats.reconfigures) == 1
    assert "merge" in stats.mode


def test_admission_sheds_under_burst(world):
    """A burst beyond capacity: deadline shedding rejects up front (typed,
    done_at set), the admitted finish with their JAX streams, and the
    counters account for every request."""
    cl = _cluster(world, ONE, admission=AdmissionPolicy(max_queue=4, initial_tok_per_s=50.0))
    cl.prewarm()
    rids = [list(GREEDY)[i % 6] for i in range(12)]
    reqs = [_req(world, rid, max_new=8, deadline_s=0.05) for rid in rids]
    ctl = ReconfigController.for_cluster(cl, interval_s=0.05)
    stats = cl.run_controlled([(i * 0.001, r) for i, r in enumerate(reqs)], controller=ctl)
    shed = [r for r in reqs if r.finish_reason == "rejected"]
    served = [r for r in reqs if r.finish_reason == "length"]
    assert shed and served and len(shed) + len(served) == len(reqs)
    assert all(r.reject_reason == "shed_deadline" for r in shed)
    assert all(r.done_at >= r.submitted_at > 0 for r in shed)
    ref = _ref(world, GREEDY, 8)
    assert all(r.generated == ref[r.rid] for r in served)
    assert stats.shed == len(shed) and stats.rejected == 0 and stats.queue_peak >= 1


def test_submit_queue_full_typed(world):
    cl = _cluster(world, ONE, admission=AdmissionPolicy(max_queue=2))
    admitted = 0
    with pytest.raises(AdmissionRejected) as e:
        for rid in GREEDY:
            cl.submit(_req(world, rid, max_new=3))
            admitted += 1
    assert e.value.reason == "queue_full" and isinstance(e.value, ValueError)
    assert admitted == 2
    cl.run()
    assert _served(cl) == _ref(world, (0, 1), 3)


def test_replica_death_rehomes_token_for_token(world):
    """Kill one of two split replicas mid-decode (an injected controller
    stall: straggler, then dead): its live requests re-home onto the
    survivor, and every seeded stream completes equal to the JAX engine's;
    later submissions avoid the dead replica."""
    ticks: dict[int, int] = {}
    lock = threading.Lock()

    def stall(idx: int) -> None:
        with lock:
            ticks[idx] = ticks.get(idx, 0) + 1
            n = ticks[idx]
        if idx == 1 and n == 3:
            time.sleep(2.0)  # a hung controller thread: its heartbeats stop

    cl = _cluster(world, SPLIT2, failure=FailurePolicy(
        straggler_after=0.3, dead_after=0.8, poll=0.02, tick_hook=stall))
    cl.prewarm(sampling=True)
    reqs = [_req(world, rid) for rid in SEEDED]
    for r in reqs:
        cl.submit(r)
    stats = cl.run()
    assert _served(cl) == _ref(world, SEEDED)
    assert all(r.finish_reason == "length" for r in reqs)
    assert stats.dead_replicas == 1 and stats.rehomed >= 1 and stats.stragglers >= 1
    late = [_req(world, rid, max_new=4) for rid in (0, 1)]
    for r in late:
        assert cl.submit(r).replica == 0
    cl.run()
    assert {r.rid: r.generated for r in late} == _ref(world, (0, 1), 4)


def test_replica_death_waits_for_a_slow_rehoming(world):
    """A replica is marked dead before its requests move, so run() can see
    the death while the watchdog thread is still re-homing. With the moves
    outlasting the watchdog's default stop timeout (2 s), run() must still
    wait for them and drain them on the survivor."""
    ticks: dict[int, int] = {}
    lock = threading.Lock()

    def stall(idx: int) -> None:
        with lock:
            ticks[idx] = ticks.get(idx, 0) + 1
            n = ticks[idx]
        if idx == 1 and n == 3:
            time.sleep(3.0)

    cl = _cluster(world, SPLIT2, failure=FailurePolicy(
        straggler_after=0.3, dead_after=0.8, poll=0.02, tick_hook=stall))
    move = cl._resubmit_rehomed
    slowed: list = []

    def slow_move(req):
        if not slowed:  # the first move only: 2.5 s
            slowed.append(req.rid)
            time.sleep(2.5)
        move(req)

    cl._resubmit_rehomed = slow_move
    reqs = [_req(world, rid) for rid in SEEDED]
    for r in reqs:
        cl.submit(r)
    stats = cl.run()
    assert slowed and stats.dead_replicas == 1 and stats.rehomed >= 1
    assert all(r.finish_reason == "length" for r in reqs)
    assert _served(cl) == _ref(world, SEEDED)


# =============================== heterogeneous (multi-model) clusters ======


@pytest.fixture(scope="module")
def hetero(world):
    """MLA (reduced minicpm3-4b) beside GQA (reduced qwen3-32b); the prompts
    and each model's JAX streams, plain and (GQA beside reduced codeqwen)
    over a paged int8 pool with prefix reuse."""
    mla = _jax_pair("minicpm3-4b", 6)
    gqa = _jax_pair("qwen3-32b", 7)
    mha = (world[4], world[5], world[0], world[1])
    rng = np.random.default_rng(41)
    common = rng.integers(0, 200, size=16)
    prompts = {i: rng.integers(0, 200, size=s).astype(np.int32)
               for i, s in enumerate((5, 9, 7, 11, 6, 8))}
    for i in (6, 7, 8):  # a shared 16-token prefix: the tree must hit
        prompts[i] = np.concatenate([common, rng.integers(0, 200, size=3 + i)]).astype(np.int32)
    specs = {i: (pr, dict(max_new=5), None) for i, pr in prompts.items()}
    paged = dict(kv_block_size=8, prefix_cache=True, kv_dtype="int8")
    refs = {"mla": _jax_streams(*mla[:2], specs), "gqa": _jax_streams(*gqa[:2], specs),
            "gqa_paged": _jax_streams(*gqa[:2], specs, **paged),
            "mha_paged": _jax_streams(*mha[:2], specs, **paged)}
    return dict(mla=mla[2:], gqa=gqa[2:], mha=mha[2:], prompts=prompts, refs=refs, paged=paged)


def _hetero_cluster(h, names=("mla", "gqa"), **kw):
    return ServeCluster(models={n: h[n] for n in names}, devices=SPLIT2, **{**ENGINE, **kw})


def test_hetero_routes_by_tenant_and_model(hetero):
    h = hetero
    cl = _hetero_cluster(h, tenant_models={"alice": "mla", "bob": "gqa"})
    assert cl.replica_plan() == {"mla": [0], "gqa": [1]}
    pr = h["prompts"]
    reqs = [Request(rid=0, prompt=pr[0], tenant="alice", params=SamplingParams(max_new=5)),
            Request(rid=1, prompt=pr[1], tenant="bob", params=SamplingParams(max_new=5)),
            Request(rid=2, prompt=pr[2], model="gqa", params=SamplingParams(max_new=5)),
            Request(rid=3, prompt=pr[3], params=SamplingParams(max_new=5))]
    for r in reqs:
        cl.submit(r)
    cl.run()
    got = {r.rid: (r.model, r.generated) for r in cl.finished}
    assert got == {0: ("mla", h["refs"]["mla"][0]), 1: ("gqa", h["refs"]["gqa"][1]),
                   2: ("gqa", h["refs"]["gqa"][2]), 3: ("mla", h["refs"]["mla"][3])}


def test_hetero_paged_int8_prefix(hetero):
    """The grouped path beside the plain one over paged int8 pools with
    prefix reuse (the engine kwargs pass through to each replica): every
    stream equals its model's JAX engine's, and the shared prefix hits."""
    h = hetero
    cl = _hetero_cluster(h, names=("gqa", "mha"), **h["paged"])
    for i, pr in h["prompts"].items():
        cl.submit(Request(rid=i, prompt=pr, model="gqa" if i % 2 else "mha",
                          params=SamplingParams(max_new=5)))
    cl.run()
    for r in cl.finished:
        assert r.generated == h["refs"][f"{r.model}_paged"][r.rid], (r.model, r.rid)
    assert len(cl.finished) == len(h["prompts"])
    assert all(e.paged and e.kv_dtype == torch.int8 for e in cl.engines)
    assert sum(e.prefix.stats().hit_tokens for e in cl.engines) > 0


def test_hetero_refusals_and_cross_model_death(hetero):
    """An unknown model is a typed NoModelReplica; merge is refused at init
    and at reconfigure; killing a model's only replica closes its requests
    out as rejected instead of serving them on the other model, while the
    other model keeps serving its streams; a controller demanding MERGE is
    overruled."""
    h = hetero
    cl = _hetero_cluster(h)
    with pytest.raises(NoModelReplica) as e:
        cl.submit(Request(rid=0, prompt=np.zeros(4, np.int32), model="nope"))
    assert isinstance(e.value, AdmissionRejected) and e.value.reason == "infeasible"
    with pytest.raises(ValueError, match="split-only"):
        cl.reconfigure(Mode.MERGE)
    with pytest.raises(ValueError, match="split-only"):
        ServeCluster(models={"a": h["mla"], "b": h["gqa"]}, mode=Mode.MERGE, devices=SPLIT2,
                     **ENGINE)
    pr = h["prompts"]
    doomed = Request(rid=1, prompt=pr[1], model="gqa", params=SamplingParams(max_new=5))
    alive = Request(rid=0, prompt=pr[0], model="mla", params=SamplingParams(max_new=5))
    cl.submit(doomed)
    cl.submit(alive)
    cl._rehome_dead(cl.replica_plan()["gqa"][0])
    cl.run()
    assert doomed.finish_reason == "rejected" and doomed.reject_reason == "infeasible"
    assert alive.finish_reason == "length" and alive.generated == h["refs"]["mla"][0]
    with pytest.raises(NoModelReplica):
        cl.submit(Request(rid=2, prompt=pr[1], model="gqa"))
    late_gqa = Request(rid=3, prompt=pr[1], model="gqa", params=SamplingParams(max_new=3))
    late_mla = Request(rid=4, prompt=pr[3], model="mla", params=SamplingParams(max_new=3))
    cl.run(arrivals=[(0.0, late_gqa), (0.0, late_mla)])
    assert late_gqa.finish_reason == "rejected" and late_gqa.reject_reason == "infeasible"
    assert late_mla.generated == h["refs"]["mla"][3][:3]

    class MergeHappy:
        interval_s = 0.03
        switched = []

        def observe(self, sample, *, warm_target=False):
            return SwitchDecision(mode=Mode.MERGE, predicted_win_s=1.0, switch_cost_s=0.0)

        def note_switched(self, t, report=None):
            self.switched.append(t)

    cl = _hetero_cluster(h)
    reqs = [Request(rid=i, prompt=pr[i], model=("mla", "gqa")[i % 2],
                    params=SamplingParams(max_new=4)) for i in range(4)]
    stats = cl.run_controlled([(i * 0.01, r) for i, r in enumerate(reqs)],
                              controller=MergeHappy())
    assert cl.mode is Mode.SPLIT and stats.reconfigures == []
    for r in reqs:
        assert r.generated == h["refs"][r.model][r.rid][:4], r.rid


@pytest.mark.cuda
def test_cuda_two_replicas_on_one_card_equal_the_cpu():
    """Two replicas pinned to one card (two streams, two controller threads,
    one copy of the weights) serve the CPU engine's greedy and seeded
    streams at f32; merge on the card too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_arch("codeqwen1.5-7b").reduced()
    m = LM(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    dev = torch.device("cuda", 0)
    mc = LM(cfg, device=dev)
    pc = DeviceBackend(dev).put_params(mc, p)
    specs = _specs(cfg.vocab_size)
    rids = list(GREEDY) + list(SAMPLED)

    def reqs():
        return [Request(rid=rid, prompt=specs[rid][0],
                        params=SamplingParams(**{**specs[rid][1], "max_new": 8}))
                for rid in rids]

    eng = ServeEngine(m, p, device="cpu", **ENGINE)
    for r in reqs():
        eng.submit(r)
    eng.run()
    ref = _served_engine(eng)
    for devices, mode in (([dev, dev], Mode.SPLIT), ([dev], Mode.MERGE)):
        cl = ServeCluster(mc, pc, mode=mode, devices=devices, **ENGINE)
        for r in reqs():
            cl.submit(r)
        cl.run()
        assert _served(cl) == ref
        assert len({e.backend.stream for e in cl.engines}) == len(cl.engines)


def test_run_controlled_never_merges_a_repeated_device(world):
    """Two replicas on one device fuse into one engine over two lanes of it:
    a controller demanding MERGE commits the switch (tensor-parallel over
    the lanes), and every stream is served as the JAX engine serves it."""
    class MergeHappy:
        interval_s = 0.03

        def __init__(self):
            self.switched = []

        def observe(self, sample, *, warm_target=False):
            return SwitchDecision(mode=Mode.MERGE, predicted_win_s=1.0, switch_cost_s=0.0)

        def note_switched(self, t, report=None):
            self.switched.append(report)

    cl = _cluster(world, SPLIT2)
    ctl = MergeHappy()
    arrivals = [(i * 0.01, _req(world, rid, max_new=5)) for i, rid in enumerate(SAMPLED)]
    stats = cl.run_controlled(arrivals, controller=ctl)
    assert cl.mode is Mode.MERGE and len(stats.reconfigures) == 1 and len(ctl.switched) == 1
    assert isinstance(cl.engines[0].backend, ShardedBackend)
    assert cl.engines[0].backend.mesh_info.model_size == 2
    assert _served(cl) == _ref(world, SAMPLED, 5)


@pytest.mark.cuda
def test_cuda_merged_logits_equal_the_single_engine():
    """The merged LM over [cuda:0, cuda:0] (two lanes, two streams) against
    the plain LM on the card at f32: prefill, decode and packed logits
    within 1e-5 of the largest, and its engine's greedy streams equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.dist.sharding import serving_mesh_info

    dev = torch.device("cuda", 0)
    cfg = get_arch("codeqwen1.5-7b").reduced()
    m = LM(cfg, device=dev)
    p = m.init(torch.Generator(device=dev).manual_seed(0))
    info = serving_mesh_info([dev, dev])
    mm = LM(cfg, mesh_info=info)
    sp = ShardedBackend(info).put_params(mm, p)
    toks = torch.randint(0, cfg.vocab_size, (3, 11), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    want, cache = m.prefill(p, {"tokens": toks}, 32)
    got, scache = mm.prefill(sp, {"tokens": toks}, 32)
    cur = torch.tensor([11, 7, 0], dtype=torch.int32, device=dev)
    step = toks[:, -1:]
    w2, _ = m.decode_step(p, cache, {"tokens": step}, cur)
    g2, _ = mm.decode_step(sp, scache, {"tokens": step}, cur)
    for g, w in ((got, want), (g2, w2)):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    specs = _specs(cfg.vocab_size)
    reqs = lambda: [Request(rid=rid, prompt=specs[rid][0],  # noqa: E731
                            params=SamplingParams(max_new=8)) for rid in GREEDY]
    eng = ServeEngine(m, p, device=dev, **ENGINE)
    for r in reqs():
        eng.submit(r)
    eng.run()
    cl = ServeCluster(m, p, mode=Mode.MERGE, devices=[dev, dev], **ENGINE)
    for r in reqs():
        cl.submit(r)
    cl.run()
    assert _served(cl) == _served_engine(eng)


@pytest.mark.cuda
def test_cuda_two_lanes_keep_split_scratch_apart():
    """Two lanes of one card run the split decode kernel on their own
    streams: each (device, stream) has its own ticket counters, and both
    lanes' outputs equal one stream's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.dist.sharding import serving_mesh_info
    from repro_torch.kernels import _checks
    from repro_torch.kernels import decode_attention as dk

    dev = torch.device("cuda", 0)
    lanes = serving_mesh_info([dev, dev]).mesh.lanes
    g = torch.Generator(device=dev).manual_seed(2)
    b, s, kv, hd = 4, 1024, 16, 128
    q = torch.randn(b, kv, 1, hd, device=dev, generator=g, dtype=torch.bfloat16)
    k = torch.randn(b, s, kv, hd, device=dev, generator=g, dtype=torch.bfloat16)
    v = torch.randn(b, s, kv, hd, device=dev, generator=g, dtype=torch.bfloat16)
    cur = torch.tensor([1000, 513, 64, 1], dtype=torch.int32, device=dev)
    want = dk.decode_attention(q, k, v, cur, splits=4)
    outs = []
    for lane in lanes:  # both lanes at once, each after the inputs exist
        lane.stream.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(4):
        for lane in lanes:
            with lane.use():
                outs.append(dk.decode_attention(q, k, v, cur, splits=4))
    torch.cuda.synchronize(dev)
    keys = {(dev.index, lane.stream.cuda_stream) for lane in lanes}
    assert len(keys) == 2 and keys <= set(_checks._tickets)
    for o in outs:
        assert torch.equal(o, want)
