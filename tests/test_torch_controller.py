"""The port's serving supervisor against the JAX package's, host-side only.

* ``core/perfmodel.py``: every function equal to JAX's to 1e-12 relative,
  both sides given the same ``HardwareModel`` fields (the port's built from
  the JAX package's defaults here, and JAX's from the port's H100 defaults);
* ``ReconfigController``: the same decisions, switch costs and switch times
  as JAX's on scripted windows, ``for_cluster``'s per-token costs from the
  resident tensors;
* ``AdmissionController``: the same admissions, reasons and counters on a
  fake clock; ``build_continuation``, ``Router``, ``model_token_cost`` and
  ``plan_hetero_placement`` equal to JAX's;
* ``Watchdog``: the same lane states as JAX's on a fake clock.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from repro.core import perfmodel as jpm
from repro.core.modes import Mode as JaxMode
from repro.serve import controller as jctl
from repro.serve import cluster as jcluster
from repro.serve import engine as jeng
from repro.serve import sampling as jsamp
from repro_torch.core import perfmodel as pm
from repro_torch.core.modes import Mode
from repro_torch.serve import controller as ctl
from repro_torch.serve.cluster import NoModelReplica, Router
from repro_torch.serve.engine import AdmissionRejected, Request
from repro_torch.serve.sampling import SamplingParams

RTOL = 1e-12


def _hw_pair(which: str):
    """(JAX HardwareModel, port HardwareModel) with the same fields."""
    fields = dataclasses.asdict(jpm.V5E if which == "jax" else pm.H100)
    return jpm.HardwareModel(**fields), pm.HardwareModel(**fields)


def _close(a, b):
    return math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0)


def _run_eq(a, b):
    """Two ModeledRun objects equal field by field to RTOL."""
    for f in ("makespan", "vector_busy", "scalar_busy", "host_exchange_bytes", "energy_j"):
        assert _close(getattr(a, f), getattr(b, f)), f
    assert a.launches == b.launches


KERNELS = [(f"k{i}", 1e9 * (i + 1) ** 2, 3e8 * (5 - i), 1e6 * i) for i in range(5)]
MIXES = [
    dict(n_requests=64, prompt_tokens=1024.0, decode_tokens=128.0, longest_tokens=2.0,
         flops_per_token=2e9, hbm_bytes_per_token=1e9),
    dict(n_requests=2, prompt_tokens=32.0, decode_tokens=512.0, longest_tokens=256.0,
         flops_per_token=2e9, hbm_bytes_per_token=1e9),
    dict(n_requests=32, prompt_tokens=5200.0 + 480.0, decode_tokens=1024.0,
         longest_tokens=32.0, flops_per_token=1.6e10, hbm_bytes_per_token=1.6e10,
         coll_bytes_per_token=3e5, prefill_budget=64, max_chunk=8, batch_slots=4),
    dict(n_requests=3, prompt_tokens=0.0, decode_tokens=7.0, longest_tokens=5.0,
         flops_per_token=1e6, hbm_bytes_per_token=2e6, prefill_budget=16, max_chunk=1,
         batch_slots=2),
]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_perfmodel_equals_jax(which):
    jhw, hw = _hw_pair(which)
    jk = [jpm.KernelCost(*k) for k in KERNELS]
    pk = [pm.KernelCost(*k) for k in KERNELS]
    for a, b in zip(jk, pk):
        for chips in (1, 2, 4):
            assert _close(a.device_seconds(chips, jhw), b.device_seconds(chips, hw))
        assert _close(a.energy_j(jhw), b.energy_j(hw))
    for chips in (1, 4):
        ja, pa = jpm.model_vector_stream(jk, chips, jhw), pm.model_vector_stream(pk, chips, hw)
        assert _close(ja[0], pa[0]) and _close(ja[1], pa[1])
    _run_eq(jpm.model_mixed_split(jk, 0.01, 2, jhw), pm.model_mixed_split(pk, 0.01, 2, hw))
    _run_eq(jpm.model_mixed_merge(jk, 0.5, 4, jhw, 1e7),
            pm.model_mixed_merge(pk, 0.5, 4, hw, 1e7))
    for over in ("ici", "pcie"):
        _run_eq(jpm.model_staged_split(jk[2], 3, 4e8, 2, 2, jhw, over),
                pm.model_staged_split(pk[2], 3, 4e8, 2, 2, hw, over))
    _run_eq(jpm.model_staged_merge(jk[3], 3, 4e8, 4, jhw),
            pm.model_staged_merge(pk[3], 3, 4e8, 4, hw))
    for mix in MIXES:
        jm, m = jpm.ServingMix(**mix), pm.ServingMix(**mix)
        for n in (1, 2, 4):
            for mode in ("split", "merge"):
                assert _close(jpm.model_serving_mode(jm, n, mode, jhw),
                              pm.model_serving_mode(m, n, mode, hw))
            jbest, js = jpm.serving_mode_advice(jm, n, jhw)
            best, s = pm.serving_mode_advice(m, n, hw)
            assert best == jbest and all(_close(js[k], s[k]) for k in js)


def test_h100_defaults():
    """The data sheet's peaks, and no field left at the JAX package's value
    but the energy model's parameters."""
    hw = pm.H100
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.pcie_bw) == (989e12, 3.35e12, 450e9, 64e9)
    assert 0 < hw.launch_overhead < hw.barrier_overhead < 1e-3
    differ = {f for f, v in dataclasses.asdict(hw).items()
              if v != dataclasses.asdict(jpm.V5E)[f]}
    assert differ == {"peak_flops", "hbm_bw", "ici_bw", "pcie_bw", "launch_overhead",
                      "barrier_overhead"}
    assert ctl.ControllerConfig().hw == hw
    assert Mode.parse("MERGE") is Mode.MERGE and str(Mode.SPLIT) == "split"
    assert [m.value for m in Mode] == [m.value for m in JaxMode]


# ------------------------------------------------------ the decision loop


class _Rep:
    def __init__(self, seconds, cached):
        self.seconds, self.cached = seconds, cached


def _script():
    """(t, mode, mix index or None for idle, report after a commit) windows:
    long decodes while split, short bursts while merged, idle gaps."""
    out = []
    t = 0.0
    plan = [1, 1, 1, None, 1, 0, 0, 0, 0, 2, 2, 2, None, 1, 1, 0, 3, 3, 1, 1, 1, 1]
    for i, k in enumerate(plan):
        t += 0.1 + 0.03 * (i % 3)
        out.append((t, k))
    return out


@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("which", ["jax", "port"])
def test_reconfig_decisions_equal_jax(n_devices, which):
    jhw, hw = _hw_pair(which)
    kw = dict(interval_s=0.1, window_s=0.25, cooldown_s=0.5, confirm=2, hysteresis=1.5,
              cold_switch_s=0.02, warm_switch_s=0.002)
    jc = jctl.ReconfigController(n_devices, jctl.ControllerConfig(hw=jhw, **kw))
    c = ctl.ReconfigController(n_devices, ctl.ControllerConfig(hw=hw, **kw))
    mode = "split"
    decided = 0
    for step, (t, k) in enumerate(_script()):
        mix = MIXES[k] if k is not None else dict(
            n_requests=0, prompt_tokens=0.0, decode_tokens=0.0, longest_tokens=0.0)
        sample = dict(t=t, mode=mode, queue_depth=step % 4, n_requests=mix["n_requests"],
                      prompt_tokens=int(mix["prompt_tokens"]),
                      decode_tokens=int(mix["decode_tokens"]),
                      longest_tokens=int(mix["longest_tokens"]), n_tenants=step % 3)
        warm = step % 2 == 1
        jd = jc.observe(jctl.WindowSample(**sample), warm_target=warm)
        d = c.observe(ctl.WindowSample(**sample), warm_target=warm)
        assert (jd is None) == (d is None), step
        if d is None:
            continue
        decided += 1
        assert d.mode.value == jd.mode.value
        assert _close(d.predicted_win_s, jd.predicted_win_s)
        assert _close(d.switch_cost_s, jd.switch_cost_s)
        rep = (0.013 * (step + 1), step % 3 == 0)
        jc.note_switched(t, _Rep(*rep))
        c.note_switched(t, _Rep(*rep))
        mode = d.mode.value
    assert c.switch_times == jc.switch_times
    assert all(_close(c.switch_cost(w), jc.switch_cost(w)) for w in (False, True))
    if n_devices > 1:
        assert decided > 0  # the script exercises commits, not just holds


def test_for_cluster_reads_resident_tensors():
    """Per-token costs from the resident tree: bytes as held (int8 leaves
    count one byte), FLOPs from the element count; scheduling constants
    from the cluster's engine kwargs; devices from the cluster."""
    eng = types.SimpleNamespace(params={
        "a": torch.zeros(3, 4, dtype=torch.bfloat16),
        "b": {"q8": torch.zeros(10, dtype=torch.int8), "scale": torch.zeros(2)},
        "blocks": [torch.zeros(5)],
    })
    fake = types.SimpleNamespace(
        _fabrics={Mode.SPLIT: [eng]}, mode=Mode.SPLIT, params=None,
        _engine_kw=dict(prefill_budget=32, max_chunk=4, batch_slots=2),
        devices=["d0", "d0", "d1"],
    )
    c = ctl.ReconfigController.for_cluster(fake, interval_s=0.2)
    assert c.cfg.hbm_bytes_per_token == 3 * 4 * 2 + 10 + 2 * 4 + 5 * 4
    assert c.cfg.flops_per_token == 2.0 * (12 + 10 + 2 + 5)
    assert (c.cfg.prefill_budget, c.cfg.max_chunk, c.cfg.batch_slots) == (32, 4, 2)
    assert c.interval_s == 0.2 and c.n_devices == 3


# ------------------------------------------------------ admission control


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _both_req(rid, plen, max_new, tenant=None, deadline_s=None):
    kw = dict(rid=rid, prompt=np.zeros(plen, np.int32), tenant=tenant, deadline_s=deadline_s)
    return (jeng.Request(params=jsamp.SamplingParams(max_new=max_new), **kw),
            Request(params=SamplingParams(max_new=max_new), **kw))


def test_admission_equals_jax():
    """A scripted arrival sequence through both controllers: the same
    admissions, the same typed reasons, the same counters, with rate
    feedback and clock advances between arrivals."""
    def policy(mod):
        return mod.AdmissionPolicy(
            max_queue=4, priority_headroom=2.0, initial_tok_per_s=None, rate_ewma=0.5,
            tenants={"a": mod.TenantPolicy(rate=16.0, burst=32.0),
                     "vip": mod.TenantPolicy(rate=math.inf, burst=math.inf, priority=1),
                     "slow": mod.TenantPolicy(rate=4.0, burst=20.0)},
        )

    jclock, clock = FakeClock(), FakeClock()
    jadm = jctl.AdmissionController(policy(jctl), clock=jclock)
    adm = ctl.AdmissionController(policy(ctl), clock=clock)
    rng = np.random.default_rng(5)
    tenants = ["a", "vip", "slow", None, "b"]
    for i in range(80):
        t = float(i) * 0.3 + float(rng.uniform(0, 0.2))
        jclock.t = clock.t = t
        if i in (20, 41, 63):
            rate = 20.0 + i
            jadm.note_service_rate(rate)
            adm.note_service_rate(rate)
        jr, r = _both_req(i, int(rng.integers(1, 12)), int(rng.integers(1, 12)),
                          tenant=tenants[i % len(tenants)],
                          deadline_s=None if i % 3 else float(rng.uniform(0.05, 2.0)))
        depth, cost = int(rng.integers(0, 6)), float(rng.uniform(0, 200))
        outcome = []
        for a, req in ((jadm, jr), (adm, r)):
            try:
                a.admit(req, queue_depth=depth, queue_cost=cost)
                outcome.append("admitted")
            except ValueError as e:  # both packages' AdmissionRejected
                outcome.append(e.reason)
        assert outcome[0] == outcome[1], (i, outcome)
        assert _close(jadm.predict_ttft(cost), adm.predict_ttft(cost)) or (
            jadm.predict_ttft(cost) == adm.predict_ttft(cost) == 0.0)
    for f in ("admitted", "shed", "rate_limited", "queue_full", "rejected"):
        assert getattr(adm, f) == getattr(jadm, f), f
    assert adm.shed and adm.rate_limited and adm.queue_full  # every gate fired
    rej = AdmissionRejected("queue_full", "detail")
    assert isinstance(rej, ValueError) and rej.reason == "queue_full"
    assert AdmissionRejected.REASONS == jeng.AdmissionRejected.REASONS
    with pytest.raises(ValueError):
        AdmissionRejected("bogus")


def test_build_continuation_equals_jax():
    for bound in (False, True):
        for seed in (None, 99):
            jr, r = _both_req(7, 4, 10, tenant="a", deadline_s=0.5)
            jr.params = jsamp.SamplingParams(max_new=10, temperature=0.8, seed=seed, top_k=5)
            r.params = SamplingParams(max_new=10, temperature=0.8, seed=seed, top_k=5)
            jr.generated = [3, 1, 4]
            r.generated = [3, 1, 4]
            r.model = jr.model = "m"
            if bound:
                jr._bound = r._bound = True
                jr._seed = r._seed = 1234
            jc, jn = jctl.build_continuation(jr)
            c, n = ctl.build_continuation(r)
            assert n == jn == 3
            np.testing.assert_array_equal(c.prompt, jc.prompt)
            assert c.prompt.dtype == np.int32
            assert (c.params.max_new, c.params.seed, c.params.temperature, c.params.top_k) == (
                jc.params.max_new, jc.params.seed, jc.params.temperature, jc.params.top_k)
            assert (c.rid, c.tenant, c.model) == (jc.rid, jc.tenant, jc.model)


def test_router_equals_jax():
    """JSQ with tenant affinity, model pinning, retirement and credit-back:
    the same replica for every request of a scripted stream."""
    rng = np.random.default_rng(9)
    for models in (None, ["a", "a", "b", "c"]):
        jr, r = jcluster.Router(4, replica_model=models), Router(4, replica_model=models)
        routed = []
        for i in range(60):
            plen, max_new = int(rng.integers(1, 40)), int(rng.integers(1, 30))
            tenant = [None, "t1", "t2", "t3"][int(rng.integers(0, 4))]
            model = None if models is None else ["a", "b", "c"][int(rng.integers(0, 3))]
            kw = dict(rid=i, prompt=np.zeros(plen, np.int32), tenant=tenant, model=model)
            jq = jeng.Request(params=jsamp.SamplingParams(max_new=max_new), **kw)
            q = Request(params=SamplingParams(max_new=max_new), **kw)
            if i == 30:
                jr.retire(2)
                r.retire(2)
            outcome = []
            for router, req in ((jr, jq), (r, q)):
                try:
                    outcome.append(router.route(req))
                except ValueError as e:  # NoModelReplica of either package
                    outcome.append(("rejected", e.reason, e.model))
            assert outcome[0] == outcome[1], (i, outcome)
            routed.append((outcome[1], jq, q))
            if i % 7 == 3 and isinstance(outcome[1], int):
                jr.unassign(outcome[1], jq)
                r.unassign(outcome[1], q)
        assert r.load == jr.load and r.assigned == jr.assigned
        assert r.tenant_home == jr.tenant_home
    with pytest.raises(NoModelReplica) as e:
        Router(2, replica_model=["a", "a"]).route(
            Request(rid=0, prompt=np.zeros(3, np.int32), model="b"))
    assert isinstance(e.value, AdmissionRejected) and e.value.reason == "infeasible"


def test_token_cost_and_placement_equal_jax():
    from repro.configs import get_arch as jax_get_arch
    from repro_torch.configs import get_arch

    names = ["codeqwen1.5-7b", "qwen3-32b", "minicpm3-4b"]
    jcfgs, cfgs = {}, {}
    for n in names:
        for reduced in (False, True):
            jc, c = jax_get_arch(n), get_arch(n)
            if reduced:
                jc, c = jc.reduced(), c.reduced()
            assert ctl.model_token_cost(c) == jctl.model_token_cost(jc)
            jcfgs[(n, reduced)], cfgs[(n, reduced)] = jc, c
    for reduced in (False, True):
        jmap = {n: jcfgs[(n, reduced)] for n in names}
        pmap = {n: cfgs[(n, reduced)] for n in names}
        for dev in (3, 4, 7, 12):
            assert ctl.plan_hetero_placement(pmap, dev) == jctl.plan_hetero_placement(jmap, dev)
    with pytest.raises(ValueError, match="at least"):
        ctl.plan_hetero_placement(pmap, 2)


# ------------------------------------------------------------- watchdog


def test_watchdog_equals_jax_on_a_fake_clock(monkeypatch):
    """Beats, stragglers, deaths and revivals on a scripted clock: the port's
    ``sweep`` and one pass of JAX's loop give the same lane states and fire
    the same hooks in the same order."""
    from repro.ft import watchdog as jwd
    from repro_torch.ft.watchdog import Watchdog

    clock = FakeClock()
    fired = {"jax": [], "port": []}
    j = jwd.Watchdog(straggler_after=0.5, dead_after=2.0, poll=0.0,
                     on_straggler=lambda n, s: fired["jax"].append(("straggler", n)),
                     on_dead=lambda n, s: fired["jax"].append(("dead", n)))

    def one_pass(_poll):  # JAX's loop sleeps after each pass: stop it there
        j._stop.set()

    monkeypatch.setattr(jwd, "time", types.SimpleNamespace(monotonic=clock, sleep=one_pass))
    p = Watchdog(straggler_after=0.5, dead_after=2.0, poll=0.0, clock=clock,
                 on_straggler=lambda n, s: fired["port"].append(("straggler", n)),
                 on_dead=lambda n, s: fired["port"].append(("dead", n)))
    for w in (j, p):
        for lane in ("replica0", "replica1", "replica2"):
            w.register(lane)
    script = [(0.3, ["replica0", "replica1", "replica2"]), (0.9, ["replica0"]),
              (1.2, ["replica0", "replica1"]), (2.0, ["replica0"]), (3.5, []),
              (3.6, ["replica1"]), (4.0, ["replica2"]), (4.1, [])]
    for t, beats in script:
        clock.t = t
        for lane in beats:
            j.beat(lane, step=int(t * 10))
            p.beat(lane, step=int(t * 10))
        if t == 4.0:
            j.revive("replica2")
            p.revive("replica2")
        j._stop.clear()
        j._loop()
        p.sweep()
        assert p.snapshot() == j.snapshot(), t
        for lane in ("replica0", "replica1", "replica2"):
            assert p.stale_seconds(lane) == j.stale_seconds(lane)
    assert fired["port"] == fired["jax"]
    assert ("dead", "replica2") in fired["port"] and ("straggler", "replica0") in fired["port"]
