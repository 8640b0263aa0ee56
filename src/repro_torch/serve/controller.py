"""Closed-loop serving supervisor: reconfiguration, admission, failure
(counterpart of ``repro/serve/controller.py``, the same decisions).

This module is the scalar core of the paper's story, ported to serving:
Spatzformer's latency-tolerant scalar controller watches the workload and
re-homes the vector fabric (split for many independent small tasks, merge
for large uniform ones) because matching mode to workload — not the
datapath — is where mixed-workload utilization is won. Here the same
supervisor role is played by three cooperating pieces, all consumed by
:class:`repro_torch.serve.cluster.ServeCluster`:

* :class:`ReconfigController` — watches a sliding window of live serving
  signals (queue depth, arrival mix, TTFT samples) and triggers
  split↔merge :meth:`ServeCluster.reconfigure` when the perfmodel's
  predicted win (:func:`repro_torch.core.perfmodel.model_serving_mode`)
  exceeds the *measured* switch cost, with hysteresis, a confirmation
  streak, and a cooldown so it never flaps.
* :class:`AdmissionController` — the overload-survival layer at the
  submission boundary: per-tenant token buckets with priorities, a
  bounded queue with priority headroom, and deadline-based shedding
  (reject a request whose *predicted* TTFT exceeds its deadline instead
  of letting every queued request miss). All rejections are typed
  :class:`repro_torch.serve.engine.AdmissionRejected`.
* :class:`FailurePolicy` — watchdog thresholds for split-mode controller
  threads; a replica whose heartbeat goes stale past ``dead_after`` is
  declared dead and its live requests are re-homed onto survivors via
  :func:`build_continuation`, bit-identically for seeded streams because
  ``fold_in(seed, position)`` keying makes every draw a function of the
  request's seed and absolute position, not of which engine draws it.

Everything here is host-side pure Python and unit-testable with a fake
clock; only :meth:`ReconfigController.for_cluster` reads tensors (their
bytes and element counts).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Mapping, Optional

import numpy as np

from repro_torch.common.utils import pytree_bytes
from repro_torch.core.modes import Mode
from repro_torch.core.perfmodel import (
    H100,
    HardwareModel,
    ServingMix,
    serving_mode_advice,
)
from repro_torch.serve.engine import AdmissionRejected, Request

__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "ControllerConfig",
    "FailurePolicy",
    "ReconfigController",
    "SwitchDecision",
    "TenantPolicy",
    "WindowSample",
    "build_continuation",
    "model_token_cost",
    "plan_hetero_placement",
]


# ---------------------------------------------------------------------------
# reconfiguration controller
# ---------------------------------------------------------------------------


def _leaf_elements(tree: Any) -> int:
    """Elements over every tensor leaf of a nested dict/list."""
    if isinstance(tree, dict):
        return sum(_leaf_elements(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_leaf_elements(v) for v in tree)
    return int(tree.numel()) if hasattr(tree, "numel") else 0


@dataclass(frozen=True)
class WindowSample:
    """One control-interval observation of the live cluster."""

    t: float  # cluster-run clock (seconds since run start)
    mode: str  # "split" | "merge" at observation time
    queue_depth: int  # Σ len(waiting) over live engines
    n_requests: int  # arrivals admitted in the interval
    prompt_tokens: int  # Σ prompt length of those arrivals
    decode_tokens: int  # Σ max_new of those arrivals
    longest_tokens: int  # max max_new of any arrival
    n_tenants: int = 0  # distinct tenants in the interval
    ttft_p99: float = 0.0  # over requests finished in the interval
    tpot_p99: float = 0.0


@dataclass(frozen=True)
class SwitchDecision:
    """A committed controller decision: switch to ``mode`` because the
    windowed workload is predicted to run ``predicted_win_s`` faster
    there, which clears the (hysteresis-scaled) ``switch_cost_s``."""

    mode: Mode
    predicted_win_s: float
    switch_cost_s: float


@dataclass
class ControllerConfig:
    """Tuning knobs for :class:`ReconfigController`.

    ``cold_switch_s`` / ``warm_switch_s`` seed the switch-cost estimate
    with ``chip_smoke.py``'s measured reconfigure costs (its cluster phase;
    ``PERF.md``); every observed
    :class:`~repro_torch.serve.cluster.ReconfigureReport` refines them by
    EWMA.
    """

    interval_s: float = 0.25  # control-loop slice length
    window_s: float = 1.0  # sliding window the mix is folded over
    cooldown_s: float = 1.0  # min seconds between committed switches
    hysteresis: float = 1.5  # required win = hysteresis × switch cost
    confirm: int = 2  # consecutive intervals agreeing before a switch
    # chip_smoke.py phase 12 (b), NVIDIA H100 80GB HBM3, 700 W: a cold
    # build of one full-width codeqwen engine, a warm reset back
    cold_switch_s: float = 0.0045
    warm_switch_s: float = 0.0014
    cost_ewma: float = 0.5  # weight of a new measured switch cost
    # per-token model costs (for_cluster() derives them from the params)
    flops_per_token: float = 2e9
    hbm_bytes_per_token: float = 1e9
    coll_bytes_per_token: float = 1e5
    prefill_budget: int = 64
    max_chunk: int = 8
    batch_slots: int = 4
    hw: HardwareModel = field(default_factory=lambda: H100)


class ReconfigController:
    """Sliding-window split↔merge decision loop (host-side, pure).

    Call :meth:`observe` once per control interval with a
    :class:`WindowSample`; it returns a :class:`SwitchDecision` when — and
    only when — all four gates pass:

    1. the perfmodel prefers the *other* mode for the windowed mix,
    2. the predicted win exceeds ``hysteresis ×`` the (measured) switch
       cost — marginal wins never pay for a move,
    3. the preference held for ``confirm`` consecutive intervals — one
       noisy window never triggers,
    4. ``cooldown_s`` has elapsed since the last committed switch — the
       controller cannot flap even under an adversarial oscillating load.

    After actually reconfiguring, report back via :meth:`note_switched`
    so the cooldown clock and the measured-cost EWMA advance.
    """

    def __init__(
        self, n_devices: int, config: Optional[ControllerConfig] = None
    ) -> None:
        self.cfg = config if config is not None else ControllerConfig()
        self.n_devices = max(int(n_devices), 1)
        self.samples: deque[WindowSample] = deque()
        self.switch_times: list[float] = []  # observation clocks of commits
        self.decisions: list[SwitchDecision] = []
        self._last_switch_t = -math.inf
        self._streak_mode: Optional[str] = None
        self._streak = 0
        self._cost = {
            "cold": self.cfg.cold_switch_s,
            "warm": self.cfg.warm_switch_s,
        }

    @property
    def interval_s(self) -> float:
        return self.cfg.interval_s

    @classmethod
    def for_cluster(cls, cluster, **overrides) -> "ReconfigController":
        """Build a controller whose per-token model costs come from the
        cluster's own parameters (weights bytes ≈ HBM stream per step;
        ~2 FLOPs per weight per token) and whose scheduling constants
        mirror the cluster's engine kwargs."""
        # measure the RESIDENT tree (a live engine's, if one exists): with
        # int8 weight serving the engines hold ~4x fewer bytes than the f32
        # tree the cluster was constructed with, and the per-step HBM
        # stream follows the resident bytes while the FLOPs follow the
        # weight COUNT — the two must be derived independently, never as
        # bytes/4 (that assumption only held when every param was f32)
        engines = cluster._fabrics.get(cluster.mode) or []
        tree = engines[0].params if engines else cluster.params
        pb = float(pytree_bytes(tree))
        n_weights = float(_leaf_elements(tree))
        kw = cluster._engine_kw
        cfg_kw = dict(
            flops_per_token=2.0 * n_weights,  # ~2 FLOPs per weight per token
            hbm_bytes_per_token=pb,
            prefill_budget=kw.get("prefill_budget", 64),
            max_chunk=kw.get("max_chunk", 8),
            batch_slots=kw.get("batch_slots", 4),
        )
        cfg_kw.update(overrides)
        return cls(len(cluster.devices), ControllerConfig(**cfg_kw))

    def switch_cost(self, warm: bool) -> float:
        return self._cost["warm" if warm else "cold"]

    def _window_mix(self) -> Optional[ServingMix]:
        cfg = self.cfg
        n_req = sum(s.n_requests for s in self.samples)
        if n_req <= 0:
            return None
        return ServingMix(
            n_requests=n_req,
            prompt_tokens=float(sum(s.prompt_tokens for s in self.samples)),
            decode_tokens=float(sum(s.decode_tokens for s in self.samples)),
            longest_tokens=float(
                max(s.longest_tokens for s in self.samples)
            ),
            flops_per_token=cfg.flops_per_token,
            hbm_bytes_per_token=cfg.hbm_bytes_per_token,
            coll_bytes_per_token=cfg.coll_bytes_per_token,
            prefill_budget=cfg.prefill_budget,
            max_chunk=cfg.max_chunk,
            batch_slots=cfg.batch_slots,
        )

    def observe(
        self, sample: WindowSample, *, warm_target: bool = False
    ) -> Optional[SwitchDecision]:
        cfg = self.cfg
        self.samples.append(sample)
        while self.samples and sample.t - self.samples[0].t > cfg.window_s:
            self.samples.popleft()
        mix = self._window_mix()
        if mix is None:  # idle window: hold mode, decay nothing
            self._streak_mode, self._streak = None, 0
            return None
        best, seconds = serving_mode_advice(mix, self.n_devices, cfg.hw)
        if best == sample.mode:
            self._streak_mode, self._streak = None, 0
            return None
        win = seconds[sample.mode] - seconds[best]
        cost = self.switch_cost(warm_target)
        if win <= cfg.hysteresis * cost:
            self._streak_mode, self._streak = None, 0
            return None
        if self._streak_mode == best:
            self._streak += 1
        else:
            self._streak_mode, self._streak = best, 1
        if self._streak < cfg.confirm:
            return None
        if sample.t - self._last_switch_t < cfg.cooldown_s:
            return None
        return SwitchDecision(
            mode=Mode.parse(best), predicted_win_s=win, switch_cost_s=cost
        )

    def note_switched(self, t: float, report=None) -> None:
        """Commit a decision: start the cooldown clock at observation
        time ``t`` and fold the measured switch cost (a
        ``ReconfigureReport``) into the warm/cold EWMA estimates."""
        self._last_switch_t = t
        self.switch_times.append(t)
        self._streak_mode, self._streak = None, 0
        if report is not None:
            kind = "warm" if getattr(report, "cached", False) else "cold"
            a = self.cfg.cost_ewma
            self._cost[kind] = (
                (1 - a) * self._cost[kind] + a * float(report.seconds)
            )


# ---------------------------------------------------------------------------
# admission control / load shedding
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant admission terms. ``rate`` refills a token bucket in
    *cost tokens* per second (cost of a request = prompt + max_new);
    ``burst`` caps the bucket. ``priority > 0`` rides the deeper queue
    bound (``max_queue × priority_headroom``) before hitting
    ``queue_full`` — priority buys headroom, not starvation of others."""

    rate: float = math.inf
    burst: float = math.inf
    priority: int = 0


@dataclass
class AdmissionPolicy:
    """Cluster-wide admission configuration (see AdmissionController)."""

    max_queue: Optional[int] = None  # per-target-replica waiting bound
    tenants: Mapping[str, TenantPolicy] = field(default_factory=dict)
    default: TenantPolicy = field(default_factory=TenantPolicy)
    priority_headroom: float = 2.0
    # seeds the TTFT predictor before any service-rate feedback arrives;
    # None disables deadline shedding until the first measured rate
    initial_tok_per_s: Optional[float] = None
    rate_ewma: float = 0.5


class _Bucket:
    def __init__(self, pol: TenantPolicy, now: float) -> None:
        self.pol = pol
        self.level = pol.burst
        self.last = now

    def refill(self, now: float) -> None:
        if math.isfinite(self.pol.rate):
            self.level = min(
                self.pol.burst, self.level + (now - self.last) * self.pol.rate
            )
        self.last = now

    def peek(self, cost: float) -> bool:
        return self.level >= cost or not math.isfinite(self.pol.burst)

    def take(self, cost: float) -> None:
        if math.isfinite(self.pol.burst):
            self.level -= cost


class AdmissionController:
    """Submit-time gate: every request passes (in order) the tenant rate
    bucket, the bounded queue, and the deadline predictor before it may
    join a replica's waiting queue. Rejections raise
    :class:`AdmissionRejected` and are counted by reason; the bucket is
    only debited for requests that actually pass every gate.

    TTFT prediction is deliberately crude and cheap: predicted TTFT =
    (cost tokens already queued ahead) / (EWMA of the measured per-replica
    service rate). Crude is enough — under overload the queue cost grows
    without bound, so *any* consistent rate estimate separates requests
    that will meet their deadline from those that cannot.
    """

    def __init__(
        self,
        policy: Optional[AdmissionPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.policy = policy if policy is not None else AdmissionPolicy()
        self.clock = clock
        self._buckets: dict[Optional[str], _Bucket] = {}
        self._rate = self.policy.initial_tok_per_s
        # split-mode replica threads gate concurrently (engine.run's
        # arrival hook) — buckets and counters share one lock
        self._lock = threading.Lock()
        self.admitted = 0
        self.shed = 0  # shed_deadline
        self.rate_limited = 0
        self.queue_full = 0

    @property
    def rejected(self) -> int:
        """Non-deadline rejections (rate_limited + queue_full)."""
        return self.rate_limited + self.queue_full

    def note_service_rate(self, tok_per_s: float) -> None:
        """Feed back a measured per-replica service rate (tokens/sec)."""
        if tok_per_s <= 0:
            return
        with self._lock:
            if self._rate is None:
                self._rate = tok_per_s
            else:
                a = self.policy.rate_ewma
                self._rate = (1 - a) * self._rate + a * tok_per_s

    def predict_ttft(self, queue_cost: float) -> float:
        """Seconds until a request behind ``queue_cost`` tokens starts."""
        if self._rate is None:
            return 0.0
        return queue_cost / max(self._rate, 1e-9)

    @staticmethod
    def request_cost(req: Request) -> float:
        return float(len(req.prompt) + req.params.max_new)

    def admit(
        self, req: Request, *, queue_depth: int, queue_cost: float
    ) -> None:
        """Gate one request against the target replica's queue state.
        Raises :class:`AdmissionRejected`; returns None on admission."""
        pol = self.policy.tenants.get(req.tenant, self.policy.default)
        now = self.clock()
        cost = self.request_cost(req)
        with self._lock:
            bucket = self._buckets.get(req.tenant)
            if bucket is None:
                bucket = self._buckets[req.tenant] = _Bucket(pol, now)
            bucket.refill(now)
            if not bucket.peek(cost):
                self.rate_limited += 1
                raise AdmissionRejected(
                    "rate_limited",
                    f"tenant {req.tenant!r} over rate "
                    f"({bucket.level:.0f} of {cost:.0f} cost tokens "
                    "available)",
                )
            if self.policy.max_queue is not None:
                bound = self.policy.max_queue * (
                    self.policy.priority_headroom if pol.priority > 0 else 1.0
                )
                if queue_depth >= bound:
                    self.queue_full += 1
                    raise AdmissionRejected(
                        "queue_full",
                        f"{queue_depth} waiting >= bound {bound:.0f} "
                        f"(tenant {req.tenant!r} priority {pol.priority})",
                    )
            if req.deadline_s is not None and self._rate is not None:
                eta = queue_cost / max(self._rate, 1e-9)
                if eta > req.deadline_s:
                    self.shed += 1
                    raise AdmissionRejected(
                        "shed_deadline",
                        f"predicted TTFT {eta:.3f}s > deadline "
                        f"{req.deadline_s:.3f}s",
                    )
            bucket.take(cost)
            self.admitted += 1


# ---------------------------------------------------------------------------
# replica-failure policy + re-homing continuation
# ---------------------------------------------------------------------------


@dataclass
class FailurePolicy:
    """Watchdog thresholds for split-mode controller threads.

    Each replica's serving loop beats a heartbeat lane once per
    scheduling iteration; a lane stale past ``straggler_after`` is
    flagged, past ``dead_after`` the replica is declared dead and its
    live requests re-home onto survivors. ``tick_hook(replica_idx)`` is
    an instrumentation point called on the replica's own thread every
    iteration (after the beat) — tests inject stalls through it.

    Heartbeats fire at scheduling-iteration boundaries, so ``dead_after``
    must exceed the worst-case single iteration — including a first
    launch that builds the kernels, which can take minutes. Prewarm the
    cluster (the build off the serving path) or set ``dead_after``
    accordingly; otherwise a replica mid-build reads as dead and gets
    needlessly retired."""

    straggler_after: float = 0.5
    dead_after: float = 2.0
    poll: float = 0.02
    tick_hook: Optional[Callable[[int], None]] = None


def model_token_cost(cfg) -> float:
    """Relative per-decode-token serving cost of one architecture.

    The heterogeneous placement planner only needs *ratios* between the
    models sharing a cluster, so this is a deliberately small perfmodel
    keyed on what each family's decode step actually streams per token:

    * attention families are HBM-bound on the KV read — cost ∝ layers ×
      bytes-per-position row. MLA reads the compressed latent row
      (``kv_lora_rank + rope_head_dim``); GQA reads ``2 × n_kv_heads ×
      head_dim``.
    * SSM families never touch a growing cache — the recurrence is
      flops-bound on the state update: cost ∝ layers × inner width
      (``d_model × expand``) × state size, scaled down by the hardware's
      flops:HBM byte ratio stand-in (the constant only shifts SSM vs
      attention weighting, not SSM vs SSM).

    Hybrids take the max of their two lanes (the decode step runs both).
    """
    L = cfg.n_layers
    attn_row = 0.0
    if cfg.mla is not None:
        attn_row = float(cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
    elif cfg.family in ("dense", "moe", "hybrid"):
        attn_row = float(2 * cfg.n_kv_heads * cfg.head_dim)
    ssm_cost = 0.0
    ssm = cfg.ssm
    if ssm is not None:
        inner = cfg.d_model * ssm.expand
        # ~flops:bytes ratio stand-in; keeps SSM state math comparable
        # to an HBM row read rather than dominating it.
        ssm_cost = inner * ssm.state / 256.0
    return float(L) * max(attn_row * 4.0, ssm_cost, 1.0)  # f32 bytes/row


def plan_hetero_placement(
    model_cfgs: Mapping[str, Any], n_devices: int
) -> dict[str, int]:
    """Replica counts per model for a split cluster of ``n_devices``.

    Every model gets at least one replica (a model with zero replicas
    cannot serve at all — availability beats proportionality); the
    remaining devices go to models by largest remainder on their
    :func:`model_token_cost` weights, so the expensive-per-token model
    gets the capacity. Deterministic: ties break on insertion order of
    ``model_cfgs``.
    """
    names = list(model_cfgs)
    if not names:
        raise ValueError("plan_hetero_placement: no models")
    if n_devices < len(names):
        raise ValueError(
            f"{len(names)} models need at least {len(names)} devices; "
            f"have {n_devices}"
        )
    costs = {n: model_token_cost(model_cfgs[n]) for n in names}
    total = sum(costs.values())
    counts = {n: 1 for n in names}
    spare = n_devices - len(names)
    if spare:
        quotas = {n: spare * costs[n] / total for n in names}
        floors = {n: int(math.floor(quotas[n])) for n in names}
        for n in names:
            counts[n] += floors[n]
        left = spare - sum(floors.values())
        by_rem = sorted(
            names, key=lambda n: (-(quotas[n] - floors[n]), names.index(n))
        )
        for n in by_rem[:left]:
            counts[n] += 1
    return counts


def build_continuation(req: Request) -> tuple[Request, int]:
    """(continuation, committed) for re-homing a partially-served request.

    The continuation's prompt is the original prompt plus the
    ``committed`` tokens already harvested to the host; its budget is the
    remainder. Because the engine feeds the whole prompt before sampling
    and keys every draw by ``fold_in(seed, absolute_position)``, the
    continuation's first draw lands at exactly the position the original
    stream would have sampled next — a seeded re-homed stream is
    bit-identical to the uninterrupted one. Unharvested in-flight draws
    on the dead replica are simply re-derived (same key, same value).

    A request the engine never bound keeps ``params.seed`` as given (the
    survivor assigns its own key only if seed is None *and* the stream
    never started — in which case no draw was committed either, so any
    seed is consistent). A bound request pins the engine-assigned seed so
    the survivor continues the *same* stream.
    """
    committed = len(req.generated)
    seed = req.params.seed
    if seed is None and getattr(req, "_bound", False):
        seed = req._seed
    cont = Request(
        rid=req.rid,
        prompt=np.concatenate(
            [
                np.asarray(req.prompt, np.int32),
                np.asarray(req.generated, np.int32),
            ]
        ),
        params=replace(
            req.params, max_new=req.params.max_new - committed, seed=seed
        ),
        tenant=req.tenant,
        model=req.model,
    )
    return cont, committed
