"""ServeCluster: the split/merge reconfigurable serving fabric (counterpart
of ``repro/serve/cluster.py``).

* **SPLIT** — one independent :class:`~repro_torch.serve.engine.ServeEngine`
  replica per entry of ``devices``, each pinned through a
  :class:`~repro_torch.serve.backend.DeviceBackend` (on a CUDA device: a
  stream of its own) and driven by its own controller thread, behind a
  :class:`Router` doing join-shortest-queue with per-tenant affinity. An
  entry may repeat: two replicas on one card share its weights and queue
  their kernels on two streams — the paper's two independent cores, the
  router playing the scalar control core.
* **MERGE** — ONE engine under one controller. Over one device it is the
  pinned plain engine; over two or more entries it is tensor-parallel
  serving: one lane per entry (a device and a stream of its own, so a
  repeated device gives two lanes of one card), a merged
  ``LM(cfg, mesh_info=serving_mesh_info(devices))`` whose heads, MLP width
  and vocabulary split over the lanes, behind a
  :class:`~repro_torch.serve.backend.ShardedBackend`. A heterogeneous
  cluster is split-only (``ValueError``); what the merged engine does not
  take (``models.model.check_tensor_parallel``,
  ``serve.engine.check_merged_options``) raises ``NotImplementedError``
  naming ROADMAP, before any queued request is drained.
* **reconfigure(mode)** — drain in-flight chunks, place the target mode's
  engines, re-route the carried queue; the wall-clock cost is measured and
  reported (:class:`ReconfigureReport`) like the paper's CSR-write cost. A
  built fabric is kept warm, so switching back is an engine reset.

Both modes serve any greedy or seeded stream with the same tokens as one
plain engine: the cluster changes where work runs, never what is computed.

Robustness layers (all opt-in, see :mod:`repro_torch.serve.controller`):

* ``admission=AdmissionPolicy(...)`` gates every request (submit() and the
  arrival stream alike) through per-tenant rate buckets, a bounded queue,
  and deadline-based shedding — typed ``AdmissionRejected`` either raises
  (submit) or marks the request ``finish_reason="rejected"`` (arrivals);
* ``failure=FailurePolicy(...)`` arms a watchdog over the split-mode
  controller threads: a replica whose heartbeat goes stale is declared
  dead and its live requests re-home onto survivors, token for token for
  seeded streams (``fold_in(seed, position)`` keying);
* ``run_controlled(...)`` closes the loop: serve in control intervals and
  let a :class:`~repro_torch.serve.controller.ReconfigController` trigger
  split↔merge switches when the perfmodel-predicted win clears the
  measured switch cost.

No fallback hides the device: a replica or a controller thread that fails
raises out of ``run()``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.common.utils import pytree_bytes
from repro_torch.core.modes import Mode
from repro_torch.dist.sharding import serving_mesh_info
from repro_torch.ft.watchdog import Watchdog
from repro_torch.models.model import LM, check_tensor_parallel
from repro_torch.serve.backend import DeviceBackend, ShardedBackend
from repro_torch.serve.controller import (
    AdmissionController,
    AdmissionPolicy,
    FailurePolicy,
    ReconfigController,
    WindowSample,
    build_continuation,
    plan_hetero_placement,
)
from repro_torch.serve.engine import (
    AdmissionRejected,
    Request,
    RequestHandle,
    ServeEngine,
    ServeStats,
    check_merged_options,
    percentile,
)
from repro_torch.serve.sampling import SamplingParams


def _resolve_devices(devices) -> list[torch.device]:
    """``None`` is every CUDA device (raising without one); entries may
    repeat (two replicas on one device); the CPU only when named."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            resolve_device(None)  # raises: the cluster runs on the card
        devices = [torch.device("cuda", i) for i in range(n)]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("ServeCluster needs at least one device")
    return out


def _new_bytes(placed, source) -> int:
    """Bytes of the tensor leaves of ``placed`` that are not leaves of
    ``source`` (copies made by placement or quantization); a sharded leaf
    counts its global shape once, as ``pytree_bytes`` does."""
    seen = set()

    def ids(t):
        if isinstance(t, dict):
            for v in t.values():
                ids(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                ids(v)
        elif isinstance(t, torch.Tensor):
            seen.add(id(t))

    ids(source)

    def walk(t) -> int:
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(walk(v) for v in t)
        if (isinstance(t, torch.Tensor) and id(t) not in seen) or hasattr(t, "sharding"):
            return t.numel() * t.element_size()
        return 0

    return walk(placed)


# =============================================================================
# router (split mode's scalar control core)
# =============================================================================


class NoModelReplica(AdmissionRejected):
    """No live replica serves the model a request is pinned to.

    A heterogeneous cluster pins one model per split replica; a request
    whose ``model`` names nothing in the placement — or whose model's
    replicas are all dead — cannot be served anywhere, and silently
    routing it to a *different* model would return the wrong
    distribution. Typed as an :class:`AdmissionRejected` (reason
    ``"infeasible"``) so the submit/arrival rejection plumbing treats it
    like any other capacity rejection."""

    def __init__(self, model: Optional[str], detail: str = "") -> None:
        self.model = model
        super().__init__(
            "infeasible",
            detail or f"no live replica serves model {model!r}",
        )


class Router:
    """Join-shortest-queue request routing with per-tenant affinity.

    Queue length is the cumulative admitted cost (prompt + decode tokens)
    per replica — routing happens at submit time, so balance is over
    assigned work, not instantaneous occupancy. A request carrying a
    ``tenant`` sticks to the replica its tenant first landed on (KV/prefix
    locality and per-tenant isolation beat perfect balance); tenant-less
    requests always take the shortest queue, ties to the lowest index.

    With ``replica_model`` set (heterogeneous cluster), each replica is
    pinned to one named model and a request carrying ``model=`` only
    routes among that model's replicas — JSQ and tenant affinity apply
    *within* the compatible set, and a tenant's home is honoured only
    when it serves the requested model (a tenant mixing models keeps its
    home for the home's model and JSQ-routes the rest). An empty
    compatible set raises :class:`NoModelReplica`.
    """

    def __init__(
        self,
        n_replicas: int,
        replica_model: Optional[Sequence[Optional[str]]] = None,
    ) -> None:
        self.n = n_replicas
        self.load = [0.0] * n_replicas
        self.assigned = [0] * n_replicas
        self.tenant_home: dict[str, int] = {}
        self.retired: set[int] = set()  # dead replicas: never routed to
        self.replica_model = (
            list(replica_model) if replica_model is not None else None
        )

    @staticmethod
    def cost(req: Request) -> float:
        return float(len(req.prompt) + req.params.max_new)

    def _candidates(self, req: Request) -> list[int]:
        live = [j for j in range(self.n) if j not in self.retired] or list(
            range(self.n)
        )
        if req.model is None or self.replica_model is None:
            return live
        cand = [j for j in live if self.replica_model[j] == req.model]
        if not cand:
            raise NoModelReplica(req.model)
        return cand

    def peek(self, req: Request) -> int:
        """The replica ``route()`` would pick, without committing load
        (admission control inspects the prospective target's queue)."""
        cand = self._candidates(req)
        if req.tenant is not None:
            home = self.tenant_home.get(req.tenant)
            if home is not None and home in cand:
                return home
        return min(cand, key=lambda j: (self.load[j], j))

    def route(self, req: Request) -> int:
        i = self.peek(req)
        if req.tenant is not None and req.tenant not in self.tenant_home:
            self.tenant_home[req.tenant] = i
        self.load[i] += self.cost(req)
        self.assigned[i] += 1
        return i

    def retire(self, replica: int) -> None:
        """Take a dead replica out of rotation: JSQ skips it and its
        tenants re-home to a survivor on their next request."""
        self.retired.add(replica)
        self.tenant_home = {
            t: i for t, i in self.tenant_home.items() if i != replica
        }

    def unassign(self, replica: int, req: Request) -> None:
        """Credit back a routed-but-unserved request (it is about to be
        carried across a reconfigure and re-routed): without this, carried
        requests would double-count in the JSQ load and the per-replica
        ``assigned`` telemetry."""
        self.load[replica] -= self.cost(req)
        self.assigned[replica] -= 1


# =============================================================================
# stats
# =============================================================================


@dataclass
class ReconfigureReport:
    """Cost of one mode switch — the paper's CSR-write number.

    ``drain_seconds`` is the time spent finishing in-flight chunks after
    the switch was requested; ``place_seconds`` the re-placement of
    params/cache onto the target fabric (``bytes_moved`` counts what was
    placed; 0 and ``cached=True`` for a warm switch back to an
    already-built fabric, where only the engine state resets)."""

    from_mode: str
    to_mode: str
    drain_seconds: float
    place_seconds: float
    bytes_moved: int
    cached: bool

    @property
    def seconds(self) -> float:
        return self.drain_seconds + self.place_seconds

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        kind = "warm" if self.cached else "cold"
        return (
            f"reconfigure {self.from_mode}->{self.to_mode} ({kind}): "
            f"{self.seconds*1e3:.1f}ms (drain {self.drain_seconds*1e3:.1f} + "
            f"place {self.place_seconds*1e3:.1f}), "
            f"{self.bytes_moved/1e6:.2f} MB placed"
        )


@dataclass
class SegmentStats:
    """One constant-mode stretch of a cluster run."""

    mode: str
    replicas: list[ServeStats]

    @property
    def wall_seconds(self) -> float:
        return max((r.wall_seconds for r in self.replicas), default=0.0)


@dataclass
class ClusterStats:
    """Aggregate over every segment/replica of one ``ServeCluster.run``."""

    mode: str  # e.g. "split" or "split->merge"
    segments: list[SegmentStats]
    reconfigures: list[ReconfigureReport] = field(default_factory=list)
    # robustness counters for THIS run (deltas, filled by the cluster):
    shed: int = 0  # deadline-shed arrivals (shed_deadline)
    rejected: int = 0  # rate_limited + queue_full arrivals
    rehomed: int = 0  # live requests moved off a dead replica
    stragglers: int = 0  # watchdog straggler flags (recovered or not)
    dead_replicas: int = 0  # replicas declared dead during the run

    def _each(self, attr: str) -> list:
        return [getattr(r, attr) for s in self.segments for r in s.replicas]

    @property
    def total_tokens(self) -> int:
        return sum(self._each("total_tokens"))

    @property
    def total_requests(self) -> int:
        return sum(self._each("total_requests"))

    @property
    def ticks(self) -> int:
        return sum(self._each("ticks"))

    @property
    def cancelled(self) -> int:
        return sum(self._each("cancelled"))

    @property
    def spec_proposed(self) -> int:
        return sum(self._each("spec_proposed"))

    @property
    def spec_accepted(self) -> int:
        return sum(self._each("spec_accepted"))

    @property
    def spec_ticks(self) -> int:
        return sum(self._each("spec_ticks"))

    @property
    def spec_acceptance(self) -> float:
        return self.spec_accepted / max(self.spec_proposed, 1)

    @property
    def queue_peak(self) -> int:
        """High-water mark of any single replica's waiting queue."""
        return max(self._each("queue_peak"), default=0)

    @property
    def alloc_failures(self) -> int:
        return sum(self._each("alloc_failures"))

    @property
    def kv_bytes_resident(self) -> int:
        """Peak dtype-aware resident KV bytes across any one segment
        (replicas within a segment are resident CONCURRENTLY, so they sum;
        segments are sequential, so the cluster peak is the max)."""
        return max(
            (
                sum(r.kv_bytes_resident for r in s.replicas)
                for s in self.segments
            ),
            default=0,
        )

    @property
    def wall_seconds(self) -> float:
        # replicas within a segment run concurrently (max); segments and
        # reconfigurations are sequential (sum). A reconfigure's DRAIN
        # already lives inside the preceding segment's wall — only the
        # re-placement extends the clock.
        return sum(s.wall_seconds for s in self.segments) + sum(
            r.place_seconds for r in self.reconfigures
        )

    @property
    def tokens_per_sec(self) -> float:
        return self.total_tokens / max(self.wall_seconds, 1e-9)

    @property
    def ttfts(self) -> list[float]:
        return [t for xs in self._each("ttfts") for t in xs]

    @property
    def tpots(self) -> list[float]:
        return [t for xs in self._each("tpots") for t in xs]

    @property
    def ttft_p50(self) -> float:
        return percentile(self.ttfts, 50)

    @property
    def ttft_p99(self) -> float:
        return percentile(self.ttfts, 99)

    @property
    def tpot_p50(self) -> float:
        return percentile(self.tpots, 50)

    @property
    def tpot_p99(self) -> float:
        return percentile(self.tpots, 99)


# =============================================================================
# cluster
# =============================================================================


class ServeCluster:
    """Reconfigurable serving: split replicas or one merged engine over the
    same devices, switchable at runtime.

    Construction places the initial mode's fabric; ``submit``/``run``
    mirror :class:`ServeEngine` (``run`` returns :class:`ClusterStats`).
    ``reconfigure(mode)`` switches fabrics between runs;
    ``run(reconfigure_schedule=[(t, mode), ...])`` switches mid-stream —
    the cluster drains in-flight work at each switch point, re-homes, and
    resumes with the remaining arrivals.
    """

    def __init__(
        self,
        model: Optional[LM] = None,
        params=None,
        *,
        models: Optional[Mapping[str, tuple]] = None,
        placement: Optional[Mapping[str, int]] = None,
        tenant_models: Optional[Mapping[str, str]] = None,
        mode: Mode | str = Mode.SPLIT,
        devices: Optional[Sequence] = None,
        batch_slots: int = 4,
        max_len: int = 256,
        seed: int = 0,
        unified: Optional[bool] = None,
        prefill_budget: int = 64,
        max_chunk: int = 8,
        kv_block_size: Optional[int] = None,
        num_blocks: Optional[int] = None,
        prefix_cache: bool = False,
        speculate=None,
        kv_dtype=None,
        weight_dtype=None,
        tenant_defaults: Optional[Mapping[str, SamplingParams]] = None,
        admission: Optional[AdmissionPolicy] = None,
        failure: Optional[FailurePolicy] = None,
    ) -> None:
        self.devices = _resolve_devices(devices)
        # ---- heterogeneous serving: {name: (model-or-config, params)}
        if models is not None:
            if model is not None or params is not None:
                raise ValueError(
                    "pass either (model, params) or models={...}, not both"
                )
            if not models:
                raise ValueError("models={} names no model to serve")
            self.models = {
                name: self._norm_model_spec(name, spec, self.devices[0])
                for name, spec in models.items()
            }
            # first entry is the cluster's primary model: requests with no
            # model pin default to it, and single-engine introspection
            # (ReconfigController.for_cluster reads .params) sees it
            self.model, self.params = next(iter(self.models.values()))
        else:
            if model is None or params is None:
                raise ValueError(
                    "ServeCluster needs (model, params) or models={...}"
                )
            self.models = None
            self.model = model
            self.params = params
        self.tenant_models: dict[str, str] = dict(tenant_models or {})
        if self.tenant_models and self.models is None:
            raise ValueError("tenant_models= needs models={...}")
        for t, name in self.tenant_models.items():
            if name not in (self.models or {}):
                raise ValueError(
                    f"tenant_models[{t!r}] names unknown model {name!r}"
                )
        self._replica_model = self._plan_replicas(placement)
        self.seed = seed
        # paged kwargs pass straight through: split mode gets one
        # independent pool + prefix tree PER replica (tenant-affinity
        # routing then doubles as prefix locality — a tenant's repeated
        # system prompt stays hot on its home replica's tree)
        self._engine_kw = dict(
            batch_slots=batch_slots,
            max_len=max_len,
            # None: each replica's own family default (a hybrid on the
            # legacy tier, the rest unified)
            unified=unified,
            prefill_budget=prefill_budget,
            max_chunk=max_chunk,
            kv_block_size=kv_block_size,
            num_blocks=num_blocks,
            prefix_cache=prefix_cache,
            # each engine builds its own drafter from the config string —
            # a split replica drafts against its local slots, the merged
            # engine against the whole batch; seeded streams stay
            # bit-identical across modes because acceptance is exact-match
            # against the same fold_in(seed, position) draws
            speculate=speculate,
            # quantized serving passes through unchanged: every fabric
            # (split replicas AND the merged TP engine) stores the same
            # int8 rows + scales, so a mid-stream SPLIT<->MERGE switch
            # re-homes requests across identically-quantized caches
            kv_dtype=kv_dtype,
            weight_dtype=weight_dtype,
        )
        self.router = Router(len(self.devices), replica_model=self._replica_model)
        self.finished: list[Request] = []
        self.reconfigures: list[ReconfigureReport] = []
        # per-tenant default SamplingParams: a request submitted WITHOUT
        # explicit sampling config inherits its tenant's default at routing
        # time, before any engine sees it — so the defaults survive
        # split/merge switches and mid-stream reconfigure re-routing
        # unchanged (params are resolved once, at first submit)
        self.tenant_defaults: dict[str, SamplingParams] = dict(tenant_defaults or {})
        # which engine currently owns each live request (handles route
        # cancellation through this; reconfigure() re-homes the entries)
        self._where: dict[Request, ServeEngine] = {}
        self._fabrics: dict[Mode, list[ServeEngine]] = {}
        # ---- robustness state (see module docstring)
        self.admission = (
            AdmissionController(admission) if admission is not None else None
        )
        self.failure = failure
        self.rehomed = 0
        self.stragglers = 0
        self._dead: set[int] = set()  # indices into the SPLIT fabric
        self._rehome_lock = threading.Lock()
        # orig -> (continuation, tokens committed before the death);
        # cont -> orig for mapping the survivor's finished list back
        self._rehomed_map: dict[Request, tuple[Request, int]] = {}
        self._cont_orig: dict[Request, Request] = {}
        self._seg_routes: dict[int, list] = {}  # replica -> current (t, req)s
        self.mode = Mode.parse(mode)
        self._ensure_fabric(self.mode)

    # ------------------------------------------------------------ hetero glue

    @staticmethod
    def _norm_model_spec(name: str, spec, device) -> tuple[LM, object]:
        """Normalize one ``models=`` entry to ``(LM, params)``. Accepts
        ``(LM, params)`` or ``(ArchConfig, params)`` — a config is wrapped
        in a fresh LM on the cluster's first device, so callers can hand
        archs straight from :func:`repro_torch.configs.get_arch`."""
        try:
            head, params = spec
        except (TypeError, ValueError):
            raise ValueError(
                f"models[{name!r}] must be (model, params); got {type(spec)}"
            ) from None
        if isinstance(head, LM):
            return head, params
        if hasattr(head, "n_layers"):  # an ArchConfig
            return LM(head, device=device), params
        raise ValueError(
            f"models[{name!r}][0] must be an LM or ArchConfig, "
            f"got {type(head)}"
        )

    @property
    def _hetero(self) -> bool:
        return self.models is not None and len(self.models) > 1

    def _plan_replicas(self, placement) -> Optional[list[str]]:
        """Pin one model name per split replica (None = homogeneous).
        ``placement`` overrides the planner's replica counts; either way
        every model gets ≥1 replica and counts sum to the device count.
        Assignment is contiguous in ``models`` insertion order — replica
        index blocks, deterministic for tests and logs."""
        if self.models is None:
            return None
        n = len(self.devices)
        if placement is not None:
            counts = dict(placement)
            unknown = set(counts) - set(self.models)
            if unknown:
                raise ValueError(f"placement names unknown models {unknown}")
            missing = set(self.models) - set(counts)
            if missing or any(c < 1 for c in counts.values()):
                raise ValueError(
                    "placement must give every model at least one replica"
                )
            if sum(counts.values()) != n:
                raise ValueError(
                    f"placement sums to {sum(counts.values())}, "
                    f"cluster has {n} devices"
                )
        else:
            counts = plan_hetero_placement(
                {name: m.cfg for name, (m, _) in self.models.items()}, n
            )
        out: list[str] = []
        for name in self.models:
            out.extend([name] * counts[name])
        return out

    def replica_plan(self) -> Optional[dict[str, list[int]]]:
        """{model name: replica indices} for a heterogeneous cluster
        (None when homogeneous) — the placement the planner or the
        ``placement=`` override committed to."""
        if self._replica_model is None:
            return None
        plan: dict[str, list[int]] = {name: [] for name in self.models}
        for i, name in enumerate(self._replica_model):
            plan[name].append(i)
        return plan

    def _resolve_model(self, req: Request) -> None:
        """Pin a request to a named model before routing: explicit
        ``req.model`` wins, then the tenant's ``tenant_models`` mapping,
        then the primary (first) model. Unknown names raise
        :class:`NoModelReplica` — routing a request onto a *different*
        model would silently change the distribution it samples from."""
        if self.models is None:
            return
        if req.model is None and req.tenant is not None:
            req.model = self.tenant_models.get(req.tenant)
        if req.model is None:
            req.model = next(iter(self.models))
        if req.model not in self.models:
            raise NoModelReplica(
                req.model,
                f"model {req.model!r} is not in this cluster's placement "
                f"({list(self.models)})",
            )

    # ----------------------------------------------------------------- fabric

    def _check_merge(self) -> None:
        """Raise unless this cluster can merge: a heterogeneous cluster is
        split-only (``ValueError``), and over two or more lanes the model and
        the engine options must be ones the merged engine takes
        (``NotImplementedError`` naming ROADMAP)."""
        if self._hetero:
            raise ValueError(
                f"merge mode cannot fuse {len(self.models)} different "
                "models into one engine; a heterogeneous cluster is "
                "split-only"
            )
        if len(self.devices) > 1:
            kw = self._engine_kw
            check_tensor_parallel(self.model.cfg, len(self.devices))
            check_merged_options(kw["kv_dtype"], kw["weight_dtype"], kw["speculate"])

    def _can_merge(self) -> bool:
        try:
            self._check_merge()
        except (ValueError, NotImplementedError):
            return False
        return True

    @property
    def engines(self) -> list[ServeEngine]:
        return self._fabrics[self.mode]

    @property
    def n_replicas(self) -> int:
        return len(self.engines)

    def _ensure_fabric(self, mode: Mode) -> tuple[bool, int]:
        """Build (or warm-reset) the engines for ``mode``.

        Returns ``(cached, bytes_placed)``: a cached fabric only resets its
        engines' tick state (placement survives). ``bytes_placed`` counts
        what this build allocated: every engine's cache, and weights copied
        onto another device or split over lanes (replicas on the weights'
        own device share them and place nothing)."""
        if mode in self._fabrics:
            for e in self._fabrics[mode]:
                e.reset()
            return True, 0
        # each engine its own LM view: no state of the model object is shared
        # between controller threads
        if mode is Mode.MERGE:
            self._check_merge()
            if len(self.devices) > 1:
                # one lane per entry (a stream of its own each): heads, MLP
                # width and vocabulary split over them
                info = serving_mesh_info(self.devices)
                backend = ShardedBackend(info)
                plan = [(LM(self.model.cfg, mesh_info=info), self.params, backend, self.seed)]
            else:  # one device: merge degenerates to a pinned plain engine
                d = self.devices[0]
                plan = [(LM(self.model.cfg, device=d), self.params, DeviceBackend(d),
                         self.seed)]
        else:
            plan = []
            for i, d in enumerate(self.devices):
                if self._replica_model is not None:
                    m, p = self.models[self._replica_model[i]]
                else:
                    m, p = self.model, self.params
                plan.append((LM(m.cfg, device=d), p, DeviceBackend(d), self.seed + i))
        engines = []
        placed = 0
        for m, p, backend, seed in plan:
            eng = ServeEngine(m, p, seed=seed, backend=backend, **self._engine_kw)
            engines.append(eng)
            placed += pytree_bytes(eng.cache) + _new_bytes(eng.params, p)
        for e in engines:
            e.backend.synchronize()
        self._fabrics[mode] = engines
        return False, placed

    def prewarm(self, sampling: bool = False) -> None:
        """Build the kernels and run every dispatch variant of the CURRENT
        mode's fabric once, off the serving path (replica prewarms run
        concurrently in split mode)."""
        engines = self.engines
        if len(engines) == 1:
            engines[0].prewarm(sampling)
            return
        with ThreadPoolExecutor(len(engines)) as ex:
            list(ex.map(lambda e: e.prewarm(sampling), engines))

    # ------------------------------------------------------------------ admit

    def submit(self, req: Request) -> RequestHandle:
        """Apply the tenant's default SamplingParams (if the request came
        without explicit config), route, and enqueue; returns a
        :class:`RequestHandle` owned by the cluster — its ``cancel()``
        follows the request to whichever engine currently holds it, across
        split/merge switches and mid-stream reconfiguration."""
        if req.tenant is not None and req.tenant in self.tenant_defaults:
            req.apply_default_params(self.tenant_defaults[req.tenant])
        self._resolve_model(req)  # raises NoModelReplica on unknown names
        if self.admission is not None:
            self._admission_gate(req)  # raises AdmissionRejected
        return self._submit_admitted(req)

    def _submit_admitted(self, req: Request) -> RequestHandle:
        engines = self.engines
        if self.mode is Mode.MERGE:  # one fused engine, no routing
            i = 0
        else:
            # split mode always routes — even a degenerate 1-replica fabric
            # keeps its JSQ/affinity telemetry truthful
            i = self.router.route(req)
        handle = engines[i].submit(req)
        handle._owner = self
        handle.replica = i
        self._where[req] = engines[i]
        return handle

    def _admission_gate(self, req: Request) -> None:
        """Gate a request against its PROSPECTIVE target replica's queue:
        depth bounds backpressure, queued cost feeds the TTFT predictor."""
        engines = self.engines
        i = 0 if self.mode is Mode.MERGE else self.router.peek(req)
        target = engines[i]
        depth = len(target.waiting)
        queued = sum(Router.cost(r) for r in target.waiting) + sum(
            float(r.params.max_new - len(r.generated))
            for r in target.slot_req
            if r is not None
        )
        self.admission.admit(req, queue_depth=depth, queue_cost=queued)

    def _arrival_gate(self, eng: ServeEngine, replica: Optional[int] = None):
        """Admission closure for one engine's arrival stream (engine.run
        ``gate=``): gates against the engine's LIVE queue at each
        request's scheduled arrival time. On rejection the pre-routed
        request's load charge and ownership entry are rolled back before
        the engine finalizes it as "rejected"."""
        if self.admission is None:
            return None
        adm = self.admission

        def gate(req: Request) -> None:
            depth = len(eng.waiting)
            queued = sum(Router.cost(r) for r in eng.waiting) + sum(
                float(r.params.max_new - len(r.generated))
                for r in eng.slot_req
                if r is not None
            )
            try:
                adm.admit(req, queue_depth=depth, queue_cost=queued)
            except AdmissionRejected:
                if replica is not None:
                    self.router.unassign(replica, req)
                self._where.pop(req, None)
                raise

        return gate

    def cancel(self, req: Request) -> None:
        """Abort a request wherever it currently lives (handle plumbing).
        Cancelling a request that already finished is a no-op, matching
        the engine-level semantics (a client-side timeout racing normal
        completion must not crash). A re-homed request's cancel follows it
        to the survivor's continuation; the sync pass then folds the
        "cancelled" outcome back into the original handle."""
        with self._rehome_lock:
            pair = self._rehomed_map.get(req)
        if pair is not None:
            req = pair[0]
        eng = self._where.get(req)
        if eng is None:
            if req.finish_reason is not None:
                return  # completed (and pruned from the ownership map)
            raise KeyError(f"request {req.rid} was never submitted to this cluster")
        eng.cancel(req)

    def _handle_pump(self, req: Request) -> None:
        """Progress hook for a blocked handle iterator: drive the owning
        engine when this thread can, politely poll when a controller
        thread owns it (split-mode replicas run under their own threads).
        For a re-homed request the survivor's CONTINUATION is pumped and
        its progress synced back into the original (the handle's view)."""
        with self._rehome_lock:
            pair = self._rehomed_map.get(req)
        target = pair[0] if pair is not None else req
        eng = self._where.get(target)
        if eng is None or eng._running or eng._poisoned:
            time.sleep(2e-4)
            return
        eng._handle_pump(target)
        if pair is not None:
            self._sync_rehomed()
        if req.complete:
            self._handle_done(req)

    def _handle_done(self, req: Request) -> None:
        """Drop a COMPLETE request from the ownership map — a purely
        handle-streamed request never passes through _run_segment's prune,
        and without this a run()-less cluster grows the map without bound.
        Only once complete (values harvested), never merely
        count-finished: the final chunk's tokens are still in flight when
        ``finish_reason`` lands, and the iterator needs the engine mapping
        to pump them home."""
        if req.complete:
            self._where.pop(req, None)

    # ------------------------------------------------------------ reconfigure

    def reconfigure(self, mode: Mode | str, drain_seconds: float = 0.0) -> ReconfigureReport:
        """Switch the serving fabric: collect undrained requests, re-place
        (or warm-reset) the target mode's engines, re-route the carried
        requests, and report the measured cost. Engines must be idle (no
        in-flight slots) — ``run()`` drains before returning, and the
        scheduled mid-stream path measures its drain into the report."""
        mode = Mode.parse(mode)
        if mode is Mode.MERGE:
            # refuse BEFORE draining queues — a failed fabric build after
            # the collect loop below would strand the carried requests
            self._check_merge()
        carried: list[Request] = []
        routed = self.mode is not Mode.MERGE  # split queues went through JSQ
        for idx, e in enumerate(self.engines):
            if any(r is not None for r in e.slot_req):
                raise RuntimeError(
                    "reconfigure() with in-flight slots; run() must drain first"
                )
            for r in e.waiting:
                if routed:  # re-routed below — give the JSQ load back
                    self.router.unassign(idx, r)
                carried.append(r)
            e.waiting.clear()
        carried.sort(key=lambda r: r.submitted_at)
        old = self.mode
        t0 = time.perf_counter()
        cached, placed = self._ensure_fabric(mode)
        place_s = time.perf_counter() - t0
        self.mode = mode
        for r in carried:
            t = r.submitted_at  # preserve the TTFT clock across the switch
            self.submit(r)  # re-homes _where, so live handles follow
            r.submitted_at = t
        rep = ReconfigureReport(
            str(old), str(mode), drain_seconds, place_s, placed, cached
        )
        self.reconfigures.append(rep)
        return rep

    # --------------------------------------------------- failure / re-homing

    def _make_tick(self, idx: int, wd: Optional[Watchdog]):
        """Per-replica heartbeat closure for the serving loop's on_tick:
        beat the watchdog lane, then run the (test-injectable) hook — in
        that order, so a stalling hook leaves the beat stale and the
        watchdog sees exactly the stall it is meant to catch."""
        hook = self.failure.tick_hook if self.failure is not None else None
        lane = f"replica{idx}"

        def tick() -> None:
            if wd is not None:
                wd.beat(lane)
            if hook is not None:
                hook(idx)

        return tick

    def _on_straggler(self, lane: str, state) -> None:
        self.stragglers += 1

    def _on_dead(self, lane: str, state) -> None:
        self._rehome_dead(int(lane.removeprefix("replica")))

    def _rehome_dead(self, idx: int) -> None:
        """Declare split replica ``idx`` dead and move its live requests
        to survivors. Runs on the watchdog thread while the dead replica's
        controller thread is stuck: the poison pill guarantees that if
        that thread ever resumes, it aborts at its next iteration boundary
        without touching the state re-homed here (beats only happen at
        iteration boundaries, so a dead verdict implies the thread is
        parked inside its tick hook or a dispatch, not mid-bookkeeping).

        Requests with committed (harvested) tokens continue on a survivor
        via :func:`build_continuation` — prompt' = prompt ++ committed —
        and their remaining draws land at the same absolute positions, so
        seeded streams stay bit-identical. Unharvested in-flight draws on
        the dead replica are re-derived (same fold_in key, same value)."""
        with self._rehome_lock:
            if idx in self._dead:
                return
            engines = self._fabrics[Mode.SPLIT]
            e = engines[idx]
            e._poisoned = True
            self._dead.add(idx)
            self.router.retire(idx)
            survivors = [
                j for j in range(len(engines)) if j not in self._dead
            ]
            # work the dead replica DID finish is kept, not re-served
            self.finished.extend(self._cont_orig.pop(r, r) for r in e.finished)
            e.finished = []
            if not survivors:
                return  # whole fabric gone: handles stay blocked, by design
            moved: list[Request] = []
            for r in list(e.waiting):
                if r.finish_reason is None:
                    self.router.unassign(idx, r)
                    moved.append(r)
            e.waiting.clear()
            for slot, r in enumerate(e.slot_req):
                if r is not None and r.finish_reason is None:
                    self.router.unassign(idx, r)
                    moved.append(r)
                e.slot_req[slot] = None
            e.slot_len[:] = 0
            e.slot_fed[:] = 0
            e._prefilling.clear()
            e._pending.clear()
            # scheduled arrivals the dead loop never got to submit
            seen = set(map(id, moved))
            for _t, r in self._seg_routes.get(idx, ()):
                if (
                    r.finish_reason is None
                    and r.submitted_at == 0.0
                    and id(r) not in seen
                ):
                    self.router.unassign(idx, r)
                    moved.append(r)
            for r in moved:
                try:
                    self._resubmit_rehomed(r)
                except NoModelReplica as exc:
                    # every replica serving this request's model died —
                    # close it out rather than continue on a survivor
                    # running a DIFFERENT model (wrong distribution)
                    self._mark_unroutable(r, exc)
            self.rehomed += len(moved)

    def _resubmit_rehomed(self, req: Request) -> None:
        """Hand one live request from a dead replica to a survivor.
        Caller holds ``_rehome_lock``; the router already skips the dead
        replica, so routing here lands on a survivor."""
        committed = len(req.generated)
        req.n_generated = committed  # in-flight draws will be re-derived
        if committed >= req.params.max_new:
            # fully harvested — nothing left to serve, just close it out
            req.finish_reason = req.finish_reason or "length"
            req.done_at = req.done_at or time.perf_counter()
            self.finished.append(req)
            return
        if committed == 0:
            # nothing committed: a clean restart IS the same stream
            # (fold_in keying — first draw lands at the same position)
            t = req.submitted_at
            self._submit_admitted(req)
            if t:
                req.submitted_at = t  # keep the original TTFT clock
            return
        cont, base = build_continuation(req)
        i = self.router.route(cont)
        eng = self._fabrics[Mode.SPLIT][i]
        eng.submit(cont)
        cont.submitted_at = req.submitted_at  # recovery latency is visible
        self._where[cont] = eng
        self._where[req] = eng
        self._rehomed_map[req] = (cont, base)
        self._cont_orig[cont] = req

    def _sync_rehomed(self) -> None:
        """Fold re-homed continuations' progress back into their original
        request objects — the handles clients hold point at the originals.
        Safe to call from any thread; completed pairs are retired here
        (the finished-list fold maps cont→orig separately)."""
        with self._rehome_lock:
            for orig, (cont, base) in list(self._rehomed_map.items()):
                synced = len(orig.generated) - base
                fresh = cont.generated[synced:]
                if fresh:
                    orig.generated.extend(fresh)
                if (
                    orig.first_token_at is None
                    and cont.first_token_at is not None
                ):
                    orig.first_token_at = cont.first_token_at
                if cont.complete:
                    orig.n_generated = base + cont.n_generated
                    orig.finish_reason = cont.finish_reason
                    orig.done_at = cont.done_at
                    del self._rehomed_map[orig]

    def _mark_unroutable(self, req: Request, exc: NoModelReplica) -> None:
        """Close out a request no live replica can serve (typed rejection,
        same bookkeeping as an arrival-stream admission rejection)."""
        req.finish_reason = "rejected"
        req.reject_reason = exc.reason
        req.done_at = time.perf_counter()
        self._where.pop(req, None)
        self.finished.append(req)

    # -------------------------------------------------------------------- run

    def _run_segment(
        self, seg_arrivals: list, deadline_s: Optional[float] = None
    ) -> SegmentStats:
        engines = self.engines
        # arrival-stream requests take the same intake path as submit():
        # tenant default params attach and the ownership map learns their
        # engine (so handle.cancel() reaches a request that arrived
        # mid-stream, and per-tenant policy is honoured either way).
        # Admission is NOT gated here: routing happens at handover but the
        # gate fires at each request's scheduled arrival time, on the
        # serving thread, against the live queue (engine.run's ``gate=``) —
        # intake-time gating would wave an entire burst through because
        # the queue was empty when the slice was handed over.
        rejected: list[Request] = []
        for _, req in seg_arrivals:
            if req.tenant is not None and req.tenant in self.tenant_defaults:
                req.apply_default_params(self.tenant_defaults[req.tenant])
            try:
                self._resolve_model(req)
            except NoModelReplica as exc:
                self._mark_unroutable(req, exc)
                rejected.append(req)
        if rejected:
            dropped = set(map(id, rejected))
            seg_arrivals = [
                (t, r) for t, r in seg_arrivals if id(r) not in dropped
            ]
        if self.mode is Mode.MERGE:
            for _, req in seg_arrivals:
                self._where[req] = engines[0]
            stats = [
                engines[0].run(
                    arrivals=seg_arrivals or None,
                    deadline_s=deadline_s,
                    gate=self._arrival_gate(engines[0]),
                )
            ]
        else:
            per: list[list] = [[] for _ in engines]
            for t, req in seg_arrivals:
                try:
                    i = self.router.route(req)
                except NoModelReplica as exc:
                    # the pinned model's replicas are all dead: reject —
                    # serving the request on a different model's survivor
                    # would silently answer from the wrong distribution
                    self._mark_unroutable(req, exc)
                    continue
                per[i].append((t, req))
                self._where[req] = engines[i]
            self._seg_routes = {i: pl for i, pl in enumerate(per)}
            if len(engines) == 1:  # degenerate split: no threads needed
                stats = [
                    engines[0].run(
                        arrivals=(per[0] or None),
                        deadline_s=deadline_s,
                        gate=self._arrival_gate(engines[0]),
                    )
                ]
            else:
                stats = self._run_split_threads(engines, per, deadline_s)
            self._seg_routes = {}
        self._sync_rehomed()
        if not stats:
            stats = [ServeStats()]
        carrier = stats[0]  # stream-stats fold target (order-independent:
        # the threaded path returns stats in completion order, and a dead
        # replica's stats are lost with its thread)
        for i, e in enumerate(engines):
            if self.mode is not Mode.MERGE and i in self._dead:
                continue  # folded once, at declaration time (_rehome_dead)
            # work served OUTSIDE run() — handle-driven streaming and idle
            # cancellations — landed in the engine's stream-stats; fold
            # every counter into this segment (and zero them) so
            # ClusterStats reports the whole session, not just the drains
            ss = e.stream_stats
            carrier.total_tokens += ss.total_tokens
            carrier.total_requests += ss.total_requests
            carrier.ticks += ss.ticks
            carrier.cancelled += ss.cancelled
            ss.total_tokens = ss.total_requests = ss.ticks = ss.cancelled = 0
            # a survivor's finished list may hold re-homed CONTINUATIONS —
            # clients only know the originals, so map them back
            self.finished.extend(self._cont_orig.pop(r, r) for r in e.finished)
            e.finished = []
        # drop completed requests from the ownership map (cancellation can
        # no longer reach them; keeps the map from growing unboundedly)
        self._where = {r: e for r, e in self._where.items() if r.finish_reason is None}
        return SegmentStats(str(self.mode), stats)

    def _run_split_threads(
        self,
        engines: list[ServeEngine],
        per: list[list],
        deadline_s: Optional[float],
    ) -> list[ServeStats]:
        """One controller thread per replica — the paper's "each core
        driven by its own scalar core"; each engine queues its work on its
        backend's stream, so two replicas on one card do not serialize.
        With a :class:`FailurePolicy` armed, a watchdog monitors
        per-iteration heartbeats; a replica declared dead has its
        future ABANDONED (never joined — shutdown(wait=False) leaves the
        stuck thread to die on the poison pill) and its requests re-homed,
        after which any survivor that already returned is re-run to drain
        the work it inherited."""
        wd = None
        if self.failure is not None:
            wd = Watchdog(
                straggler_after=self.failure.straggler_after,
                dead_after=self.failure.dead_after,
                poll=self.failure.poll,
                on_straggler=self._on_straggler,
                on_dead=self._on_dead,
            )
            for i in range(len(engines)):
                if i not in self._dead:
                    wd.register(f"replica{i}")
            wd.start()
        ex = ThreadPoolExecutor(len(engines))
        stats: list[ServeStats] = []
        try:
            futs = {
                i: ex.submit(
                    e.run,
                    arrivals=(pl or None),
                    deadline_s=deadline_s,
                    on_tick=self._make_tick(i, wd),
                    gate=self._arrival_gate(e, i),
                )
                for i, (e, pl) in enumerate(zip(engines, per))
                if i not in self._dead
            }
            done: set[int] = set()
            while futs:
                if wd is not None:
                    # a replica that finished its stream stops beating —
                    # keep its lane fresh so only genuinely stuck threads
                    # (not early finishers) can be declared dead
                    for i in done:
                        wd.beat(f"replica{i}")
                for i in list(futs):
                    if i in self._dead:
                        futs.pop(i)  # abandoned: poison pill reaps it
                        continue
                    try:
                        stats.append(futs[i].result(timeout=0.02))
                    except _FutTimeout:
                        continue
                    futs.pop(i)
                    done.add(i)
            if wd is not None:  # concurrency over: nothing left to monitor
                # a replica is marked dead before its requests move, so the
                # loop above can end while the watchdog thread is still
                # re-homing: wait for its last sweep, or the drain below
                # could miss work handed to a survivor after it looked
                wd.stop()
                wd = None
            # survivors may have inherited re-homed work AFTER their run
            # returned — drain it now (skipped under a deadline: the next
            # control interval serves it)
            if deadline_s is None:
                progressed = True
                while progressed:
                    progressed = False
                    for i, e in enumerate(engines):
                        if i in self._dead:
                            continue
                        if e.waiting or any(
                            r is not None for r in e.slot_req
                        ):
                            stats.append(
                                e.run(on_tick=self._make_tick(i, None))
                            )
                            progressed = True
        finally:
            ex.shutdown(wait=False)
            if wd is not None:
                wd.stop()
        return stats

    def run(self, arrivals=None, reconfigure_schedule=None) -> ClusterStats:
        """Drain all submitted work (+ an optional open-loop ``arrivals``
        schedule), optionally switching modes mid-stream.

        ``reconfigure_schedule``: ``[(t_offset_seconds, mode), ...]`` —
        at each offset the cluster stops admitting, drains in-flight
        chunks, reconfigures, and resumes with the remaining arrivals.
        Arrival offsets stay anchored to the ORIGINAL stream clock: a
        segment's offsets are re-based by the wall time already consumed
        (serving + drain + re-placement), going negative when the switch
        overran an arrival — the engine then submits it immediately with
        its true scheduled ``submitted_at``, so reconfiguration latency
        SHOWS UP in TTFT instead of hiding behind a restarted clock (the
        same no-hiding rule as the engine's own arrival handling)."""
        schedule = sorted(reconfigure_schedule or [], key=lambda x: x[0])
        arr = sorted(arrivals or [], key=lambda a: a[0])
        segments: list[SegmentStats] = []
        reports: list[ReconfigureReport] = []
        base = self._counter_base()
        elapsed = 0.0  # true wall time consumed before the current segment
        for idx in range(len(schedule) + 1):
            if idx < len(schedule):
                t_switch, nxt = schedule[idx]
                seg_arr = [(t - elapsed, r) for t, r in arr if t < t_switch]
                arr = [(t, r) for t, r in arr if t >= t_switch]
            else:
                t_switch, nxt = None, None
                seg_arr = [(t - elapsed, r) for t, r in arr]
            seg = self._run_segment(seg_arr)
            segments.append(seg)
            if t_switch is None:
                break
            drain = max(0.0, seg.wall_seconds - max(t_switch - elapsed, 0.0))
            rep = self.reconfigure(nxt, drain_seconds=drain)
            reports.append(rep)
            # drain already lives inside seg.wall_seconds; only the
            # re-placement extends the clock beyond the segment
            elapsed += seg.wall_seconds + rep.place_seconds
        return self._finish_stats(segments, reports, base)

    def run_controlled(
        self, arrivals=None, controller=None
    ) -> ClusterStats:
        """Closed-loop serving: slice the stream into control intervals,
        observe a :class:`~repro_torch.serve.controller.WindowSample` at each
        boundary, and let the controller trigger split↔merge switches.

        Each interval runs with ``deadline_s`` — in-flight slots drain at
        the boundary but queued work stays queued, which is exactly the
        reconfigure()-safe state — so a committed switch carries the
        backlog to the new fabric. A ``controller`` defaults to
        :meth:`ReconfigController.for_cluster`; anything with the same
        ``interval_s`` / ``observe`` / ``note_switched`` surface works
        (tests drive the machinery with scripted deciders)."""
        ctl = (
            controller
            if controller is not None
            else ReconfigController.for_cluster(self)
        )
        arr = sorted(arrivals or [], key=lambda a: a[0])
        segments: list[SegmentStats] = []
        reports: list[ReconfigureReport] = []
        base = self._counter_base()
        elapsed = 0.0
        while True:
            interval = ctl.interval_s
            t_end = elapsed + interval
            seg_arr = [(t - elapsed, r) for t, r in arr if t < t_end]
            arr = [(t, r) for t, r in arr if t >= t_end]
            seg = self._run_segment(seg_arr, deadline_s=interval)
            segments.append(seg)
            seg_wall = seg.wall_seconds
            if arr and seg_wall < interval and not self._work_pending():
                # idle gap: sleep the stream clock forward to the next
                # arrival (bounded by one control interval)
                gap = min(interval, arr[0][0] - elapsed) - seg_wall
                if gap > 0:
                    time.sleep(gap)
                    seg_wall += gap
            elapsed += seg_wall
            # ---- observe + decide
            sample = self._window_sample(seg, seg_arr, elapsed)
            warm = self._other_mode(self.mode) in self._fabrics
            decision = ctl.observe(sample, warm_target=warm)
            if decision is not None and decision.mode is Mode.MERGE and not self._can_merge():
                # un-mergeable (pinned models, or what the merged engine does
                # not take): the fabric stays split
                decision = None
            if decision is not None and decision.mode is not self.mode:
                self._sync_rehomed()
                rep = self.reconfigure(
                    decision.mode,
                    drain_seconds=max(0.0, seg_wall - interval),
                )
                reports.append(rep)
                ctl.note_switched(elapsed, rep)
                elapsed += rep.place_seconds
            # ---- service-rate feedback for the deadline predictor
            if self.admission is not None:
                toks = sum(r.total_tokens for r in seg.replicas)
                live = max(len(seg.replicas), 1)
                if toks and seg.wall_seconds > 0:
                    self.admission.note_service_rate(
                        toks / seg.wall_seconds / live
                    )
            if not arr and not self._work_pending():
                break
        return self._finish_stats(segments, reports, base)

    def _work_pending(self) -> bool:
        for i, e in enumerate(self.engines):
            if self.mode is not Mode.MERGE and i in self._dead:
                continue
            if e.waiting or any(r is not None for r in e.slot_req):
                return True
        return False

    def _window_sample(
        self, seg: SegmentStats, seg_arr: list, elapsed: float
    ) -> WindowSample:
        depth = 0
        for i, e in enumerate(self.engines):
            if self.mode is not Mode.MERGE and i in self._dead:
                continue
            depth += len(e.waiting)
        reqs = [r for _, r in seg_arr]
        ttfts = [t for r in seg.replicas for t in r.ttfts]
        tpots = [t for r in seg.replicas for t in r.tpots]
        return WindowSample(
            t=elapsed,
            mode=str(self.mode),
            queue_depth=depth,
            n_requests=len(reqs),
            prompt_tokens=sum(len(r.prompt) for r in reqs),
            decode_tokens=sum(r.params.max_new for r in reqs),
            longest_tokens=max(
                (r.params.max_new for r in reqs), default=0
            ),
            n_tenants=len({r.tenant for r in reqs if r.tenant is not None}),
            ttft_p99=percentile(ttfts, 99),
            tpot_p99=percentile(tpots, 99),
        )

    @staticmethod
    def _other_mode(mode: Mode) -> Mode:
        return Mode.MERGE if mode is Mode.SPLIT else Mode.SPLIT

    def _counter_base(self) -> dict:
        adm = self.admission
        return dict(
            rehomed=self.rehomed,
            stragglers=self.stragglers,
            dead=len(self._dead),
            shed=adm.shed if adm is not None else 0,
            rejected=adm.rejected if adm is not None else 0,
        )

    def _finish_stats(
        self,
        segments: list[SegmentStats],
        reports: list[ReconfigureReport],
        base: dict,
    ) -> ClusterStats:
        modes = [s.mode for s in segments]
        # collapse only ADJACENT repeats: a split->merge->split round trip
        # must read as such, not dedupe to "split->merge"
        mode_label = "->".join(
            m for i, m in enumerate(modes) if i == 0 or modes[i - 1] != m
        )
        st = ClusterStats(
            mode=mode_label,
            segments=segments,
            reconfigures=reports,
        )
        st.rehomed = self.rehomed - base["rehomed"]
        st.stragglers = self.stragglers - base["stragglers"]
        st.dead_replicas = len(self._dead) - base["dead"]
        if self.admission is not None:
            st.shed = self.admission.shed - base["shed"]
            st.rejected = self.admission.rejected - base["rejected"]
        return st

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"ServeCluster(mode={self.mode}, devices={len(self.devices)}, "
            f"replicas={self.n_replicas})"
        )
