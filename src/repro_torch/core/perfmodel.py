"""Discrete-event performance model of the fabric (NVIDIA H100 SXM defaults).

A copy of ``repro/core/perfmodel.py`` with the same formulas: the
reconfiguration controller (``serve/controller.py``) turns a windowed
serving mix into predicted split and merge seconds through
:func:`model_serving_mode`. Every input is a hardware constant or a
measured one:

* the data sheet's peaks (bf16 dense tensor-core FLOP/s, HBM3 bytes/s,
  NVLink and PCIe Gen5 x16 bytes/s a direction);
* ``launch_overhead`` and ``barrier_overhead`` as ``chip_smoke.py``'s
  cluster phase measures them on the card (``PERF.md`` gives the card's
  name and power limit beside them).

The energy constants are model parameters, not a measurement of this card.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# chip_smoke.py's phase 12 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# host seconds per launch over 2,000 empty launches, and per round of a
# two-thread barrier + torch.cuda.synchronize (500 rounds)
LAUNCH_OVERHEAD_S = 6.55e-6
BARRIER_OVERHEAD_S = 191.6e-6


@dataclass(frozen=True)
class HardwareModel:
    """Per-device and system constants (H100 SXM defaults)."""

    peak_flops: float = 989e12  # bf16 dense tensor-core FLOP/s (data sheet)
    hbm_bw: float = 3.35e12  # B/s, HBM3 (data sheet)
    ici_bw: float = 450e9  # B/s per device, one direction: NVLink 4 (900 GB/s both ways)
    launch_overhead: float = LAUNCH_OVERHEAD_S
    barrier_overhead: float = BARRIER_OVERHEAD_S
    pcie_bw: float = 64e9  # B/s host<->device, PCIe Gen5 x16, one direction
    # energy constants: model parameters, not a measurement of this card
    pj_per_flop: float = 0.35
    pj_per_hbm_byte: float = 60.0
    pj_per_ici_byte: float = 30.0
    j_per_launch: float = 5e-3


H100 = HardwareModel()


@dataclass
class KernelCost:
    """Roofline-style cost of one device program (GLOBAL totals)."""

    name: str
    flops: float
    hbm_bytes: float
    coll_bytes: float = 0.0  # bytes crossing chip boundaries on-device

    def device_seconds(self, chips: int, hw: HardwareModel = H100) -> float:
        t_c = self.flops / (chips * hw.peak_flops)
        t_m = self.hbm_bytes / (chips * hw.hbm_bw)
        t_x = self.coll_bytes / (chips * hw.ici_bw)
        return max(t_c, t_m, t_x)

    def energy_j(self, hw: HardwareModel = H100) -> float:
        return (
            self.flops * hw.pj_per_flop * 1e-12
            + self.hbm_bytes * hw.pj_per_hbm_byte * 1e-12
            + self.coll_bytes * hw.pj_per_ici_byte * 1e-12
        )


@dataclass
class ModeledRun:
    """Outcome of simulating one schedule."""

    makespan: float
    vector_busy: float
    scalar_busy: float
    launches: int
    host_exchange_bytes: float
    energy_j: float
    detail: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# schedule-level models (mirror core.scheduler / core.sync exactly)
# ---------------------------------------------------------------------------


def model_vector_stream(
    kernels: list[KernelCost], chips: int, hw: HardwareModel = H100
) -> tuple[float, float]:
    """(seconds, energy) for a controller draining kernels on `chips` chips."""
    t = 0.0
    e = 0.0
    for k in kernels:
        t += hw.launch_overhead + k.device_seconds(chips, hw)
        e += k.energy_j(hw) + hw.j_per_launch
    return t, e


def model_mixed_split(
    kernels: list[KernelCost],
    scalar_seconds: float,
    chips_per_pod: int,
    hw: HardwareModel = H100,
) -> ModeledRun:
    """Paper's SM penalty case: scalar queue consumes controller-1 (its pod
    idles); ALL vector work runs on pod-0's chips."""
    t_vec, e = model_vector_stream(kernels, chips_per_pod, hw)
    makespan = max(t_vec, scalar_seconds)
    return ModeledRun(
        makespan=makespan,
        vector_busy=t_vec,
        scalar_busy=scalar_seconds,
        launches=len(kernels),
        host_exchange_bytes=0.0,
        energy_j=e,
    )


def model_mixed_merge(
    kernels: list[KernelCost],
    scalar_seconds: float,
    total_chips: int,
    hw: HardwareModel = H100,
    merge_coll_penalty: float = 0.0,
) -> ModeledRun:
    """MM: vector stream on the fused fabric; scalar work fully overlapped on
    the freed controller. merge_coll_penalty: extra per-kernel collective
    bytes for the pod-spanning axis (cross-pod DP sync), if any."""
    adj = [
        KernelCost(k.name, k.flops, k.hbm_bytes, k.coll_bytes + merge_coll_penalty)
        for k in kernels
    ]
    t_vec, e = model_vector_stream(adj, total_chips, hw)
    makespan = max(t_vec, scalar_seconds)
    return ModeledRun(
        makespan=makespan,
        vector_busy=t_vec,
        scalar_busy=scalar_seconds,
        launches=len(kernels),
        host_exchange_bytes=0.0,
        energy_j=e,
    )


def model_staged_split(
    phase: KernelCost,
    rounds: int,
    exchange_bytes: float,
    chips_per_pod: int,
    n_pods: int = 2,
    hw: HardwareModel = H100,
    exchange_over: str = "ici",
) -> ModeledRun:
    """Split/baseline execution of a two-phase sync-bound kernel.

    Per round: 2 × (per-pod phase program + barrier) + a host-orchestrated
    corner-turn exchange. The pods ARE physically linked, so by default the
    exchange program still moves bytes over ICI (``exchange_over='ici'``) —
    but it is a SEPARATE launch per pod with barriers, and nothing overlaps
    (phases, exchange, and sync serialize). ``exchange_over='pcie'`` models
    the worst case where data is staged through the hosts. ``ici`` names
    the device-to-device link (NVLink on this card).
    """
    total_chips = chips_per_pod * n_pods
    per_phase = KernelCost(
        phase.name, phase.flops / n_pods, phase.hbm_bytes / n_pods, 0.0
    )
    if exchange_over == "ici":
        t_x = exchange_bytes / (total_chips * hw.ici_bw)
        x_host_bytes = 0.0
    else:
        t_x = 2 * exchange_bytes / hw.pcie_bw
        x_host_bytes = 2 * exchange_bytes
    t = 0.0
    e = 0.0
    launches = 0
    for _ in range(rounds):
        for _ in range(2):  # phase_a, phase_b
            t += hw.launch_overhead + per_phase.device_seconds(chips_per_pod, hw)
            t += hw.barrier_overhead
            launches += n_pods
            e += phase.energy_j(hw) + n_pods * hw.j_per_launch
        # two corner-turn exchange programs per round (turn + restore), each
        # its own launch + barrier on both pods
        t += 2 * (t_x + hw.launch_overhead + hw.barrier_overhead)
        launches += 2 * n_pods
        e += 2 * (
            exchange_bytes * hw.pj_per_ici_byte * 1e-12 + n_pods * hw.j_per_launch
        )
    return ModeledRun(
        makespan=t,
        vector_busy=t,
        scalar_busy=0.0,
        launches=launches,
        host_exchange_bytes=2 * x_host_bytes * rounds,
        energy_j=e,
    )


def model_staged_merge(
    phase: KernelCost,
    rounds: int,
    exchange_bytes: float,
    total_chips: int,
    hw: HardwareModel = H100,
) -> ModeledRun:
    """Merged execution: ONE program for all rounds; exchanges are on-device
    all-to-alls on ICI; a single dispatch; and — the key merge-mode win —
    the scheduler OVERLAPS round r's collective with round r±1's compute
    (async collectives inside one program), so the makespan is
    launch + max(Σcompute, Σcomm) + one un-overlappable pipeline fill."""
    t_phase = 2 * rounds * phase.device_seconds(total_chips, hw)
    t_x_one = 2 * exchange_bytes / (total_chips * hw.ici_bw)
    t_x = rounds * t_x_one
    t = hw.launch_overhead + max(t_phase, t_x) + min(t_phase, t_x_one)
    e = hw.j_per_launch + 2 * rounds * phase.energy_j(hw) + (
        2 * rounds * exchange_bytes * hw.pj_per_ici_byte * 1e-12
    )
    return ModeledRun(
        makespan=t,
        vector_busy=t,
        scalar_busy=0.0,
        launches=1,
        host_exchange_bytes=0.0,
        energy_j=e,
    )


# ---------------------------------------------------------------------------
# serving-mode model (the reconfiguration controller's decision input)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServingMix:
    """A windowed serving workload, summarized for mode prediction.

    The controller (:mod:`repro_torch.serve.controller`) folds its sliding
    window of arrival/queue observations into one of these; the model
    below turns it into predicted split vs merge makespans. Token costs
    (``flops_per_token``, ``hbm_bytes_per_token``) come from the served
    model's parameter count; the scheduling constants mirror the engine's
    (``prefill_budget`` prompt tokens packed per iteration, fused decode
    chunks of ``max_chunk`` steps, ``batch_slots`` concurrent slots).
    """

    n_requests: int
    prompt_tokens: float  # Σ prompt length over the window
    decode_tokens: float  # Σ max_new (or observed generated) over the window
    longest_tokens: float  # max decode length of any single request
    flops_per_token: float  # ~2 × parameter count
    hbm_bytes_per_token: float  # ~parameter bytes (weight stream per step)
    coll_bytes_per_token: float = 1e5  # merge-mode per-row activation exchange
    prefill_budget: int = 64
    max_chunk: int = 8
    batch_slots: int = 4


def model_serving_mode(
    mix: ServingMix, n_devices: int, mode: str, hw: HardwareModel = H100
) -> float:
    """Predicted seconds to serve ``mix`` in ``mode`` ("split"|"merge").

    Mirrors the engine's scheduling structure rather than a pure roofline:

    * **prefill** is admission-bandwidth-bound — each engine packs at most
      ``prefill_budget`` prompt tokens per scheduling iteration, so split
      mode's n independent pack streams admit n× faster (the paper's
      many-small-tasks story), while each merge iteration pays a barrier;
    * **decode** is a sequence of fused chunk steps — the sequential depth
      is the longest stream (or the queue serialized through the slots),
      each step streams the weights once per engine (batch-amortized), so
      merge mode's n-chip HBM makes memory-bound decode n× faster but
      pays per-row activation collectives and per-chunk barriers.

    Few long requests → merge wins (HBM). Many short ones → split wins
    (admission bandwidth, no barriers). With n_devices == 1 both modes
    degenerate to the same engine and the prediction collapses too.
    """
    assert mode in ("split", "merge"), mode
    n = max(int(n_devices), 1)
    chips = n if mode == "merge" else 1
    replicas = 1 if mode == "merge" else n
    barrier = hw.barrier_overhead if mode == "merge" else 0.0
    # --- prefill: iterations are serialized per engine by the pack budget
    share_p = mix.prompt_tokens / replicas
    iters = -(-share_p // mix.prefill_budget) if share_p > 0 else 0.0
    t_pack = max(
        mix.prefill_budget * mix.flops_per_token / (chips * hw.peak_flops),
        mix.hbm_bytes_per_token / (chips * hw.hbm_bw),
    )
    t_prefill = iters * (hw.launch_overhead + barrier + t_pack)
    # --- decode: sequential chunk steps over the batched slots
    share_d = mix.decode_tokens / replicas
    b = min(mix.batch_slots, max(1, round(mix.n_requests / replicas)))
    steps = max(mix.longest_tokens, share_d / b)
    t_step = max(
        b * mix.flops_per_token / (chips * hw.peak_flops),
        mix.hbm_bytes_per_token / (chips * hw.hbm_bw),
    )
    if mode == "merge":
        t_step += b * mix.coll_bytes_per_token / hw.ici_bw
    dispatches = steps / mix.max_chunk
    t_decode = steps * t_step + dispatches * (hw.launch_overhead + barrier)
    return t_prefill + t_decode


def serving_mode_advice(
    mix: ServingMix, n_devices: int, hw: HardwareModel = H100
) -> tuple[str, dict[str, float]]:
    """(best_mode, {"split": s, "merge": s}) for a windowed workload."""
    seconds = {
        m: model_serving_mode(mix, n_devices, m, hw) for m in ("split", "merge")
    }
    best = min(seconds, key=lambda m: (seconds[m], m))
    return best, seconds
