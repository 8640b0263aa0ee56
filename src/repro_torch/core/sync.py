"""Fine-grained synchronization harness (counterpart of
``repro/core/sync.py``; paper §III: "MM fft outperforms SM fft by more than
20% ... by reducing the synchronization overhead of the multi-core
architecture").

A sync-bound kernel is modeled as repeated rounds of

    x -> phase_a (shard-local)  ->  EXCHANGE (crosses shards)  ->  phase_b

— the shape of a distributed FFT (row FFT → corner-turn transpose → column
FFT) and of tensor-parallel matmul chains. Two executions of one kernel:

* :func:`run_merged` — ONE controller over the fused lanes, x's rows sharded
  over every lane. The exchange stays on the device: each lane's block of
  the transpose is copied from every lane on the lanes' streams, ordered by
  CUDA events. No host copy or synchronize between rounds, only at the end
  of a run. Merge mode: a single control stream drives all vector units.
* :func:`run_split_staged` — the multi-controller baseline: each pod owns
  its rows and runs per-phase work; every exchange goes through the host
  (fetch the parts → numpy transpose → scatter back) with a barrier per
  phase. The gap to merged is the port's inter-core synchronization cost.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.cluster import SpatzformerCluster
from repro_torch.dist.sharding import (
    Lane,
    Mesh,
    NamedSharding,
    P,
    ShardedTensor,
    copy_between,
    device_put,
    gather,
)


@dataclass
class TwoPhaseKernel:
    """rounds × (phase_a → transpose-exchange → phase_b) over x: [R, C]. A
    phase maps one lane's contiguous row block to its result."""

    name: str
    phase_a: Callable[[torch.Tensor], torch.Tensor]  # row-local
    phase_b: Callable[[torch.Tensor], torch.Tensor]  # row-local (after transpose)
    rounds: int = 1


# ---------------------------------------------------------------------------
# kernel instances
# ---------------------------------------------------------------------------


def fft2d_kernel(rounds: int = 4) -> TwoPhaseKernel:
    """2-D FFT per round: FFT rows → corner turn → FFT (former) columns."""

    def phase(x):
        return torch.fft.fft(x, dim=-1)

    return TwoPhaseKernel("fft2d", phase, phase, rounds)


def matmul_chain_kernel(w1, w2, rounds: int = 4) -> TwoPhaseKernel:
    """TP-style chain: (x@W1)ᵀ@W2 per round — one exchange per round. The
    GELU is JAX's default, the tanh approximation."""
    ws = {}

    def on(k: int, w, device: torch.device) -> torch.Tensor:
        # each weight on a lane's device, copied once per device
        if (k, device) not in ws:
            ws[k, device] = torch.as_tensor(w).to(device)
        return ws[k, device]

    def a(x):
        return F.gelu(x.float() @ on(1, w1, x.device), approximate="tanh")

    def b(x):
        return x.float() @ on(2, w2, x.device)

    return TwoPhaseKernel("matmul_chain", a, b, rounds)


# ---------------------------------------------------------------------------
# per-lane pieces
# ---------------------------------------------------------------------------


def _rows_sharding(lanes: list[Lane]) -> NamedSharding:
    return NamedSharding(Mesh(lanes, ("fab",)), P("fab", None))


def _phase(fn: Callable, x: ShardedTensor) -> ShardedTensor:
    """``fn`` on every lane's row block, queued on the lane's stream."""
    shards = []
    for lane, t in zip(x.lanes, x.shards):
        with lane.use():
            shards.append(fn(t))
    return ShardedTensor((x.shape[0], shards[0].shape[1]), shards[0].dtype, x.sharding,
                         shards)


def _corner_turn(x: ShardedTensor) -> ShardedTensor:
    """x [R, C] rows over p lanes → xᵀ [C, R] rows over the same lanes, on
    the device: lane j's block is every lane i's columns j, transposed, each
    copied on lane j's stream after lane i's queued work."""
    lanes, p = x.lanes, len(x.lanes)
    r, c = x.shape
    if c % p:
        raise ValueError(f"{c} columns do not divide over {p} lanes")
    rb, cb = r // p, c // p
    out = []
    for j, lane in enumerate(lanes):
        with lane.use():
            o = torch.empty((cb, r), dtype=x.dtype, device=lane.device)
        for i, (src, t) in enumerate(zip(lanes, x.shards)):
            copy_between(o[:, i * rb:(i + 1) * rb], lane, t[:, j * cb:(j + 1) * cb].T, src)
        out.append(o)
    return ShardedTensor((c, r), x.dtype, x.sharding, out)


# ---------------------------------------------------------------------------
# merged execution: one controller, on-device exchange
# ---------------------------------------------------------------------------


def run_merged(
    kernel: TwoPhaseKernel, x, cluster: SpatzformerCluster, *, repeats: int = 3
) -> tuple[np.ndarray, float, Callable]:
    """Returns (result, best_seconds, program for inspection): ``program``
    maps x sharded over the fused lanes to the result, queued on the lanes
    without waiting."""
    sh = _rows_sharding(cluster.merged_mesh.lanes)

    def program(xx: ShardedTensor) -> ShardedTensor:
        for _ in range(kernel.rounds):
            xx = _corner_turn(_phase(kernel.phase_a, xx))  # exchange
            xx = _corner_turn(_phase(kernel.phase_b, xx))  # restore layout
        return xx

    xd = device_put(torch.as_tensor(x), sh)
    y = program(xd)  # warmup (plans, first launches)
    sh.mesh.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        y = program(xd)
        sh.mesh.synchronize()
        best = min(best, time.perf_counter() - t0)
    return gather(y, "cpu").numpy(), best, program


# ---------------------------------------------------------------------------
# split execution: per-pod work, host-mediated exchange + barrier
# ---------------------------------------------------------------------------


def run_split_staged(
    kernel: TwoPhaseKernel, x, cluster: SpatzformerCluster, *, repeats: int = 3
) -> tuple[np.ndarray, float]:
    shs = [_rows_sharding(info.mesh.lanes) for info in cluster.split_infos()]
    n_pods = len(shs)
    x = np.asarray(x)

    def scatter(glob: np.ndarray) -> list[ShardedTensor]:
        return [device_put(torch.as_tensor(h), s)
                for h, s in zip(np.split(glob, n_pods, axis=0), shs)]

    def fetch(parts: list[ShardedTensor]) -> np.ndarray:
        return np.concatenate([gather(p, "cpu").numpy() for p in parts], axis=0)

    def one_run() -> np.ndarray:
        parts = scatter(x)
        for _ in range(kernel.rounds):
            parts = [_phase(kernel.phase_a, p) for p in parts]
            for s in shs:  # barrier: controllers wait on their vector units
                s.mesh.synchronize()
            parts = scatter(fetch(parts).T)  # host-mediated corner turn across pods
            parts = [_phase(kernel.phase_b, p) for p in parts]
            for s in shs:
                s.mesh.synchronize()
            parts = scatter(fetch(parts).T)
        return fetch(parts)

    y = one_run()  # warmup
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        y = one_run()
        best = min(best, time.perf_counter() - t0)
    return y, best
