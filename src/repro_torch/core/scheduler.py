"""Mixed scalar-vector workload scheduler (counterpart of
``repro/core/scheduler.py``; paper §III, Fig. 2 right).

Maps two task queues onto the lane fabric according to the current mode:

* **MERGE** — the controller-0 thread drives the *vector* queue on the fused
  view (every lane per kernel); the freed controller thread drains the
  *scalar* queue concurrently. Scalar work hides behind device compute
  while the vector thread waits on its lanes.
* **SPLIT + scalar work present** — the paper's penalty case: one controller
  is consumed by the scalar queue, leaving its vector unit idle; the other
  runs every vector task on just its own pod (half the lanes).
* **SPLIT, vector-only** — two-tenant mode: vector tasks round-robin across
  pods and run concurrently.

Each VectorTask receives the :class:`MeshInfo` of whatever fabric slice the
scheduler assigned and queues its work on that view's lanes (the same task
body runs in every mode). A controller thread makes its view's first device
current, enters its lanes' streams (the current stream is thread-local) and,
after each vector task, blocks until
its lanes finish through ``Stream.synchronize``, which releases the GIL for
the other controller; a task's time is read only after that.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.core.cluster import SpatzformerCluster
from repro_torch.core.modes import Mode
from repro_torch.dist.sharding import MeshInfo


@dataclass
class VectorTask:
    name: str
    fn: Callable[[MeshInfo], Any]  # queues its device work on the view's lanes


@dataclass
class ScalarTask:
    name: str
    fn: Callable[[], Any]


@dataclass
class TaskRecord:
    name: str
    kind: str  # 'vector' | 'scalar'
    lane: str  # which controller ran it
    start: float
    end: float
    result: Any = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class ScheduleReport:
    mode: Mode
    makespan: float
    records: list[TaskRecord] = field(default_factory=list)

    def lane_time(self, lane: str) -> float:
        recs = [r for r in self.records if r.lane == lane]
        if not recs:
            return 0.0
        return max(r.end for r in recs) - min(r.start for r in recs)

    def kind_time(self, kind: str) -> float:
        return sum(r.seconds for r in self.records if r.kind == kind)

    def summary(self) -> str:
        lines = [f"mode={self.mode} makespan={self.makespan:.4f}s"]
        for r in self.records:
            lines.append(
                f"  [{r.lane}] {r.kind:6s} {r.name:24s} {r.seconds:.4f}s"
            )
        return "\n".join(lines)


def _enter_streams(stack: contextlib.ExitStack, info: MeshInfo) -> None:
    """Make the view's first device current in this controller thread, and
    the view's first lane on each device the thread's current stream there,
    so work a task queues outside a lane stays on the view.

    ``torch.cuda.set_device`` binds PyTorch's CUDA context in the fresh
    thread: the kernel library carries its own CUDA runtime, whose launch
    fails (cudaErrorInvalidValue) in a thread where none is bound yet, as in
    a controller whose first CUDA work is a hand-written kernel on tensors
    from the caching allocator. Only this thread's current device changes."""
    first = info.mesh.lanes[0].device
    if first.type == "cuda":
        torch.cuda.set_device(first)
    seen = set()
    for lane in info.mesh.lanes:
        if lane.device not in seen:
            seen.add(lane.device)
            stack.enter_context(lane.use())


class MixedScheduler:
    """Runs mixed scalar/vector workloads under a given mode."""

    def __init__(self, cluster: SpatzformerCluster):
        self.cluster = cluster

    # ------------------------------------------------------------------ run

    def run(
        self,
        mode: Mode,
        vector_tasks: list[VectorTask],
        scalar_tasks: Optional[list[ScalarTask]] = None,
    ) -> ScheduleReport:
        scalar_tasks = scalar_tasks or []
        t0 = time.perf_counter()
        records: list[TaskRecord] = []
        errors: list[BaseException] = []
        lock = threading.Lock()

        def record(name, kind, lane, start, end, result):
            with lock:
                records.append(TaskRecord(name, kind, lane, start, end, result))

        def drain_vector(queue: list[VectorTask], info: MeshInfo, lane: str):
            try:
                with contextlib.ExitStack() as stack:
                    _enter_streams(stack, info)
                    for task in queue:
                        s = time.perf_counter()
                        res = task.fn(info)
                        info.mesh.synchronize()
                        record(task.name, "vector", lane, s, time.perf_counter(), res)
            except BaseException as e:  # re-raised by run() after the join
                with lock:
                    errors.append(e)

        def drain_scalar(queue: list[ScalarTask], lane: str):
            try:
                for task in queue:
                    s = time.perf_counter()
                    res = task.fn()
                    record(task.name, "scalar", lane, s, time.perf_counter(), res)
            except BaseException as e:
                with lock:
                    errors.append(e)

        if mode is Mode.MERGE:
            info = self.cluster.merge_info()
            threads = [
                threading.Thread(
                    target=drain_vector, args=(vector_tasks, info, "ctl0/merged")
                )
            ]
            # freed controllers take the scalar queue
            if scalar_tasks:
                threads.append(
                    threading.Thread(
                        target=drain_scalar, args=(scalar_tasks, "ctl1/freed")
                    )
                )
        else:  # SPLIT
            infos = self.cluster.split_infos()
            if scalar_tasks:
                # the split-mode penalty: controller-1 (and its vector unit)
                # is consumed by the scalar queue; all vector work on pod 0
                threads = [
                    threading.Thread(
                        target=drain_vector, args=(vector_tasks, infos[0], "ctl0/pod0")
                    ),
                    threading.Thread(
                        target=drain_scalar, args=(scalar_tasks, "ctl1/scalar")
                    ),
                ]
            else:
                # two-tenant mode: round-robin vector tasks across pods
                queues: list[list[VectorTask]] = [[] for _ in infos]
                for i, task in enumerate(vector_tasks):
                    queues[i % len(infos)].append(task)
                threads = [
                    threading.Thread(
                        target=drain_vector, args=(q, infos[i], f"ctl{i}/pod{i}")
                    )
                    for i, q in enumerate(queues)
                    if q
                ]

        for t in threads:
            t.start()
        for t in threads:
            t.join()
        makespan = time.perf_counter() - t0
        if errors:
            raise errors[0]
        records.sort(key=lambda r: r.start)
        return ScheduleReport(mode=mode, makespan=makespan, records=records)
