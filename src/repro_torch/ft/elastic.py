"""Elastic training loop: pod failure -> shrink -> restore -> continue
(counterpart of ``repro/ft/elastic.py``).

Reuses the split/merge fabric: a dead pod turns the MERGE fabric into
"SPLIT with one tenant" on the survivors, whose lanes stay what they were
(``SpatzformerCluster.surviving_cluster``). The loop:

1. run steps on the full cluster's MERGE view,
2. on a :class:`PodFailure` (a watchdog callback, or injected by tests),
   rebuild the cluster without the dead pod,
3. restore the latest checkpoint onto the survivors' view
   (``Checkpointer.restore(shardings=...)``, the shardings from the same
   rules), or, before the first checkpoint, re-home the live state there
   (``core.reconfigure.reshard``),
4. rebuild the step function for the new view and go on from the restored
   step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core.cluster import SpatzformerCluster
from repro_torch.core.reconfigure import reshard
from repro_torch.dist.sharding import MeshInfo, param_shardings


class PodFailure(RuntimeError):
    def __init__(self, pod: int, msg: str = ""):
        super().__init__(msg or f"pod {pod} failed")
        self.pod = pod


@dataclass
class ElasticReport:
    steps_done: int
    failures: int
    final_devices: int
    restarts: list[tuple[int, int]]  # (step, surviving lanes)


def run_elastic(
    cluster: SpatzformerCluster,
    make_state: Callable[[MeshInfo], Any],
    step_fn_factory: Callable[[MeshInfo], Callable[[Any, dict, int], Any]],
    batches: Callable[[int], dict],
    ckpt: Checkpointer,
    total_steps: int,
    ckpt_every: int = 5,
    fail_at: Optional[dict[int, int]] = None,  # step -> pod to kill (tests)
) -> tuple[Any, ElasticReport]:
    """Generic elastic loop. ``step_fn_factory(info)`` returns ``(state,
    batch, step) -> state`` for the view ``info``; ``make_state(info)``
    builds the starting state on it (called once). The state is a tree of
    dicts, lists and NamedTuples (a training state ``(params, AdamWState)``)
    whose leaves have shapes; after a failure it comes back as sharded
    values on the survivors' view."""
    fail_at = dict(fail_at or {})
    info = cluster.merge_info()
    state = make_state(info)
    step_fn = step_fn_factory(info)
    restarts: list[tuple[int, int]] = []
    failures = 0

    step = 0
    while step < total_steps:
        try:
            if step in fail_at:
                raise PodFailure(fail_at.pop(step))
            state = step_fn(state, batches(step), step)
            step += 1
            if step % ckpt_every == 0:
                ckpt.save(step, state)
        except PodFailure as e:
            failures += 1
            ckpt.wait()  # the last async save is durable
            cluster = cluster.surviving_cluster(e.pod)
            # survivors form a single-tenant SPLIT fabric (or a smaller merge)
            info = cluster.merge_info() if cluster.n_pods > 1 else cluster.pod_info(0)
            if ckpt.latest_step() is not None:
                state, step = ckpt.restore(state, shardings=param_shardings(state, info))
            else:  # failed before the first checkpoint: re-home the live state
                state = reshard(state, info)
            step_fn = step_fn_factory(info)
            restarts.append((step, cluster.n_devices))

    ckpt.wait()
    return state, ElasticReport(steps_done=step, failures=failures,
                                final_devices=cluster.n_devices, restarts=restarts)
