"""Runtime mode switching: remesh + reshard live state (counterpart of
``repro/core/reconfigure.py``; the paper's CSR write).

Switching SPLIT↔MERGE re-homes every live tensor onto the new view's lanes
through :func:`repro_torch.dist.sharding.device_put` with the target
shardings: a shard already on its target lane stays, any other block is
copied between lanes on their streams. The measured latency (read after
every lane's stream has finished) and the bytes of the live tree are the
port's reconfiguration cost. Shrinking onto the surviving pod after a
failure is the same reshard onto ``cluster.surviving_cluster(dead).pod_info(0)``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from repro_torch.common.utils import pytree_bytes
from repro_torch.core.cluster import SpatzformerCluster
from repro_torch.core.modes import Mode
from repro_torch.dist.sharding import MeshInfo, device_put, param_shardings


@dataclass
class SwitchReport:
    from_desc: str
    to_desc: str
    bytes_moved: int
    seconds: float

    @property
    def gbytes_per_sec(self) -> float:
        return self.bytes_moved / 1e9 / max(self.seconds, 1e-12)


def reshard(
    tree: Any,
    target_info: MeshInfo,
    sharding_fn: Callable[[Any, MeshInfo], Any] = param_shardings,
) -> Any:
    """Re-home a live tree (tensors or sharded values) onto a new view."""
    return device_put(tree, sharding_fn(tree, target_info))


def switch_mode(
    cluster: SpatzformerCluster,
    new_mode: Mode,
    live_state: Optional[Any] = None,
    *,
    pod: int = 0,
    sharding_fn: Callable[[Any, MeshInfo], Any] = param_shardings,
) -> tuple[Optional[Any], SwitchReport]:
    """Switch the cluster's mode, resharding ``live_state`` if given.

    Returns (resharded_state_or_None, SwitchReport); ``bytes_moved`` counts
    the whole live tree, as the JAX package's ``pytree_bytes`` does.
    """
    from_desc = f"{cluster.mode}"
    t0 = time.perf_counter()
    target = cluster.merge_info() if new_mode is Mode.MERGE else cluster.pod_info(pod)
    out = None
    moved = 0
    if live_state is not None:
        out = reshard(live_state, target, sharding_fn)
        cluster.merged_mesh.synchronize()
        moved = pytree_bytes(live_state)
    cluster.set_mode(new_mode)
    secs = time.perf_counter() - t0
    return out, SwitchReport(from_desc, str(new_mode), moved, secs)
