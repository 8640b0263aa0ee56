"""SpatzformerCluster: the reconfigurable lane fabric (counterpart of
``repro/core/cluster.py``).

Owns the full ``(pod, data, model)`` grid of lanes and exposes per-mode
views:

* :meth:`merge_info`  — one :class:`MeshInfo` over the fused grid, with the
  ``pod`` axis folded into the batch axes (``batch_axes=('pod', 'data')``):
  merge mode, one controller, doubled vector length.
* :meth:`split_infos` — one :class:`MeshInfo` per pod, each a standalone
  ``(data, model)`` mesh over that pod's lanes: split mode, every pod an
  independent vector unit with its own controller.

A lane is a (device, stream) pair (:class:`repro_torch.dist.sharding.Lane`):
the device list may name one card more than once, so on one card a pod is a
set of streams sharing the card's SMs, not a slice of the chip. The same
object models the degraded fabric: losing a pod is "SPLIT with one tenant"
(``surviving_cluster(dead).pod_info(0)``), over the survivors' own lanes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.modes import Mode
from repro_torch.dist.sharding import Mesh, MeshInfo, lane_grid, lanes_for


def _auto_pod_shape(n: int) -> tuple[int, int]:
    """Factor a pod's lane count into (data, model) as square as possible."""
    best = (n, 1)
    for m in range(1, int(n**0.5) + 1):
        if n % m == 0:
            best = (n // m, m)
    return best


@dataclass
class SpatzformerCluster:
    """Reconfigurable multi-pod fabric.

    Args:
        n_pods: number of independent "vector units" (pods).
        pod_shape: per-pod (data, model) lane grid; inferred if None.
        devices: devices or lanes, one lane each (a device may repeat);
            defaults to every CUDA device.
    """

    n_pods: int = 2
    pod_shape: Optional[tuple[int, int]] = None
    devices: Optional[Sequence] = None

    def __post_init__(self) -> None:
        lanes = lanes_for(self.devices)
        if len(lanes) % self.n_pods:
            raise ValueError(f"{len(lanes)} devices not divisible into {self.n_pods} pods")
        per_pod = len(lanes) // self.n_pods
        if self.pod_shape is None:
            self.pod_shape = _auto_pod_shape(per_pod)
        d, m = self.pod_shape
        if d * m != per_pod:
            raise ValueError(f"pod_shape {self.pod_shape} != {per_pod} devices/pod")
        self._dev_grid = lane_grid(lanes, (self.n_pods, d, m))
        self._merged_mesh = Mesh(self._dev_grid, ("pod", "data", "model"))
        self._pod_meshes = [
            Mesh(self._dev_grid[i], ("data", "model")) for i in range(self.n_pods)
        ]
        self.mode: Mode = Mode.SPLIT

    # ------------------------------------------------------------------ views

    @property
    def n_devices(self) -> int:
        """The lanes of the fabric (JAX's name)."""
        return self._dev_grid.size

    @property
    def merged_mesh(self) -> Mesh:
        return self._merged_mesh

    def merge_info(self) -> MeshInfo:
        return MeshInfo(self._merged_mesh, batch_axes=("pod", "data"))

    def split_infos(self) -> list[MeshInfo]:
        return [MeshInfo(m, batch_axes=("data",)) for m in self._pod_meshes]

    def pod_info(self, pod: int) -> MeshInfo:
        return self.split_infos()[pod]

    def info_for(self, mode: Mode, pod: int = 0) -> MeshInfo:
        return self.merge_info() if mode is Mode.MERGE else self.pod_info(pod)

    # ------------------------------------------------------------------ mode

    def set_mode(self, mode: Mode) -> None:
        self.mode = mode

    def surviving_cluster(self, dead_pod: int) -> "SpatzformerCluster":
        """Elastic shrink: rebuild the fabric without one pod's lanes (the
        survivors keep their lanes, so their shards stay in place)."""
        keep = [i for i in range(self.n_pods) if i != dead_pod]
        lanes = list(self._dev_grid[keep].flat)
        return SpatzformerCluster(
            n_pods=len(keep), pod_shape=self.pod_shape, devices=lanes
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        d, m = self.pod_shape
        return (
            f"SpatzformerCluster(pods={self.n_pods}, pod=({d}x{m}), "
            f"devices={self.n_devices}, mode={self.mode})"
        )
