"""Mesh views for a launch (counterpart of ``repro/launch/mesh.py``) over
lane meshes, and the dry run's production mesh of placeholder lanes.

``make_production_mesh`` is a FUNCTION (not a module-level constant), so
importing this module makes no lane."""

from __future__ import annotations

import math

from repro_torch.core.modes import Mode
from repro_torch.dist.sharding import Mesh, MeshInfo, lane_grid, lanes_for, serving_mesh_info


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh of JAX's dry run: 256 lanes over ("data",
    "model") 16 x 16, or 512 over ("pod", "data", "model") 2 x 16 x 16.
    Each lane is a placeholder of its own on ``meta`` (no stream, no data;
    data crossing to it is a copy, as to another card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(lane_grid(lanes_for(["meta"] * math.prod(shape)), shape), axes)


def mesh_info_for(mesh: Mesh) -> MeshInfo:
    """Axis roles for a mesh (pod folds into the batch axes — MERGE-mode
    semantics; SPLIT tenants use SpatzformerCluster.pod_info)."""
    if "pod" in mesh.axis_names:
        return MeshInfo(mesh, batch_axes=("pod", "data"))
    return MeshInfo(mesh, batch_axes=("data",))


def serving_mesh_infos(mode: Mode | str, devices=None) -> list[MeshInfo]:
    """Map SPLIT/MERGE onto the serving fabric: SPLIT is one degenerate
    ``(data=1, model=1)`` view per lane (an independent engine replica),
    MERGE one fused ``(data=1, model=N)`` view over every lane. ``devices``:
    devices or lanes, one lane each (default: every CUDA device)."""
    lanes = lanes_for(devices)
    if Mode.parse(mode) is Mode.MERGE:
        return [serving_mesh_info(lanes)]
    return [serving_mesh_info([lane]) for lane in lanes]
