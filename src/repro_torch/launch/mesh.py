"""Mesh views for a launch (counterpart of ``repro/launch/mesh.py``) over
lane meshes. ``make_production_mesh`` (the 256/512-device dry-run mesh) is
not ported."""

from __future__ import annotations

from repro_torch.core.modes import Mode
from repro_torch.dist.sharding import Mesh, MeshInfo, lanes_for, serving_mesh_info


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
