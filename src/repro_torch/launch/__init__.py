"""Launch helpers of the port: the mesh views of ``launch/mesh.py`` and the
serving launcher ``launch/serve.py`` (``python -m repro_torch.launch.serve``);
``make_production_mesh`` waits with ``launch/dryrun.py``."""

from repro_torch.launch.mesh import mesh_info_for, serving_mesh_infos

__all__ = ["mesh_info_for", "serving_mesh_infos"]
