"""Launch helpers of the port: the mesh views of ``launch/mesh.py``, the
serving launcher ``launch/serve.py`` (``python -m repro_torch.launch.serve``)
and the training launcher ``launch/train.py`` (``python -m
repro_torch.launch.train``); ``make_production_mesh`` waits with
``launch/dryrun.py``."""

from repro_torch.launch.mesh import mesh_info_for, serving_mesh_infos

__all__ = ["mesh_info_for", "serving_mesh_infos"]
