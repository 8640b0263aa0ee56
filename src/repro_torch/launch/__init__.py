"""Launch helpers of the port: the mesh views of ``launch/mesh.py`` (and the
dry run's production mesh of placeholder lanes), the serving launcher
``launch/serve.py`` (``python -m repro_torch.launch.serve``), the training
launcher ``launch/train.py`` (``python -m repro_torch.launch.train``) and the
production dry run ``launch/dryrun.py`` (``python -m
repro_torch.launch.dryrun``)."""

from repro_torch.launch.mesh import make_production_mesh, mesh_info_for, serving_mesh_infos

__all__ = ["make_production_mesh", "mesh_info_for", "serving_mesh_infos"]
