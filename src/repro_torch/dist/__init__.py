"""Distribution layer of the port: lane meshes, rule-based shardings, ring
collective matmuls, the int8 gradient ring (``compression.ring_allreduce_q8``
over lanes) and the row quantizer of the quantized KV cache.

This is the substrate the split/merge fabric is built on:
:class:`repro_torch.dist.sharding.MeshInfo` is the per-mode view object that
``SpatzformerCluster.merge_info()`` / ``split_infos()`` hand out, and
reshard-on-mode-switch is :func:`~repro_torch.dist.sharding.device_put` onto
shardings produced by the rules here.
"""

from repro_torch.dist import collectives, compression, sharding
from repro_torch.dist.sharding import (
    Lane,
    Mesh,
    MeshInfo,
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    batch_shardings,
    device_put,
    gather,
    opt_shardings,
    param_shardings,
    replicated,
    single_device_mesh_info,
    spec_for_param,
)

__all__ = [
    "Lane",
    "Mesh",
    "MeshInfo",
    "NamedSharding",
    "PartitionSpec",
    "ShardedTensor",
    "batch_shardings",
    "collectives",
    "compression",
    "device_put",
    "gather",
    "opt_shardings",
    "param_shardings",
    "replicated",
    "sharding",
    "single_device_mesh_info",
    "spec_for_param",
]
