"""Helpers shared across the port (counterparts of ``repro.common``)."""

from repro_torch.common.utils import (
    Timer,
    human_bytes,
    human_flops,
    human_num,
    pytree_bytes,
    pytree_num_params,
    tree_struct_str,
)

__all__ = [
    "Timer",
    "human_bytes",
    "human_flops",
    "human_num",
    "pytree_bytes",
    "pytree_num_params",
    "tree_struct_str",
]
