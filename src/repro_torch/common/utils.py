"""A copy of ``repro.common.utils.pytree_bytes`` for the port's parameter
and cache trees (nested dicts of tensors or of sharded values)."""

from __future__ import annotations

from typing import Any

import torch


def pytree_bytes(tree: Any) -> int:
    """Total bytes across all tensor leaves of a nested dict (or list); a
    sharded value (``dist.sharding.ShardedTensor``) counts its global
    shape once, as a JAX array does."""
    if isinstance(tree, dict):
        return sum(pytree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor) or hasattr(tree, "sharding"):
        return tree.numel() * tree.element_size()
    return 0
