"""A copy of ``repro.common.utils.pytree_bytes`` for the port's parameter
and cache trees (nested dicts of tensors)."""

from __future__ import annotations

from typing import Any

import torch


def pytree_bytes(tree: Any) -> int:
    """Total bytes across all tensor leaves of a nested dict (or list)."""
    if isinstance(tree, dict):
        return sum(pytree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
