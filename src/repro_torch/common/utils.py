"""Small shared utilities (counterpart of ``repro/common/utils.py``):
timing, humanized units and tree accounting over the port's trees (nested
dicts, lists and NamedTuples of tensors, sharded values or anything with a
``shape``), walked by :mod:`repro_torch.common.tree` in JAX's order."""

from __future__ import annotations

import math
import time
from typing import Any

import torch

from repro_torch.common.tree import flatten_with_path, leaves


class Timer:
    """Wall-clock timer usable as a context manager.

    >>> with Timer() as t:
    ...     work()
    >>> t.elapsed  # seconds
    """

    def __init__(self) -> None:
        self.elapsed = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed = time.perf_counter() - self._t0


def _humanize(x: float, units: list[str], base: float = 1000.0) -> str:
    for unit in units:
        if abs(x) < base:
            return f"{x:.3g}{unit}"
        x /= base
    return f"{x:.3g}{units[-1]}"


def human_num(x: float) -> str:
    return _humanize(float(x), ["", "K", "M", "B", "T", "P"])


def human_bytes(x: float) -> str:
    return _humanize(float(x), ["B", "KiB", "MiB", "GiB", "TiB", "PiB"], base=1024.0)


def human_flops(x: float) -> str:
    return _humanize(float(x), ["F", "KF", "MF", "GF", "TF", "PF", "EF"])


def pytree_num_params(tree: Any) -> int:
    """Total number of elements across all leaves (meta tensors too)."""
    return sum(math.prod(leaf.shape) for leaf in leaves(tree))


def pytree_bytes(tree: Any) -> int:
    """Total bytes across all tensor leaves; a sharded value
    (``dist.sharding.ShardedTensor``) counts its global shape once, as a
    JAX array does."""
    return sum(leaf.numel() * leaf.element_size() for leaf in leaves(tree)
               if isinstance(leaf, torch.Tensor) or hasattr(leaf, "sharding"))


def tree_struct_str(tree: Any, max_leaves: int = 40) -> str:
    """Debug rendering of a tree's leaf shapes and dtypes."""
    flat = flatten_with_path(tree)
    lines = [f"  {name}: {tuple(leaf.shape)} {leaf.dtype}" for name, leaf in flat[:max_leaves]]
    if len(flat) > max_leaves:
        lines.append(f"  ... ({len(flat) - max_leaves} more leaves)")
    return "\n".join(lines)


def now_ms() -> float:
    return time.perf_counter() * 1e3
