"""Helpers shared across the port (counterparts of ``repro.common``)."""

from repro_torch.common.utils import pytree_bytes

__all__ = ["pytree_bytes"]
