"""Checkpointing (counterpart of ``repro.ckpt``): async save, atomic
rename, retention, and restore onto any sharding."""

from repro_torch.ckpt.checkpoint import Checkpointer, SaveHandle

__all__ = ["Checkpointer", "SaveHandle"]
