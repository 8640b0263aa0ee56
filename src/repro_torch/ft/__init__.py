"""Fault tolerance: the heartbeat watchdog the serving cluster arms over its
split-mode controller threads (``elastic`` is not ported)."""

from repro_torch.ft.watchdog import LaneState, Watchdog

__all__ = ["LaneState", "Watchdog"]
