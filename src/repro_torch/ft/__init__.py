"""Fault tolerance: the heartbeat watchdog (armed by the serving cluster over
its split-mode controller threads and by the training launcher) and the
elastic training loop."""

from repro_torch.ft.elastic import ElasticReport, PodFailure, run_elastic
from repro_torch.ft.watchdog import LaneState, Watchdog

__all__ = ["ElasticReport", "LaneState", "PodFailure", "Watchdog", "run_elastic"]
