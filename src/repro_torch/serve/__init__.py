"""Serving: the unified engine and its request API."""

from repro_torch.serve.engine import Request, RequestHandle, ServeEngine, ServeStats
from repro_torch.serve.sampling import SamplingParams

__all__ = ["Request", "RequestHandle", "SamplingParams", "ServeEngine", "ServeStats"]
