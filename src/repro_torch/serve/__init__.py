"""Serving: the unified engine and its request API, the seeded sampler zoo,
speculative decoding's drafters, the block-paged KV pool and the radix
prefix cache behind paged serving."""

from repro_torch.serve.engine import (
    AdmissionRejected,
    Request,
    RequestHandle,
    ServeEngine,
    ServeStats,
)
from repro_torch.serve.kv_pool import BlockPool, PoolStats, blocks_for
from repro_torch.serve.prefix_cache import PrefixStats, RadixPrefixCache
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.speculate import ModelDrafter, NGramDrafter, SpeculateConfig

__all__ = [
    "AdmissionRejected",
    "BlockPool",
    "ModelDrafter",
    "NGramDrafter",
    "PoolStats",
    "PrefixStats",
    "RadixPrefixCache",
    "Request",
    "RequestHandle",
    "SamplingParams",
    "ServeEngine",
    "ServeStats",
    "SpeculateConfig",
    "blocks_for",
]
