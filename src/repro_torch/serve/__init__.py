"""Serving: the engine (the unified dispatch and the legacy prefill+insert
tier) and its request API, the seeded sampler zoo,
speculative decoding's drafters, the block-paged KV pool and the radix
prefix cache behind paged serving, the placement backends (a device, or
the lanes of a tensor-parallel merged engine), and the split/merge serving
cluster with its supervisor (reconfiguration,
admission, failure re-homing)."""

from repro_torch.serve.backend import DeviceBackend, PlacementBackend, ShardedBackend
from repro_torch.serve.cluster import (
    ClusterStats,
    NoModelReplica,
    ReconfigureReport,
    Router,
    SegmentStats,
    ServeCluster,
)
from repro_torch.serve.controller import (
    AdmissionController,
    AdmissionPolicy,
    ControllerConfig,
    FailurePolicy,
    ReconfigController,
    SwitchDecision,
    TenantPolicy,
    WindowSample,
    build_continuation,
    model_token_cost,
    plan_hetero_placement,
)
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
    "AdmissionController",
    "AdmissionPolicy",
    "AdmissionRejected",
    "BlockPool",
    "ClusterStats",
    "ControllerConfig",
    "DeviceBackend",
    "FailurePolicy",
    "ModelDrafter",
    "NGramDrafter",
    "NoModelReplica",
    "PlacementBackend",
    "PoolStats",
    "PrefixStats",
    "RadixPrefixCache",
    "ReconfigController",
    "ReconfigureReport",
    "Request",
    "RequestHandle",
    "Router",
    "SamplingParams",
    "SegmentStats",
    "ServeCluster",
    "ServeEngine",
    "ServeStats",
    "ShardedBackend",
    "SpeculateConfig",
    "SwitchDecision",
    "TenantPolicy",
    "WindowSample",
    "blocks_for",
    "build_continuation",
    "model_token_cost",
    "plan_hetero_placement",
]
