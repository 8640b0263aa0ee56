"""Input pipeline (counterpart of ``repro.data``): the synthetic corpus and
its restartable prefetch loader."""

from repro_torch.data.pipeline import DataConfig, PrefetchLoader, SyntheticCorpus, loader_for

__all__ = ["DataConfig", "SyntheticCorpus", "PrefetchLoader", "loader_for"]
