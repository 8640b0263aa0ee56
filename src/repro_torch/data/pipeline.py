"""Synthetic token pipeline with host-side prefetch (counterpart of
``repro/data/pipeline.py``).

Every batch is a pure function of (config, step), so a restarted run picks
up exactly where it stopped: the loader's state is one integer. A
background thread keeps ``prefetch`` batches ready; in MERGE mode that
thread is one of the scalar tasks on the freed controller (the paper's
mixed-workload story applied to the input pipeline).

The corpus is a copy of the JAX package's numpy code (the port imports
nothing of ``repro``): zipfian token marginals, and structured spans (a
seeded pattern repeated along each row, 10% noise) so the loss is
learnable. Its batches are bitwise the JAX package's. The loader hands them
out as torch tensors on the caller's device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pattern_period: int = 16  # learnable structure period


class SyntheticCorpus:
    """Deterministic batches: batch(step) is a pure function of (cfg, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # zipfian-ish marginal over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._probs = probs / probs.sum()

    def batch(self, step: int) -> dict:
        """{'tokens', 'labels'}: [global_batch, seq_len] int32 numpy arrays."""
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        b, s = cfg.global_batch, cfg.seq_len
        # learnable periodic structure: a seeded pattern repeated along the row
        pat_len = cfg.pattern_period
        patterns = rng.choice(cfg.vocab_size, size=(b, pat_len), p=self._probs)
        reps = int(np.ceil(s / pat_len))
        tokens = np.tile(patterns, (1, reps))[:, :s]
        # sprinkle noise so it's not trivially memorizable
        noise_mask = rng.random((b, s)) < 0.1
        noise = rng.choice(cfg.vocab_size, size=(b, s), p=self._probs)
        tokens = np.where(noise_mask, noise, tokens).astype(np.int32)
        return {"tokens": tokens, "labels": tokens.copy()}


class PrefetchLoader:
    """Background-thread prefetcher over a :class:`SyntheticCorpus`, handing
    out each batch as int32 torch tensors on ``device`` (default: the
    current CUDA device; a CPU device only when asked).

    Restartable: ``PrefetchLoader(corpus, start_step=k)`` resumes exactly
    where a checkpointed run left off. ``close`` stops and joins the thread.
    """

    def __init__(self, corpus: SyntheticCorpus, start_step: int = 0, prefetch: int = 2,
                 device=None):
        self.corpus = corpus
        self.step = start_step
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self.corpus.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self.step = step + 1
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        return self

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def loader_for(arch: ArchConfig, shape: ShapeConfig, seed: int = 0, device=None
               ) -> PrefetchLoader:
    return PrefetchLoader(
        SyntheticCorpus(DataConfig(vocab_size=arch.vocab_size, seq_len=shape.seq_len,
                                   global_batch=shape.global_batch, seed=seed)),
        device=device,
    )
