"""Request-level sampling configuration and the greedy device sampler
(counterpart of ``repro/serve/sampling.py``).

:class:`SamplingParams` is the JAX package's record, unchanged, so a request
means the same thing to both engines. Only the greedy variant (``smode``
0) of the fused sampler is ported; the engine refuses other modes at submit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch

# sampler dispatch variants, as in the JAX package
SMODE_GREEDY, SMODE_GUMBEL, SMODE_MASKED = 0, 1, 2

MAX_LOGIT_BIAS = 8


@dataclass(frozen=True)
class SamplingParams:
    """Frozen per-request sampling/termination configuration.

    ``temperature <= 0`` means greedy (argmax). ``top_k=0`` and
    ``top_p=1.0`` disable their masks. ``stop`` token ids terminate the
    stream (the stop token itself is emitted). ``logit_bias`` is up to
    ``MAX_LOGIT_BIAS`` ``(token_id, bias)`` pairs."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    max_new: int = 16
    stop: tuple[int, ...] = ()
    logit_bias: tuple[tuple[int, float], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "stop", tuple(int(t) for t in self.stop))
        lb = self.logit_bias
        if isinstance(lb, Mapping):
            lb = tuple(lb.items())
        object.__setattr__(self, "logit_bias", tuple((int(t), float(v)) for t, v in lb))
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.seed is not None and not -(2**31) <= self.seed < 2**31:
            raise ValueError(f"seed must fit int32, got {self.seed}")
        if len(self.logit_bias) > MAX_LOGIT_BIAS:
            raise ValueError(
                f"at most {MAX_LOGIT_BIAS} logit_bias entries, got {len(self.logit_bias)}"
            )

    @property
    def smode(self) -> int:
        """The narrowest sampler variant this request needs."""
        if self.temperature <= 0 and not self.logit_bias:
            return SMODE_GREEDY
        if self.top_k == 0 and self.top_p >= 1.0 and not self.logit_bias:
            return SMODE_GUMBEL
        return SMODE_MASKED


def fused_sample(logits: torch.Tensor, *, smode: int = SMODE_GREEDY) -> torch.Tensor:
    """One sampling decision per row of ``logits`` [B, V], on the logits'
    device: argmax in f32, first index on ties, as int32. Only smode 0."""
    if smode != SMODE_GREEDY:
        raise NotImplementedError("only greedy sampling (smode 0) is ported")
    return logits.float().argmax(dim=-1).to(torch.int32)
