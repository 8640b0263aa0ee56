"""AdamW with decoupled weight decay and a warmup + cosine schedule
(counterpart of ``repro/train/optimizer.py``).

The state is ``AdamWState(step, mu, nu)``: an int32 step and f32 moments of
the params' tree structure, whatever the params' dtype. Where the JAX update
returns new params and moments (donating the old buffers), this one updates
params and moments IN PLACE under ``torch.no_grad`` and returns them; the
arithmetic is the JAX function's, op for op in f32. Leaves are visited in
the JAX package's order (``common.tree``), one leaf at a time, so the f32
temporaries are one leaf's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.common.tree import leaves, tree_map
from repro_torch.configs.base import TrainConfig
from repro_torch.dist.sharding import NamedSharding, P, ShardedTensor


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32
    mu: Any  # first moment (f32, like params)
    nu: Any  # second moment (f32)


def adamw_init(params: Any) -> AdamWState:
    """Zero moments in f32 beside each param leaf, step 0 on the first
    leaf's device. Params placed over lanes (sharded values) get moments
    on their blocks, each lane's made on its stream, and a step on every
    lane of the first leaf's mesh."""
    first = leaves(params)[0]

    def zeros(p, dtype=torch.float32, sharding=None):
        if not isinstance(p, ShardedTensor):
            return torch.zeros(p.shape, dtype=dtype, device=p.device)
        sharding = sharding or p.sharding
        shards = []
        for lane, block in zip(p.lanes, sharding.blocks(p.shape)):
            with lane.use():
                shards.append(torch.zeros([b - a for a, b in block], dtype=dtype,
                                          device=lane.device))
        return ShardedTensor(p.shape, dtype, sharding, shards)

    if isinstance(first, ShardedTensor):
        step = zeros(ShardedTensor((), first.dtype, first.sharding, first.shards),
                     torch.int32, NamedSharding(first.sharding.mesh, P()))
    else:
        step = torch.zeros((), dtype=torch.int32, device=first.device)
    return AdamWState(step=step, mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def warmup_cosine(cfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step -> learning rate (f32 tensor): linear warmup to ``lr`` over
    ``warmup_steps``, then a cosine from ``lr`` to ``lr * min_lr_ratio`` at
    ``total_steps``. Computed in f32 tensors in the JAX function's order
    (Python scalars rounded to f32 where they meet a tensor, as jnp's weak
    types are)."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = cfg.lr * step / max(cfg.warmup_steps, 1)
        prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)

    return schedule


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in JAX's order, of each leaf's f32 sum of
    squares."""
    total = 0
    for leaf in leaves(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float, norm: Optional[torch.Tensor] = None
                        ) -> tuple[Any, torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm) in f32 and rounded back to
    each leaf's dtype, the norm before clipping). ``norm`` given: the norm
    of a whole of which ``grads`` is a part (one lane's shards)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    cfg: TrainConfig,
    schedule: Callable[[torch.Tensor], torch.Tensor],
    gnorm: Optional[torch.Tensor] = None,
) -> tuple[Any, AdamWState, dict]:
    """One AdamW step: clip by the global norm, update the moments, then the
    params with bias correction and decoupled weight decay. Params, moments
    and step are updated in place; returns (params, state, {"grad_norm",
    "lr"}), the metrics as f32 tensors. ``gnorm``: the norm of the whole
    gradient where ``grads`` is one lane's shards of it (the lane train
    step), else the norm of ``grads``."""
    b1, b2 = cfg.betas
    state.step.add_(1)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, gnorm)
    lr = schedule(state.step)
    stepf = state.step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu),
                          strict=True):
        gf = g.float()
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(gf.square() * (1 - b2))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
