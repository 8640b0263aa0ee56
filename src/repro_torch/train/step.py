"""Train-step factories (counterpart of ``repro/train/step.py``): the
one-lane step with microbatch gradient accumulation, and the compressed
data-parallel step over lanes.

``make_train_step(model, tcfg)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``. Gradients come from ``torch.autograd`` over
``LM.forward``; params and the optimizer state are updated in place (the
JAX step donates them) and returned. With ``grad_accum > 1`` the global
batch is split along its first dim into microbatches, each one's grads
accumulated in f32 as ``g / n_micro``, one microbatch of activations alive
at a time; the metrics are the microbatches' means.

``make_compressed_dp_train_step(model, tcfg, mesh)`` is pure data
parallelism over the lanes of ``mesh``'s data axis: params, moments and the
error-feedback residual replicated on every lane (``ShardedTensor`` trees
at ``P()``), the batch split over the lanes. Each lane runs forward and
backward on its own stream, adds its residual, and the corrected grads meet
through the int8 ring (``dist.compression.allreduce_pytree_q8``) in place of
an exact all-reduce; then every lane applies AdamW to its own copy.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.common.tree import leaves, tree_map, unflatten
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import collectives
from repro_torch.dist import compression as comp
from repro_torch.dist.sharding import Mesh, NamedSharding, P, device_put
from repro_torch.models.model import LM
from repro_torch.train.loss import next_token_loss
from repro_torch.train.optimizer import AdamWState, adamw_update, warmup_cosine


def make_loss_fn(model: LM) -> Callable:
    """``(params, batch) -> (loss, {"loss", "aux"})``: next-token CE, plus the
    MoE aux loss times ``aux_loss_coef`` for an MoE model."""

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        loss = next_token_loss(logits, batch["labels"])
        if model.cfg.moe is not None:
            loss = loss + model.cfg.moe.aux_loss_coef * aux
        return loss, {"loss": loss, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn: Callable, params: Any, batch: dict) -> tuple[tuple, Any]:
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``, as
    ``jax.value_and_grad(has_aux=True)``: grads of each param leaf's shape
    and dtype (zeros where the loss does not reach a leaf). The params are
    read through detached views, so the caller's tensors are never marked
    as requiring grad."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(params, grads)


def make_train_step(model: LM, tcfg: TrainConfig) -> Callable:
    """The one-lane train step, with microbatch accumulation when
    ``tcfg.grad_accum > 1``. Metrics: loss, aux, grad_norm, lr (0-d f32
    tensors on the params' device)."""
    loss_fn = make_loss_fn(model)
    schedule = warmup_cosine(tcfg)
    n_micro = max(tcfg.grad_accum, 1)

    def train_step(params, opt_state: AdamWState, batch: dict):
        if n_micro == 1:
            (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"global batch {b} does not split into {n_micro} microbatches")
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            ms = []
            for i in range(n_micro):  # rows i*b/n .. (i+1)*b/n, as JAX's reshape
                mb = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:])[i]
                      for k, v in batch.items()}
                (_, m), g = value_and_grad(loss_fn, params, mb)
                for acc, gg in zip(leaves(grads), leaves(g)):
                    acc.add_(gg.float() / n_micro)
                ms.append(m)
                del g
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, tcfg,
                                                      schedule)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


# ---------------------------------------------------------------------------
# compressed-DP path: the gradient all-reduce is the int8 ring with error
# feedback, over the lanes of the data axis (params replicated, batch split)
# ---------------------------------------------------------------------------


def _lane(tree: Any, j: int) -> Any:
    """Lane j's tensors of a tree of sharded values."""
    return tree_map(lambda x: x.shards[j], tree)


def make_compressed_dp_train_step(model: LM, tcfg: TrainConfig, mesh: Mesh,
                                  data_axis: str = "data") -> Callable:
    """``(params, opt_state, ef_residual, batch) -> (params, opt_state,
    ef_residual, metrics)`` over the lanes of ``mesh`` (every lane on
    ``data_axis``, in its order: the ring). ``params``, ``opt_state`` and
    ``ef_residual`` (f32, params' shapes) are trees of sharded values
    replicated at ``P()``, updated in place; ``batch`` is a dict of arrays,
    tensors or sharded values whose first dim is split over the lanes. The
    metrics (loss, aux, grad_norm, lr: each lane's, averaged) are 0-d
    tensors on the first lane, and the caller's stream waits for every lane
    before the step returns."""
    if mesh.shape.get(data_axis) != mesh.size:
        raise ValueError(f"every lane of the mesh {mesh.shape} must lie on {data_axis!r}")
    lanes = mesh.lanes
    loss_fn = make_loss_fn(model)
    schedule = warmup_cosine(tcfg)
    batch_sharding = NamedSharding(mesh, P(data_axis))

    def train_step(params, opt_state: AdamWState, ef_residual, batch: dict):
        batch = {k: device_put(v, batch_sharding) for k, v in batch.items()}
        corrected, metrics = [], []
        for j, lane in enumerate(lanes):
            with lane.use():
                (_, m), g = value_and_grad(loss_fn, _lane(params, j), _lane(batch, j))
                corrected.append(tree_map(lambda gg, e: gg.float() + e, g,
                                          _lane(ef_residual, j)))
                metrics.append(m)
        reduced = comp.allreduce_pytree_q8(corrected, lanes)
        for j, lane in enumerate(lanes):
            with lane.use():
                for e, c, r in zip(leaves(_lane(ef_residual, j)), leaves(corrected[j]),
                                   leaves(reduced[j])):
                    e.copy_(c - r)
                _, _, om = adamw_update(reduced[j], _lane(opt_state, j), _lane(params, j),
                                        tcfg, schedule)
                metrics[j].update(om)
        root = lanes[0]
        out = {}
        for k in metrics[0]:
            total = collectives.lane_reduce([m[k] for m in metrics], lanes)
            with root.use():
                out[k] = total / len(lanes)
        for lane in lanes:  # the caller's stream after every lane's work
            if lane.stream is not None:
                torch.cuda.current_stream(lane.device).wait_stream(lane.stream)
        return params, opt_state, ef_residual, out

    return train_step
