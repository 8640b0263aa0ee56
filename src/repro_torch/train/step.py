"""Train-step factories (counterpart of ``repro/train/step.py``): the
step with microbatch gradient accumulation, on one lane or over a lane
mesh, and the compressed data-parallel step over lanes.

``make_train_step(model, tcfg, mesh_info=None)`` returns ``(params,
opt_state, batch) -> (params, opt_state, metrics)``; over a view of two or
more lanes it is :func:`make_lane_train_step`. Gradients come from ``torch.autograd`` over
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

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.common.tree import flatten_with_path, keystr, leaves, tree_map, unflatten
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import collectives
from repro_torch.dist import compression as comp
from repro_torch.dist.sharding import (
    DEFAULT_FSDP_THRESHOLD,
    MODEL_AXIS,
    Mesh,
    MeshInfo,
    NamedSharding,
    P,
    ShardedTensor,
    device_put,
    param_shardings,
    serve_param_shardings,
    serving_mesh_info,
)
from repro_torch.models.model import LM, check_tensor_parallel
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


def make_train_step(model: LM, tcfg: TrainConfig,
                    mesh_info: Optional[MeshInfo] = None) -> Callable:
    """The train step, with microbatch accumulation when ``tcfg.grad_accum >
    1``: on one lane, or over the lanes of ``mesh_info`` (default: the
    model's own view) where it has two or more (:func:`make_lane_train_step`).
    Metrics: loss, aux, grad_norm, lr (0-d f32 tensors on the params'
    device, the first lane's)."""
    info = model.mesh_info if mesh_info is None else mesh_info
    if info is not None and info.n_devices > 1:
        return make_lane_train_step(model, tcfg, info)
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
# the step over a lane mesh: what JAX's jit of make_train_step computes with
# param, opt and batch shardings over a (batch axes..., model) mesh
# ---------------------------------------------------------------------------


def _holders(x: ShardedTensor) -> list[list[int]]:
    """The lanes (flat indices, in order) that hold each distinct block of
    ``x``, blocks in the order of their first holder."""
    groups: dict = {}
    for i, block in enumerate(x.sharding.blocks(x.shape)):
        groups.setdefault(block, []).append(i)
    return list(groups.values())


def _row_batches(batch: dict, n_micro: int, n_rows: int) -> list[tuple[list[dict], bool]]:
    """The global batch as ([row] dicts, whole) a microbatch: microbatch i is rows
    i·B/n .. (i+1)·B/n of the batch, as JAX's reshape takes them, and row r
    of it its r-th block, as a batch sharding over the batch axes places
    it. A microbatch of m sequences over a multiple of m rows gives row r its
    sequence r % m (each sequence on n_rows / m rows, as GSPMD lays a
    batch sharded one a device out over a reshape into microbatches), any
    other that does not divide goes whole to each row (JAX then replicates
    the batch); either way every row weighs the same in the mean, and
    ``whole`` says that a row does not hold its own part (an MoE layer then
    routes each row alone)."""
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"global batch {b} does not split into {n_micro} microbatches")
    out = []
    for i in range(n_micro):
        mb = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:])[i] for k, v in batch.items()}
        m = b // n_micro
        if m < n_rows and n_rows % m == 0:
            out.append(([{k: v[r % m:r % m + 1] for k, v in mb.items()} for r in range(n_rows)],
                        True))
        elif m % n_rows:
            out.append(([mb] * n_rows, True))
        else:
            out.append(([{k: v.reshape(n_rows, m // n_rows, *v.shape[1:])[r]
                          for k, v in mb.items()} for r in range(n_rows)], False))
    return out


def lane_rows(info: MeshInfo) -> list[list]:
    """The lanes of a (batch axes..., model) view as data rows, in the batch
    spec's order (the row index is the batch axes' coordinates, major
    first), each row's lanes in ``model`` order; with TP off (``model`` a
    batch axis) one lane a row."""
    mesh = info.mesh
    rest = tuple(a for a in mesh.axis_names if a != info.model_axis)
    if rest != tuple(info.batch_axes):
        raise ValueError(f"a training view's axes other than {MODEL_AXIS!r} must be its batch "
                         f"axes in order: {mesh.axis_names} against {info.batch_axes}")
    grid = mesh.devices
    if info.model_axis is not None:
        grid = np.moveaxis(grid, mesh.axis_names.index(MODEL_AXIS), -1)
    return [list(r) for r in grid.reshape(-1, info.model_size)]


# ZeRO over the batch axes (``MeshInfo.zero``, TP off): the element counts
# from which a leaf's params (zero3) and its AdamW moments (zero1, zero3)
# are sharded, JAX's dry-run values (``param_shardings(fsdp=True)``)
ZERO_PARAM_THRESHOLD = DEFAULT_FSDP_THRESHOLD
ZERO_OPT_THRESHOLD = 2**22
ZERO_TP_REFUSED = "with tensor parallelism is not ported (ROADMAP Queue 1 item 12)"


def state_shardings(state: tuple, info: MeshInfo) -> tuple:
    """The lane train step's placement of a training state ``(params,
    AdamWState)`` over ``info``, by the view's strategy (``info.zero``):

    * ``"none"``: ``serve_param_shardings`` over the whole state (moments on
      their parameter's blocks);
    * ``"zero1"``: params replicated, each moment leaf of
      ``ZERO_OPT_THRESHOLD`` elements or more sharded over the batch axes
      (JAX's ``param_shardings(opt, fsdp=True, fsdp_threshold=2**22)``);
    * ``"zero3"``: also each param leaf of ``ZERO_PARAM_THRESHOLD`` or more
      (``param_shardings(params, fsdp=True)``).

    ZeRO with a ``model`` axis over two or more lanes raises
    ``NotImplementedError`` naming ROADMAP Queue 1 item 12."""
    if info.zero == "none":
        return serve_param_shardings(state, info)
    if info.model_size > 1:
        raise NotImplementedError(f"{info.zero} over {info.model_size} model lanes "
                                  f"{ZERO_TP_REFUSED}")
    params, opt = state
    p = (param_shardings(params, info, fsdp=True, fsdp_threshold=ZERO_PARAM_THRESHOLD)
         if info.zero == "zero3" else serve_param_shardings(params, info))
    return p, param_shardings(opt, info, fsdp=True, fsdp_threshold=ZERO_OPT_THRESHOLD)


def _sharded_dim(x: ShardedTensor) -> Optional[int]:
    """The dim a leaf placed at ZeRO's one sharded dim splits, else None."""
    return next((d for d, e in enumerate(x.sharding.spec) if e is not None), None)


def _gatherer(flat_paths: list, flat: list, lanes) -> tuple[dict, Optional[Callable]]:
    """(ZeRO-3's sharded leaves: ``keystr`` path -> (dim, dtype); the
    ``gather`` of ``LM.forward_rows``, None without such a leaf). A sharded
    leaf's blocks, one a lane in flat order, meet on every lane through
    ``lane_all_gather`` and are cast to the param's dtype there: the blocks
    autograd sees are f32, so the gather's backward sums the rows' grads in
    f32 in lane order, as the replicated step's ``reduce_grads`` does."""
    dims = {path: (_sharded_dim(x), x.dtype) for path, x in zip(flat_paths, flat)
            if _sharded_dim(x) is not None}

    def gather(name: str, blks: list) -> list:
        prefix, stacked = (keystr((name,)), 1) if name else ("", 0)  # a layer of [L, ...]
        rows = [leaves(b) for b in blks]
        out = [list(r) for r in rows]
        for j, (path, _) in enumerate(flatten_with_path(blks[0])):
            hit = dims.get(prefix + path)
            if hit is None:
                continue
            full = collectives.lane_all_gather([r[j] for r in rows], lanes, hit[0] - stacked)
            for r, lane in enumerate(lanes):
                with lane.use():
                    out[r][j] = full[r].to(hit[1])
        return [unflatten(b, o) for b, o in zip(blks, out)]

    return dims, (gather if dims else None)


def make_lane_train_step(model: LM, tcfg: TrainConfig, info: MeshInfo) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)`` over the
    lanes of ``info``, a (batch axes..., model) view such as
    ``SpatzformerCluster.merge_info()`` or ``pod_info(p)``: JAX's
    ``jax.jit(make_train_step(...), in_shardings=(p, o, b),
    out_shardings=(p, o, m))`` on the same mesh. ``model`` gives the config
    (a one-lane ``LM`` will do); a ``model`` axis over 1 takes the dense
    family without MLA, and any other raises ``NotImplementedError``
    naming ROADMAP Queue 1 item 10.

    The step owns the placement: ``params`` and ``opt_state`` come in on any
    placement (plain tensors on one device, a restored checkpoint's) and are
    placed by :func:`state_shardings` (the view's ``zero`` strategy picks
    the rule), unless they are the state this step returned last, which is
    updated in place and returned. ``batch`` is a dict of global tensors (the loader's) on
    any device. Each data row of the view (:func:`lane_rows`) takes its
    block of each microbatch: one lane a row runs :meth:`LM.forward_rows`
    side by side (an MoE layer routes the rows' tokens as one batch), a row
    of several lanes runs :meth:`LM.forward` on a merged view of its own
    (tensor-parallel). Backward gives each lane the grad of its own shards.
    Then, for each block of each leaf, the grads of the lanes that hold it
    (every row's, and every lane of a row for a leaf the placement
    replicated) are added in f32 in flat lane order on the first holder,
    divided by the rows (the mean over the global batch, as JAX takes it)
    and handed to each holder: the same bits on every replica. The grad
    norm counts each distinct block once, leaf by leaf in JAX's order, on
    the first lane, and every lane clips by it and runs AdamW on its
    shards, so the replicas stay equal bit for bit. The metrics are the
    rows' means on the first lane; the caller's stream waits for every
    lane.

    ZeRO (TP off, one lane a row): a lane updates the block of each param
    that its moment block covers; a param held whole beside a sharded
    moment (zero1) is then all-gathered over the lanes. A zero3 param leaf
    is a block a lane: each layer's blocks are gathered whole inside the
    rows' rematerialised block (``LM.forward_rows(gather=)``), the gather's
    backward sums the rows' grads onto the blocks in f32 in lane order, and
    the grad norm takes each such leaf whole on the first lane. So at
    ``grad_accum`` 1 both give the replicated step's bits; with
    microbatches zero3 sums the rows before the microbatches."""
    check_tensor_parallel(model.cfg, info.model_size, training=True)
    if info.zero != "none" and info.model_size > 1:
        raise NotImplementedError(f"{model.cfg.name}: {info.zero} over {info.model_size} model "
                                  f"lanes {ZERO_TP_REFUSED}")
    lanes = info.mesh.lanes
    index = {id(lane): i for i, lane in enumerate(lanes)}
    row_lanes = lane_rows(info)
    rows = [[index[id(lane)] for lane in row] for row in row_lanes]
    n_rows = len(rows)
    roots = [lanes[row[0]] for row in rows]
    row_models = ([LM(model.cfg, mesh_info=serving_mesh_info(r)) for r in row_lanes]
                  if info.model_size > 1 else [])
    root = lanes[0]
    schedule = warmup_cosine(tcfg)
    n_micro = max(tcfg.grad_accum, 1)
    coef = model.cfg.moe.aux_loss_coef if model.cfg.moe is not None else None

    def paths_of(params) -> list:
        return [path for path, _ in flatten_with_path(params)]
    last: list = [None, None]  # the state this step returned last
    zero3: list = [{}, None]  # the placed params' zero3 leaves and their gather

    def row_forward(params, src, batches, whole):
        """Each row's (logits, aux), reading the lanes' shards ``src``
        (``whole``: every row holds the whole microbatch)."""
        flat = leaves(params)
        if row_models:
            out = []
            for rm, row, mb in zip(row_models, rows, batches):
                rmesh = rm.mesh_info.mesh
                rp = unflatten(params, [
                    ShardedTensor(x.shape, x.dtype, NamedSharding(rmesh, x.sharding.spec),
                                  [s[i] for i in row]) for x, s in zip(flat, src)])
                out.append(rm.forward(rp, mb))
            return out
        return model.forward_rows([unflatten(params, [s[row[0]] for s in src]) for row in rows],
                                  batches, roots, whole=whole, gather=zero3[1])

    def micro_grads(params, batches, whole):
        """(each row's loss and aux, detached; each leaf's grads, one a
        lane) of one microbatch."""
        flat = leaves(params)
        src = []  # the leaves autograd differentiates: each lane's shard (zero3's in f32)
        for path, x in zip(paths_of(params), flat):
            src.append([])
            for t, lane in zip(x.shards, lanes):
                with lane.use():
                    t = t.detach().float() if path in zero3[0] else t.detach()
                    src[-1].append(t.requires_grad_(True))
        batches = [{k: v.to(lane.device, non_blocking=True) for k, v in mb.items()}
                   for mb, lane in zip(batches, roots)]
        _lanes_wait_for_caller(lanes)  # the copies above ran on the caller's streams
        losses, ms = [], []
        with torch.enable_grad():
            for (logits, aux), mb, lane in zip(row_forward(params, src, batches, whole), batches,
                                               roots):
                with lane.use():
                    loss = next_token_loss(logits, mb["labels"])
                    if coef is not None:
                        loss = loss + coef * aux
                losses.append(loss)
                ms.append((loss.detach(), aux.detach()))
            ones = []
            for loss, lane in zip(losses, roots):
                with lane.use():
                    ones.append(torch.ones_like(loss))
            grads = torch.autograd.grad(losses, [t for s in src for t in s], ones,
                                        allow_unused=True, materialize_grads=True)
        _lanes_wait_for_caller(lanes)
        it = iter(grads)
        return ms, [[next(it) for _ in s] for s in src]

    def train_step(params, opt_state: AdamWState, batch: dict):
        if params is not last[0] or opt_state is not last[1]:
            state = (params, opt_state)
            params, opt_state = device_put(state, state_shardings(state, info))
            if info.zero == "zero3":
                zero3[:] = _gatherer(paths_of(params), leaves(params), lanes)
        _lanes_wait_for_caller(lanes)
        flat = leaves(params)
        acc, ms = None, []
        for batches, whole in _row_batches(batch, n_micro, n_rows):
            m, g = micro_grads(params, batches, whole)
            ms.append(m)
            if n_micro == 1:
                acc = g
                continue
            if acc is None:
                acc = [[None] * len(gl) for gl in g]
            for al, gl in zip(acc, g):
                for i, lane in enumerate(lanes):
                    with lane.use():
                        part = gl[i].float() / n_micro
                        al[i] = part if al[i] is None else al[i] + part
        reduce_grads(flat, acc, lanes, n_rows)
        gathered = {j for j, path in enumerate(paths_of(params)) if path in zero3[0]}
        gnorm = lane_grad_norm(flat, acc, lanes, gathered)
        norms = collectives.lane_broadcast(gnorm, lanes)
        mus = leaves(opt_state.mu)
        # each lane's (param, grad) views over its moment block (the whole
        # shard unless ZeRO split the moments finer than the params)
        cover = [[_relative(mb, xb) for mb, xb in zip(m.sharding.blocks(m.shape),
                                                       x.sharding.blocks(x.shape))]
                 for x, m in zip(flat, mus)]
        opt_metrics = None
        for i, lane in enumerate(lanes):
            with lane.use():
                om = adamw_update(
                    unflatten(params, [gl[i][c[i]] for gl, c in zip(acc, cover)]),
                    AdamWState(opt_state.step.shards[i],
                               *(unflatten(t, [x.shards[i] for x in leaves(t)])
                                 for t in (opt_state.mu, opt_state.nu))),
                    unflatten(params, [x.shards[i][c[i]] for x, c in zip(flat, cover)]),
                    tcfg, schedule, gnorm=norms[i])[2]
            opt_metrics = om if opt_metrics is None else opt_metrics
        for x, m, c in zip(flat, mus, cover):  # zero1: every lane's replica made whole
            d = _sharded_dim(m)
            if d is not None and _sharded_dim(x) is None:
                whole_x = collectives.lane_gather([t[ci] for t, ci in zip(x.shards, c)], lanes, d)
                for lane, t, w in zip(lanes, x.shards, collectives.lane_broadcast(whole_x, lanes)):
                    with lane.use():
                        t.copy_(w)
        metrics = {}
        for j, k in enumerate(("loss", "aux")):
            per_row = []
            for r, lane in enumerate(roots):
                with lane.use():
                    per_row.append(torch.stack([m[r][j] for m in ms]).mean())
            total = collectives.lane_reduce(per_row, roots)
            with root.use():
                metrics[k] = total / n_rows
        metrics.update(opt_metrics)
        for lane in lanes:  # the caller's stream after every lane's work
            if lane.stream is not None:
                torch.cuda.current_stream(lane.device).wait_stream(lane.stream)
        last[:] = params, opt_state
        return params, opt_state, metrics

    return train_step


def reduce_grads(flat: list, grads: list, lanes, n_rows: int) -> None:
    """In place: for each block of each leaf of ``flat`` (sharded values),
    the grads of the lanes that hold it (``grads[leaf][lane]``) added in f32
    in flat lane order on the first holder, divided by ``n_rows`` (the mean
    over the data rows) and handed to every holder: one tensor, the same
    bits on each replica."""
    for x, gl in zip(flat, grads):
        for held in _holders(x):
            first = lanes[held[0]]
            with first.use():
                total = gl[held[0]].float()
                for i in held[1:]:
                    total = total + collectives._to_root(gl[i], lanes[i], first)
                if n_rows > 1:
                    total = total / n_rows
            for i, t in zip(held, collectives.lane_broadcast(total, [lanes[i] for i in held])):
                gl[i] = t


def lane_grad_norm(flat: list, grads: list, lanes, whole: frozenset = frozenset()
                   ) -> torch.Tensor:
    """The global norm of reduced grads on the first lane: each distinct
    block once, leaves in JAX's order, each block's sum of squares on its
    first holder; a leaf indexed in ``whole`` (ZeRO-3's one block a lane)
    gathered whole on the first lane first, so its sum is the replicated
    leaf's."""
    root = lanes[0]
    total = 0
    for j, (x, gl) in enumerate(zip(flat, grads)):
        if j in whole:
            held = [h[0] for h in _holders(x)]
            g = collectives.lane_gather([gl[i] for i in held], [lanes[i] for i in held],
                                        _sharded_dim(x))
            with root.use():
                total = total + g.float().square().sum()
            continue
        for held in _holders(x):
            with lanes[held[0]].use():
                sq = gl[held[0]].float().square().sum()
            sq = collectives._to_root(sq, lanes[held[0]], root)
            with root.use():
                total = total + sq
    with root.use():
        return torch.sqrt(total)


def _relative(block, origin) -> tuple[slice, ...]:
    """``block``'s slices inside ``origin``, a block that holds it."""
    return tuple(slice(a - o, b - o) for (a, b), (o, _) in zip(block, origin))


def _lanes_wait_for_caller(lanes) -> None:
    """Order each lane's later work after what the caller's stream has queued
    (the batch's copy, autograd's leaf grads)."""
    for lane in lanes:
        if lane.stream is not None:
            lane.stream.wait_stream(torch.cuda.current_stream(lane.device))


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
