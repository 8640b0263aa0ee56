"""Production dry run over placeholder lanes (counterpart of
``repro/launch/dryrun.py``).

For every live cell (``configs.all_cells``) on the single-pod (16, 16) and
multi-pod (2, 16, 16) production meshes (``launch.mesh.make_production_mesh``:
one placeholder lane on ``meta`` a card, no data, no card needed) this
script runs the port's own step for the cell's kind over the lanes:

* ``train``: ``train.make_train_step`` over the view (the lane step, which
  owns the placement: ``train.step.state_shardings``);
* ``prefill``: ``LM.forward`` under ``torch.no_grad()`` on each data row
  (a merged ``LM`` over the row's lanes);
* ``decode``: ``LM.decode_step`` on each row, its cache placed by
  ``serve_cache_shardings`` over the row, ``cur_len`` at ``seq_len - 1``;

with JAX's memory policies (grad-accum sizing, ZeRO-1 / ZeRO-3 with TP
off, FSDP where a lane's state would pass 8e9 bytes, an f8 KV cache over
4 GB a lane, ``attn_chunk=256`` at ``d_model >= 8192``), and records what
JAX records where the quantity is the same: each lane's memory (the
largest lane's), the analytic roofline (``roofline/``) at the H100's
published peaks, and ``ok`` / ``error``. In place of XLA's numbers it
records ``trace_s`` (JAX: ``lower_s`` and ``compile_s``), ``counted_flops``
(by ``FlopCounterMode``'s formulas, over the whole mesh) and ``collectives`` (the lane
collectives' result bytes by kind on the busiest lane,
``dist.collectives.counting``).

Memory per lane: argument bytes are each lane's shards (and its block of
the batch, as ``batch_shardings`` places it); temp and peak come from a
``TorchDispatchMode`` that charges every tensor made during the step to the
lane whose ``Lane.use()`` encloses it (or, in autograd's backward, to the
lane that holds the op's inputs) and frees it through a weakref finalizer.
Bytes that no lane claims are recorded (``mem.unclaimed_bytes``).

Two shortcuts keep the sweep short, both exact because the work depends on
shapes only: the data rows of a prefill or decode cell are one program on
the same shapes, so row 0 is traced and the others take its lanes' records
(its FLOPs times the rows); and the cores whose Python loops dominate a
trace (the attention cores, the selective scan, the SSD) are measured once
a set of shapes in a probe and replayed at every call — FLOPs, the peak
above the bytes live at the call, the outputs, and under autograd the
bytes kept for the backward and the backward's own costs.

Usage::

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    python -m repro_torch.launch.dryrun --arch zamba2-2.7b --shape train_4k --mesh single
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.common.tree import leaves, tree_map
from repro_torch.configs import TrainConfig, all_cells, get_arch, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist import collectives
from repro_torch.dist.sharding import (
    Mesh,
    MeshInfo,
    NamedSharding,
    ShardedTensor,
    batch_shardings,
    current_lane,
    device_put,
    lane_scope,
    serve_param_shardings,
    serving_mesh_info,
)
from repro_torch.launch.mesh import make_production_mesh, mesh_info_for
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.model import LM, check_tensor_parallel, input_specs
from repro_torch.roofline.analysis import RooflineTerms
from repro_torch.roofline.flops import count_cell
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import ZERO_TP_REFUSED, lane_rows, make_train_step, state_shardings

DEFAULT_OUT = "build/dryrun_torch.jsonl"


# =============================================================================
# memory per lane
# =============================================================================


class LaneMemory(TorchDispatchMode):
    """Live and peak bytes per lane of the tensors made while it is active,
    and the FLOPs of the ops it sees by ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``; ``FlopCounterMode`` itself
    would also decompose every other op in Python, several times the cost
    of a meta op).
    A new storage is charged to :func:`current_lane`, else to the lane that
    holds one of the op's inputs (autograd's backward runs outside any
    ``Lane.use()``), else, for an op with no tensor input (a constant of a
    backward formula), to the lane of the thread's previous op, else to no
    lane (key None), and uncharged when it is freed. :meth:`argument`
    registers the step's inputs, which are counted apart."""

    def __init__(self) -> None:
        super().__init__()
        self.owner: dict[int, Any] = {}  # storage -> its lane (None: no lane)
        self.args: dict[Any, int] = {}
        self.live: dict[Any, int] = {None: 0}
        self.peak: dict[Any, int] = {None: 0}
        self.window: dict[Any, int] = {}  # lane -> peak live since open_window
        self.flops = 0
        self._recent = threading.local()  # .lane: the lane of the thread's last charge

    def argument(self, t: torch.Tensor, lane, counted: bool = True) -> None:
        """``t``, an input of the step, held by ``lane``; its bytes go to
        the lane's argument bytes unless ``counted`` is False (the global
        batch, whose lanes' blocks are counted apart)."""
        st = t.untyped_storage()
        if st._cdata not in self.owner:
            self.owner[st._cdata] = lane
            if counted:
                self.args[lane] = self.args.get(lane, 0) + st.nbytes()

    def _lane_of_inputs(self, args, kwargs):
        tensors = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        for a in tensors:
            lane = self.owner.get(a.untyped_storage()._cdata)
            if lane is not None:
                return lane
        return None if tensors else getattr(self._recent, "lane", None)

    def _free(self, key: int, lane, nbytes: int) -> None:
        self.owner.pop(key, None)
        self.live[lane] -= nbytes

    def charge(self, lane, nbytes: int) -> None:
        """``nbytes`` more live on ``lane`` (peaks follow)."""
        live = self.live.get(lane, 0) + nbytes
        self.live[lane] = live
        if live > self.peak.get(lane, 0):
            self.peak[lane] = live
        if lane in self.window and live > self.window[lane]:
            self.window[lane] = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        lane = None
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.owner:
                continue
            if lane is None:
                lane = current_lane() or self._lane_of_inputs(args, kwargs)
                self._recent.lane = lane
            nbytes = st.nbytes()
            self.owner[key] = lane
            self.charge(lane, nbytes)
            weakref.finalize(st, self._free, key, lane, nbytes)
        return out

    @contextlib.contextmanager
    def open_window(self, lane):
        """Yields a dict whose ``"rise"`` is, on exit, the peak over the
        enclosed work of ``lane``'s live bytes above those live on entry."""
        live0 = self.live.get(lane, 0)
        prev = self.window.get(lane)
        self.window[lane] = live0
        got: dict = {}
        try:
            yield got
        finally:
            got["rise"] = self.window[lane] - live0
            if prev is None:
                del self.window[lane]
            else:
                self.window[lane] = max(prev, self.window[lane])


@dataclasses.dataclass(frozen=True)
class _TensorSpec:
    """A core's tensor argument, as the probe needs it (no reference kept)."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device
    requires_grad: bool


@dataclasses.dataclass
class _Cost:
    """One call of a core at one set of shapes, measured once: its forward's
    peak above the live bytes at its start and its FLOPs, the bytes it
    keeps for its backward, its outputs' shapes; and its backward's peak
    and FLOPs, by which outputs receive a grad."""

    fwd_rise: int
    fwd_flops: int
    saved: int
    outs: list  # [(shape, dtype)]
    single: bool  # one tensor out, not a tuple
    bwd: dict = dataclasses.field(default_factory=dict)  # grads' pattern -> (rise, flops)


class _ReplayFn(torch.autograd.Function):
    """A core's call replayed under autograd: its forward's costs and outputs,
    its inputs and a blob of the bytes it saves kept for the backward
    (``save_for_backward``, so an enclosing checkpoint drops and recomputes
    them as it would the core's own), then its backward's costs and the
    inputs' grads."""

    @staticmethod
    def forward(ctx, rep, call, lane, *tensors):
        ctx.set_materialize_grads(False)
        ctx.rep, ctx.call, ctx.lane = rep, call, lane
        ctx.ins = [(t.shape, t.dtype, t.requires_grad) for t in tensors]
        dev = tensors[0].device
        cost = rep.memo[call[0]]
        outs = rep.run(cost, lane, dev)
        with lane_scope(lane):  # the core's backward reads its inputs too
            ctx.save_for_backward(torch.empty(cost.saved, dtype=torch.uint8, device=dev),
                                  *tensors)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors  # noqa: B018  (an enclosing checkpoint recomputes here)
        pattern = tuple(g is not None for g in grads)
        if not any(pattern):
            return (None, None, None, *[None] * len(ctx.ins))
        rise, flops = ctx.rep.backward_cost(ctx.call, pattern)
        mem, lane = ctx.rep.mem, ctx.lane
        mem.charge(lane, rise)
        mem.charge(lane, -rise)
        mem.flops += flops
        dev = next(g for g in grads if g is not None).device
        with lane_scope(lane):
            gs = [torch.empty(shape, dtype=dt, device=dev) if rg else None
                  for shape, dt, rg in ctx.ins]
        return (None, None, None, *gs)


class _Replay:
    """``fn``, a core whose cost depends on shapes only (the attention cores,
    the selective scan, the SSD), measured once a set of shapes in a probe
    charged to no lane (:class:`_Cost`) and replayed at every call: the
    FLOPs, the peak rise on the caller's lane and the outputs, and under
    autograd the saved bytes and the backward's (:class:`_ReplayFn`)."""

    def __init__(self, fn: Callable, mem: LaneMemory) -> None:
        self.fn, self.mem = fn, mem
        self.memo: dict = {}

    def run(self, cost: _Cost, lane, device) -> list:
        """The forward's costs on ``lane``, and its outputs allocated there."""
        self.mem.charge(lane, cost.fwd_rise)
        self.mem.charge(lane, -cost.fwd_rise)
        self.mem.flops += cost.fwd_flops
        with lane_scope(lane):
            return [torch.empty(shape, dtype=dt, device=device) for shape, dt in cost.outs]

    @contextlib.contextmanager
    def _probe(self, spec: tuple, grad: bool):
        """Stand-in inputs of ``spec`` (a tensor's as ``_TensorSpec``) for a
        run of the core charged to no lane of the mesh, its FLOPs taken back
        after; yields (the probe's lane key, the inputs)."""
        mem, probe = self.mem, object()
        flops0 = mem.flops
        # its own saved tensors kept as they are (not an enclosing checkpoint's to drop)
        with lane_scope(probe), torch.set_grad_enabled(grad), \
                torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
            ins = [torch.empty(a.shape, dtype=a.dtype, device=a.device).requires_grad_(
                grad and a.requires_grad) if isinstance(a, _TensorSpec) else a for a in spec]
            yield probe, ins
        mem.flops = flops0

    def forward_cost(self, spec: tuple, kwargs: dict, grad: bool) -> _Cost:
        mem = self.mem
        with self._probe(spec, grad) as (probe, ins):
            live0, flops0 = mem.live.get(probe, 0), mem.flops
            with mem.open_window(probe) as win:
                out = self.fn(*ins, **kwargs)
            outs = [out] if isinstance(out, torch.Tensor) else list(out)
            kept = mem.live.get(probe, 0) - live0
            cost = _Cost(win["rise"], mem.flops - flops0,
                         kept - sum(o.untyped_storage().nbytes() for o in outs) if grad else 0,
                         [(tuple(o.shape), o.dtype) for o in outs],
                         isinstance(out, torch.Tensor))
        return cost

    def backward_cost(self, call: tuple, pattern: tuple) -> tuple[int, int]:
        """(peak rise, FLOPs) of the backward of ``call`` = (key, spec,
        kwargs) whose outputs in ``pattern`` receive a grad."""
        key, spec, kwargs = call
        cost = self.memo[key]
        if pattern not in cost.bwd:
            mem = self.mem
            with self._probe(spec, True) as (probe, ins):
                out = self.fn(*ins, **kwargs)
                outs = [out] if isinstance(out, torch.Tensor) else list(out)
                tails = [o for o, p in zip(outs, pattern) if p]
                seeds = [torch.ones_like(o) for o in tails]
                leaves = [t for t in ins if isinstance(t, torch.Tensor) and t.requires_grad]
                flops0 = mem.flops
                with mem.open_window(probe) as win:
                    torch.autograd.grad(tails, leaves, seeds, allow_unused=True)
                cost.bwd[pattern] = (win["rise"], mem.flops - flops0)
        return cost.bwd[pattern]

    def __call__(self, *args, **kwargs):
        grad = torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args)
        spec = tuple(_TensorSpec(tuple(a.shape), a.dtype, a.device, a.requires_grad)
                     if isinstance(a, torch.Tensor) else a for a in args)
        key = (grad, spec, tuple(sorted(kwargs.items())))
        cost = self.memo.get(key)
        if cost is None:
            cost = self.memo[key] = self.forward_cost(spec, kwargs, grad)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        lane = current_lane() or self.mem._lane_of_inputs(tensors, {})
        if grad:
            outs = _ReplayFn.apply(self, (key, spec, kwargs), lane, *tensors)
        else:
            outs = self.run(cost, lane, tensors[0].device)
        return outs[0] if cost.single else tuple(outs)


# the cores replayed, by module: the attention cores and the SSM scans
_CORES = ((attn_mod, ("chunked_attention", "dense_attention")),
          (ssm_mod, ("_selective_scan_chunked", "_ssd_chunked")))


@contextlib.contextmanager
def _replayed(mem: LaneMemory):
    """The cores of ``_CORES`` replayed (:class:`_Replay`) inside."""
    orig = [(mod, name, getattr(mod, name)) for mod, names in _CORES for name in names]
    try:
        for mod, name, fn in orig:
            setattr(mod, name, _Replay(fn, mem))
        yield
    finally:
        for mod, name, fn in orig:
            setattr(mod, name, fn)


# =============================================================================
# the memory policies (JAX's dry run, :73-138)
# =============================================================================


@dataclasses.dataclass
class Plan:
    """What a cell runs: the config after the policies, the view, and JAX's
    record fields."""

    cfg: ArchConfig
    info: MeshInfo
    grad_accum: int = 1
    strategy: str = "tp"
    fsdp: bool = False


def policy(cfg: ArchConfig, shape: ShapeConfig, info: MeshInfo, baseline: bool = False) -> Plan:
    """JAX's memory policies for one cell (``baseline`` turns them off):
    grad-accum sizing; ZeRO-1 / ZeRO-3 over every lane, TP off, for non-MoE
    models whose bf16 params and grads fit (ZeRO-1) or that hold at most
    16e9 params (ZeRO-3); FSDP where the per-lane state passes 8e9 bytes
    (``Plan.info.zero`` then ``"zero3"``, the placement that shards params
    and moments); an f8 KV cache where the bf16 one passes 4 GB a lane;
    ``attn_chunk=256`` for a prefill at ``d_model >= 8192``."""
    grad_accum, strategy = 1, "tp"
    if not baseline:
        n_p = cfg.num_params()
        if shape.kind == "train":
            if n_p >= 100e9:
                grad_accum = 8
            elif n_p >= 50e9:
                grad_accum = 4
            elif n_p >= 8e9 or cfg.family in ("ssm", "hybrid"):
                grad_accum = 2
            if cfg.family != "moe" and 2 * n_p * 2 <= 13e9:
                strategy = "dp_zero1"
            elif cfg.family != "moe" and n_p <= 16e9:
                strategy = "dp_zero3"
            if strategy != "tp":
                info = MeshInfo(info.mesh, batch_axes=info.batch_axes + ("model",),
                                tp_enabled=False)
        if shape.kind == "decode":
            width = ((cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) if cfg.mla is not None
                     else 2 * cfg.n_kv_heads * cfg.head_dim)
            if shape.global_batch * shape.seq_len * cfg.n_layers * width * 2 / info.n_devices > 4e9:
                cfg = dataclasses.replace(cfg, kv_cache_dtype="float8_e4m3fn")
        if shape.kind == "prefill" and cfg.d_model >= 8192:
            cfg = dataclasses.replace(cfg, attn_chunk=256)
    state_mult = 12 if shape.kind == "train" else 2
    per_dev = cfg.num_params() * state_mult / info.model_size
    fsdp = ((per_dev > 8e9) or strategy == "dp_zero3") and not baseline
    # the placement: FSDP shards the params over the batch axes (JAX's
    # param_shardings(fsdp=True)) — a dp_zero1 cell's too, whose state on one
    # model lane passes 8e9 — the moments with them; dp_zero1 alone, the moments
    zero = "zero3" if fsdp else "zero1" if strategy == "dp_zero1" else "none"
    return Plan(cfg, dataclasses.replace(info, zero=zero), grad_accum, strategy, fsdp)


# =============================================================================
# one cell
# =============================================================================


def _stand_ins(tree: Any, device: torch.device) -> Any:
    """``meta`` stand-ins as they are on a ``meta`` mesh, zeros of their
    shapes and dtypes on any other device."""
    if device.type == "meta":
        return tree
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), tree)


def _row_batch(batch: dict, r: int, n_rows: int) -> dict:
    """Row r's block of the global batch (the whole batch where it does not
    divide over the rows, as ``batch_shardings`` then replicates it)."""
    b = next(iter(batch.values())).shape[0]
    if b % n_rows:
        return batch
    m = b // n_rows
    return {k: v[r * m:(r + 1) * m] for k, v in batch.items()}


def _batch_bytes(batch: dict, info: MeshInfo) -> list[int]:
    """Each lane's bytes of the batch as ``batch_shardings`` places it."""
    out = [0] * info.n_devices
    for v, sh in zip(leaves(batch), leaves(batch_shardings(batch, info))):
        for i, block in enumerate(sh.blocks(v.shape)):
            out[i] += math.prod(b - a for a, b in block) * v.element_size()
    return out


def _row_params(params: Any, info: MeshInfo, row: list[int], row_info: Optional[MeshInfo]):
    """One row's params: sharded values over the row's mesh (its lanes'
    shards), or the row's one lane's tensors."""
    if row_info is None:
        return tree_map(lambda x: x.shards[row[0]], params)
    rmesh = row_info.mesh
    return tree_map(lambda x: ShardedTensor(x.shape, x.dtype, NamedSharding(rmesh, x.sharding.spec),
                                            [x.shards[i] for i in row]), params)


def _lane_tensors(tree: Any, lanes: list) -> list[tuple[torch.Tensor, Any]]:
    """(tensor, lane) of every tensor of a tree of sharded values or tensors
    (a plain tensor on ``lanes[0]``)."""
    out = []
    for x in leaves(tree):
        if isinstance(x, ShardedTensor):
            out.extend(zip(x.shards, x.lanes))
        elif isinstance(x, torch.Tensor):
            out.append((x, lanes[0]))
    return out


def _out_bytes(result: Any, mem: LaneMemory) -> dict:
    """Bytes of the step's outputs by lane (each storage once; a state
    updated in place counts as output too, as JAX counts a donated one)."""
    out: dict = {}
    seen = set()
    for x in leaves(result):
        if isinstance(x, ShardedTensor):
            pairs = list(zip(x.shards, x.lanes))
        elif isinstance(x, torch.Tensor):
            pairs = [(x, None)]
        else:
            continue
        for t, lane in pairs:
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                lane = lane or mem.owner.get(st._cdata)
                out[lane] = out.get(lane, 0) + st.nbytes()
    return out


def run_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, *, baseline: bool = False,
             plan: Optional[Plan] = None) -> dict:
    """Run one cell's step over ``mesh``'s lanes (``meta`` placeholders, or
    real lanes to hold the same run against) and return its record (the
    caller adds the names). ``plan`` defaults to :func:`policy`'s. Raises
    where the port lacks a part the cell needs."""
    info = mesh_info_for(mesh)
    plan = plan or policy(cfg, shape, info, baseline)
    cfg, info = plan.cfg, plan.info
    lanes = mesh.lanes
    dev = lanes[0].device
    rec: dict = {"chips": mesh.size, "kind": shape.kind, "baseline": baseline,
                 "grad_accum": plan.grad_accum, "strategy": plan.strategy,
                 "kv_cache_dtype": cfg.kv_cache_dtype or cfg.dtype, "fsdp": bool(plan.fsdp)}
    params = _stand_ins(LM(cfg, device="meta").param_specs(), dev)
    batch = _stand_ins(input_specs(cfg, shape), dev)
    index = {id(lane): i for i, lane in enumerate(lanes)}
    rows = [[index[id(lane)] for lane in row] for row in lane_rows(info)]
    n_rows = len(rows)
    traced = rows if shape.kind == "train" else rows[:1]  # serving rows: row 0 stands for all
    arg_extra = _batch_bytes(batch, info)

    mem = LaneMemory()
    for t in batch.values():
        mem.argument(t, None, counted=False)
    t0 = time.perf_counter()
    if shape.kind == "train":
        model = LM(cfg, device=dev)
        step = make_train_step(model, TrainConfig(grad_accum=plan.grad_accum), mesh_info=info)
        state = (params, adamw_init(params))
        if mesh.size > 1:
            state = device_put(state, state_shardings(state, info))
        for t, lane in _lane_tensors(state, lanes):
            mem.argument(t, lane)

        def run():
            with lanes[0].use() if mesh.size == 1 else contextlib.nullcontext():
                return step(*state, batch)
    else:
        if plan.fsdp:
            raise NotImplementedError(f"{cfg.name}: FSDP params over the batch axes "
                                      f"{ZERO_TP_REFUSED}")
        m = info.model_size
        if shape.kind == "prefill":  # LM.forward is the training forward (item 10)
            check_tensor_parallel(cfg, m, training=True)
        if mesh.size > 1:
            params = device_put(params, serve_param_shardings(params, info))
        row_infos = [serving_mesh_info([lanes[i] for i in row]) if m > 1 else None
                     for row in rows]
        models = [LM(cfg, mesh_info=ri) if ri is not None else LM(cfg, device=lanes[row[0]].device)
                  for ri, row in zip(row_infos, rows)]
        row_params = [_row_params(params, info, row, ri) if mesh.size > 1 else params
                      for row, ri in zip(rows, row_infos)]
        for t, lane in _lane_tensors(params, lanes):
            mem.argument(t, lane)
        row_batch = [_row_batch(batch, r, n_rows) for r in range(n_rows)]
        if shape.kind == "decode":
            caches, curs = [], []
            for model, row in zip(models, rows):
                root = lanes[row[0]]
                with root.use():
                    caches.append(model.init_cache(next(iter(row_batch[0].values())).shape[0],
                                                   shape.seq_len))
                    curs.append(torch.full((), shape.seq_len - 1, dtype=torch.int32,
                                           device=root.device))
                for t, lane in _lane_tensors(caches[-1], [root]) + [(curs[-1], root)]:
                    mem.argument(t, lane)

        def run():
            out = []
            for r in range(len(traced)):
                root = lanes[rows[r][0]]
                with root.use():
                    if shape.kind == "prefill":
                        with torch.no_grad():
                            out.append(models[r].forward(row_params[r], row_batch[r])[0])
                    else:
                        out.append(models[r].decode_step(row_params[r], caches[r], row_batch[r],
                                                         curs[r]))
            return out

    with mem, _replayed(mem), collectives.counting() as coll:
        result = run()
    rec["trace_s"] = round(time.perf_counter() - t0, 3)

    # each lane's record: row 0's lanes stand for every row's where only row 0 ran
    n_traced = len(traced)
    stand = {}
    for r, row in enumerate(rows):
        for j, i in enumerate(row):
            stand[i] = lanes[traced[r % n_traced][j]] if r >= n_traced else lanes[i]
    outs = _out_bytes(result, mem)
    per_lane = []
    for i, lane in enumerate(lanes):
        src = stand[i]
        arg = mem.args.get(lane, 0) + arg_extra[i]
        temp = mem.peak.get(src, 0)
        per_lane.append({"argument_bytes": arg, "output_bytes": outs.get(src, 0),
                         "temp_bytes": temp, "peak_bytes": arg + temp})
    worst = max(range(len(lanes)), key=lambda i: per_lane[i]["peak_bytes"])
    rec["mem"] = dict(per_lane[worst], unclaimed_bytes=mem.peak[None])
    rec["lane_mem"] = [(p["argument_bytes"], p["temp_bytes"]) for p in per_lane]
    rec["counted_flops"] = mem.flops * (n_rows // n_traced)
    busiest = max(coll, key=lambda lane: sum(coll[lane].values()), default=None)
    rec["collectives"] = dict(coll[busiest]) if busiest is not None else {}

    zero = {"dp_zero1": "zero1", "dp_zero3": "zero3"}.get(plan.strategy, "none")
    counts = count_cell(cfg, shape, dp=info.data_size, tp=info.model_size, zero=zero)
    terms = RooflineTerms(name="", chips=mesh.size, flops=counts.flops,
                          hbm_bytes=counts.hbm_bytes, coll_bytes=counts.coll_bytes,
                          model_flops=counts.model_flops)
    rec["analytic"] = {
        "flops": counts.flops, "hbm_bytes": counts.hbm_bytes, "coll_bytes": counts.coll_bytes,
        "model_flops": counts.model_flops, "t_compute": terms.t_compute,
        "t_memory": terms.t_memory, "t_collective": terms.t_collective,
        "bottleneck": terms.bottleneck, "step_time": terms.step_time, "mfu": terms.mfu,
        "usefulness": terms.usefulness,
    }
    rec["ok"] = True
    return rec


def lower_cell(arch_name: str, shape_name: str, multi_pod: bool, *,
               baseline: bool = False) -> dict:
    """Run one cell over the production mesh; returns its record (JAX's
    signature; ``baseline=True`` turns the memory policies off)."""
    rec = {"arch": arch_name, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16"}
    rec.update(run_cell(get_arch(arch_name), get_shape(shape_name),
                        make_production_mesh(multi_pod=multi_pod), baseline=baseline))
    return rec


def failed(arch_name: str, shape_name: str, mesh: str, e: BaseException) -> dict:
    """The record of a cell that raised: JAX's keys."""
    return {"arch": arch_name, "shape": shape_name, "mesh": mesh, "ok": False,
            "error": f"{type(e).__name__}: {e}"}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.arch != "all":
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape != "all":
        cells = [c for c in cells if c[1] == args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    with open(args.out, "w") as f:
        for arch_name, shape_name in cells:
            for multi_pod in meshes:
                tag = f"{arch_name}/{shape_name}/{'multi' if multi_pod else 'single'}"
                try:
                    rec = lower_cell(arch_name, shape_name, multi_pod)
                    an = rec["analytic"]
                    print(f"OK   {tag:64s} trace={rec['trace_s']:7.1f}s "
                          f"peak/dev={rec['mem']['peak_bytes'] / 1e9:7.2f}GB "
                          f"bound={an['bottleneck']:10s} step={an['step_time'] * 1e3:8.2f}ms "
                          f"MFU={an['mfu'] * 100:5.1f}%", flush=True)
                except Exception as e:  # noqa: BLE001 - report and continue
                    rec = failed(arch_name, shape_name, "2x16x16" if multi_pod else "16x16", e)
                    print(f"FAIL {tag}: {rec['error'][:200]}", flush=True)
                    if args.fail_fast:
                        traceback.print_exc()
                        raise
                f.write(json.dumps(rec) + "\n")
                f.flush()
                results.append(rec)

    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells ran OK -> {args.out}")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
