"""Rule-based sharding over a mesh of lanes (counterpart of
``repro/dist/sharding.py``).

The JAX fabric is one controller over a ``Mesh`` of devices. The port keeps
that shape over **lanes**. A lane (:class:`Lane`) is a (device, CUDA stream)
pair: a device list may name one card more than once, and each entry is a
lane with a stream of its own; on the CPU a lane has no stream
(``["cpu"] * 8`` stands for JAX's 8 forced host devices). A :class:`Mesh` is
a numpy grid of lanes with one name per axis. A sharded value
(:class:`ShardedTensor`) is its global shape and dtype, a
:class:`NamedSharding` (mesh + :class:`PartitionSpec`) and one local tensor
per lane. :func:`device_put` and :func:`gather` take the place of
``jax.device_put`` and ``np.asarray``. Re-homing a sharded value onto another
sharding copies between lanes on their streams, ordered by CUDA events with
no host sync, and keeps in place a shard already on its target lane.

Two layers, as in the JAX package:

* :class:`MeshInfo` — a mesh plus axis ROLES. MERGE folds the ``pod`` axis
  into the batch axes, SPLIT hands each pod its own ``(data, model)`` view.
  ``constraint`` is a reshard of a sharded value.
* ``spec_for_param`` and friends — pure partition rules keyed on a leaf's
  path, rendered in ``jax.tree_util.keystr``'s form
  (``"['blocks']['attn']['wk']"``), and its shape. They give JAX's spec for
  the same ``(path, ndim, shape, model_size)``:

  * a stacked-layer leading dim (ndim ≥ 3) is never sharded;
  * MoE expert stacks ``[L, E, d, f]`` shard the expert dim;
  * GQA attention ``[L, d, kv_heads, head_dim]`` prefers the heads dim and
    falls back to head_dim when ``kv_heads`` does not divide;
  * embeddings prefer the vocab dim, falling back to d_model;
  * ``model_size == 1`` replicates everything.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import keystr, tree_map, tree_map_with_path

MODEL_AXIS = "model"

# Leaves below this element count replicate (norm gains, biases, scalars).
MIN_SHARD_ELEMS = 2**16

# FSDP second-dim sharding kicks in above this leaf element count by default.
DEFAULT_FSDP_THRESHOLD = 2**24

_LANE_IDS = itertools.count()
_CURRENT_LANE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_lane", default=None)


# =============================================================================
# lanes, meshes, specs and sharded values
# =============================================================================


def current_lane() -> Optional["Lane"]:
    """The lane whose :meth:`Lane.use` encloses the caller (None outside
    any): the production dry run charges each tensor made there to it."""
    return _CURRENT_LANE.get()


@contextlib.contextmanager
def lane_scope(lane: Optional["Lane"]):
    """``lane`` as :func:`current_lane` inside, and nothing else (no
    stream)."""
    token = _CURRENT_LANE.set(lane)
    try:
        yield
    finally:
        _CURRENT_LANE.reset(token)


def recompute_in_lane():
    """``context_fn`` of ``torch.utils.checkpoint``: the recompute in
    backward runs with the forward's :func:`current_lane` (autograd picks
    its stream, as before)."""
    return contextlib.nullcontext(), lane_scope(current_lane())


class Lane:
    """One entry of a mesh: a device and, on a CUDA device, a stream of its
    own. Lanes compare by identity, so two lanes on one card are two mesh
    entries whose work queues apart. A lane on ``meta`` is a placeholder of
    the dry run: no stream, no data, a card of its own."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self.id = next(_LANE_IDS)
        # the lane's CUDA stream; None on the CPU
        self.stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None)

    @contextlib.contextmanager
    def use(self):
        """Queue the enclosed work on the lane's stream (the current stream
        is thread-local), with this lane as :func:`current_lane`. No wait
        edge to the caller's stream, unlike ``DeviceBackend.scope``: lanes
        run apart, and data that crosses lanes is ordered by
        :meth:`wait_for`."""
        with lane_scope(self):
            if self.stream is None:
                yield
            else:
                with torch.cuda.stream(self.stream):
                    yield

    def shares_memory(self, other: "Lane") -> bool:
        """Whether a tensor made on ``other`` is read here in place: one
        device that is not ``meta`` (each placeholder lane of the dry run
        stands for a card of its own, so data crossing to it is a copy)."""
        return other is self or (other.device == self.device and self.device.type != "meta")

    def wait_for(self, other: "Lane") -> None:
        """Order this lane's later work after what is queued on ``other`` so
        far: an event recorded there and waited on here; the host does not
        block."""
        if other is not self and self.stream is not None and other.stream is not None:
            self.stream.wait_stream(other.stream)

    def keep(self, t: torch.Tensor) -> None:
        """Tell the caching allocator that ``t``, made on another stream, is
        read on this lane's stream, so its memory outlives that read."""
        if self.stream is not None and t.device == self.device:
            t.record_stream(self.stream)

    def synchronize(self) -> None:
        """Block the host until the lane's queued work has finished
        (``Stream.synchronize`` releases the GIL meanwhile)."""
        if self.stream is not None:
            self.stream.synchronize()

    def __repr__(self) -> str:
        return f"Lane({self.device}, #{self.id})"


@contextlib.contextmanager
def stream_scope(s: Optional[torch.cuda.Stream], device: torch.device):
    """Queue the enclosed work on ``s``. Entering, ``s`` waits for what the
    caller queued on its own stream (params placed there, say); leaving,
    the caller's stream waits for ``s``, so a caller that reads the work's
    tensors afterwards sees them finished. Both are device-side waits: the
    host never blocks. ``s`` None (the CPU): nothing."""
    if s is None:
        yield
        return
    outer = torch.cuda.current_stream(device)
    s.wait_stream(outer)
    try:
        with torch.cuda.stream(s):
            yield
    finally:
        outer.wait_stream(s)


def lanes_for(devices: Optional[Sequence] = None) -> list[Lane]:
    """One lane per entry of ``devices`` (a lane stays itself, a device or
    its name becomes a new lane). ``None`` means every CUDA device, and
    raises without one."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [d if isinstance(d, Lane) else Lane(d) for d in devices]


def lane_grid(lanes: Sequence[Lane], shape: tuple[int, ...]) -> np.ndarray:
    """The lanes as a numpy object array of ``shape`` (row-major)."""
    grid = np.empty(len(lanes), dtype=object)
    grid[:] = list(lanes)
    return grid.reshape(shape)


class Mesh:
    """A numpy grid of lanes with one name per axis, after
    ``jax.sharding.Mesh``: ``devices`` (the grid), ``axis_names``, ``shape``
    (axis name -> size) and ``size``."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        grid = devices if isinstance(devices, np.ndarray) else lane_grid(list(devices), (-1,))
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D lane grid needs {grid.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        if not all(isinstance(lane, Lane) for lane in grid.flat):
            raise TypeError("a mesh holds lanes (repro_torch.dist.sharding.Lane)")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lanes(self) -> list[Lane]:
        """The lanes in the grid's flat (row-major) order."""
        return list(self.devices.flat)

    def synchronize(self) -> None:
        for lane in self.lanes:
            lane.synchronize()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, lanes={self.lanes})"


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per leading dim — None
    (replicated), an axis name, or a tuple of axis names (major first). A
    1-tuple is kept as its name and an empty tuple as None, as JAX does."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else p[0] if len(p) == 1 else p
            return p

        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where each block of a global value lives."""

    mesh: Mesh
    spec: PartitionSpec = PartitionSpec()

    def blocks(self, shape: Sequence[int]) -> list[tuple[tuple[int, int], ...]]:
        """Each lane's block (a (start, stop) per dim) of a global value of
        ``shape``, in the mesh's flat order. Raises where a sharded dim does
        not divide over its axes."""
        mesh, spec = self.mesh, self.spec
        if len(spec) > len(shape):
            raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
        dims = []
        for d, n in enumerate(shape):
            axes = spec_axes(spec[d]) if d < len(spec) else ()
            unknown = [a for a in axes if a not in mesh.shape]
            if unknown:
                raise ValueError(f"spec {spec} names axes {unknown} not in {mesh.axis_names}")
            parts = math.prod(mesh.shape[a] for a in axes)
            if n % parts:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {axes} "
                                 f"({parts} parts)")
            dims.append((axes, n // parts))
        out = []
        for coord in np.ndindex(*mesh.devices.shape):
            at = dict(zip(mesh.axis_names, coord))
            block = []
            for axes, size in dims:
                k = 0
                for a in axes:
                    k = k * mesh.shape[a] + at[a]
                block.append((k * size, (k + 1) * size))
            out.append(tuple(block))
        return out


def _index(block) -> tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in block)


class ShardedTensor:
    """A global value laid over a mesh's lanes: the whole's ``shape`` and
    ``dtype``, its ``sharding``, and ``shards`` — one local tensor per lane
    in the mesh's flat order, each on its lane's device, made on its lane's
    stream."""

    def __init__(self, shape, dtype: torch.dtype, sharding: NamedSharding,
                 shards: Sequence[torch.Tensor]) -> None:
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.shards = list(shards)
        if len(self.shards) != sharding.mesh.size:
            raise ValueError(f"{len(self.shards)} shards for {sharding.mesh.size} lanes")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def lanes(self) -> list[Lane]:
        return self.sharding.mesh.lanes

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, lanes={self.sharding.mesh.size})")


def copy_between(out: torch.Tensor, out_lane: Lane, src: torch.Tensor, src_lane: Lane) -> None:
    """``out.copy_(src)`` where ``src`` was made on ``src_lane``'s stream and
    ``out`` belongs to ``out_lane``: the copy waits for ``src_lane``'s queued
    work on the device and keeps ``src`` alive for it; the host never
    waits."""
    out_lane.wait_for(src_lane)
    with src_lane.use(), out_lane.use():
        out.copy_(src)
    out_lane.keep(src)


def _place(x: Any, sharding: NamedSharding) -> ShardedTensor:
    """One leaf onto ``sharding``: a sharded value is re-homed, anything else
    (a tensor, a numpy array) is copied block by block onto the lanes."""
    if isinstance(x, ShardedTensor):
        return _reshard(x, sharding)
    t = torch.as_tensor(x)
    shards = []
    for lane, block in zip(sharding.mesh.lanes, sharding.blocks(t.shape)):
        if t.device.type == "cuda" and lane.stream is not None:
            lane.stream.wait_stream(torch.cuda.current_stream(t.device))
        with lane.use():
            out = torch.empty([b - a for a, b in block], dtype=t.dtype, device=lane.device)
            out.copy_(t[_index(block)])
        lane.keep(t)
        shards.append(out)
    return ShardedTensor(t.shape, t.dtype, sharding, shards)


def _intersect(a, b):
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def _relative(block, origin) -> tuple[slice, ...]:
    return tuple(slice(a - o, b - o) for (a, b), (o, _) in zip(block, origin))


def _reshard(x: ShardedTensor, sharding: NamedSharding) -> ShardedTensor:
    """Re-home ``x`` onto ``sharding``. A target lane that already holds its
    block of ``x`` keeps that tensor (no copy); any other block is assembled
    from the source blocks it overlaps, each read from a lane on the target's
    device where one holds it."""
    sources: dict[tuple, list[int]] = {}
    for i, block in enumerate(x.sharding.blocks(x.shape)):
        sources.setdefault(block, []).append(i)
    src_lanes = x.lanes
    shards = []
    for lane, block in zip(sharding.mesh.lanes, sharding.blocks(x.shape)):
        held = [i for i in sources.get(block, ()) if src_lanes[i] is lane]
        if held:
            shards.append(x.shards[held[0]])
            continue
        with lane.use():
            out = torch.empty([b - a for a, b in block], dtype=x.dtype, device=lane.device)
        for src_block, idx in sources.items():
            inter = _intersect(block, src_block)
            if inter is None:
                continue
            i = min(idx, key=lambda j: src_lanes[j].device != lane.device)
            copy_between(out[_relative(inter, block)], lane,
                         x.shards[i][_relative(inter, src_block)], src_lanes[i])
        shards.append(out)
    return ShardedTensor(x.shape, x.dtype, sharding, shards)


def lane_blocks(x: ShardedTensor, spec: PartitionSpec, strict: bool = False
                ) -> list[torch.Tensor]:
    """Each lane's block of ``x`` under ``spec`` (over ``x``'s mesh), in the
    mesh's flat order: a view of the lane's own shard where that shard holds
    the block (a sharded leaf at ``spec``, or a replicated one), else a copy
    assembled from the lanes that hold it (``_reshard``). ``strict`` raises
    instead of copying: a view is differentiable, the copy is not."""
    target = NamedSharding(x.sharding.mesh, spec)
    have, want = x.sharding.blocks(x.shape), target.blocks(x.shape)
    out: list = []
    for t, h, w in zip(x.shards, have, want):
        inside = all(h0 <= w0 and w1 <= h1 for (h0, h1), (w0, w1) in zip(h, w))
        out.append(t[_relative(w, h)] if inside else None)
    if any(t is None for t in out):
        if strict:
            raise ValueError(f"a leaf placed at {x.sharding.spec} does not hold each lane's "
                             f"block at {spec}: place it by serve_param_shardings")
        moved = _reshard(x, target).shards
        out = [m if t is None else t for t, m in zip(out, moved)]
    return out


def gather(x: ShardedTensor, device=None) -> torch.Tensor:
    """The whole of ``x`` as one tensor on ``device`` (default: its first
    lane's device), on the caller's current stream, which waits for the
    lanes' work first. To the CPU this blocks until the copy is done."""
    dev = x.lanes[0].device if device is None else torch.device(device)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    done = set()
    for lane, block, t in zip(x.lanes, x.sharding.blocks(x.shape), x.shards):
        if block in done:
            continue
        done.add(block)
        if lane.stream is not None:
            cur = torch.cuda.current_stream(lane.device)
            cur.wait_stream(lane.stream)
            t.record_stream(cur)
        out[_index(block)].copy_(t)
    return out


# =============================================================================
# trees
# =============================================================================


def device_put(tree: Any, shardings: Any) -> Any:
    """Place every leaf of ``tree`` (tensors, numpy arrays or sharded values)
    onto its sharding: ``shardings`` is one :class:`NamedSharding` for every
    leaf or a tree of them of ``tree``'s structure. Returns a tree of
    :class:`ShardedTensor`."""
    if isinstance(shardings, NamedSharding):
        return tree_map(lambda x: _place(x, shardings), tree)
    return tree_map(_place, tree, shardings)


# =============================================================================
# MeshInfo: a mesh plus axis roles
# =============================================================================


ZERO_STRATEGIES = ("none", "zero1", "zero3")


@dataclass(frozen=True)
class MeshInfo:
    """A lane mesh annotated with which axes carry the batch and whether
    tensor parallelism over the ``model`` axis is on. ``tp_enabled=False``
    demotes the ``model`` axis to a batch axis (list it in ``batch_axes``):
    ``model_axis`` is then None and ``model_size`` 1, as JAX's. ``zero``
    names the training state's placement over the batch axes, as JAX's dry
    run picks it (``launch/dryrun.py``): ``"zero1"`` shards the AdamW
    moments, ``"zero3"`` the params too (``train.step.state_shardings``)."""

    mesh: Mesh
    batch_axes: tuple[str, ...] = ("data",)
    tp_enabled: bool = True
    zero: str = "none"

    def __post_init__(self) -> None:
        if self.zero not in ZERO_STRATEGIES:
            raise ValueError(f"zero={self.zero!r}: one of {ZERO_STRATEGIES}")

    @property
    def n_devices(self) -> int:
        """The lanes of the view (JAX's name)."""
        return self.mesh.size

    @property
    def data_size(self) -> int:
        """Total data-parallel degree: product of the batch axes' sizes."""
        return int(np.prod([self.mesh.shape[a] for a in self.batch_axes], dtype=np.int64))

    @property
    def model_axis(self) -> Optional[str]:
        """The tensor-parallel axis name, or None when TP is off."""
        if not self.tp_enabled:
            return None
        if MODEL_AXIS not in self.mesh.axis_names or MODEL_AXIS in self.batch_axes:
            return None
        return MODEL_AXIS

    @property
    def model_size(self) -> int:
        ax = self.model_axis
        return int(self.mesh.shape[ax]) if ax is not None else 1

    def named(self, spec: PartitionSpec) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    def constraint(self, x: ShardedTensor, spec: PartitionSpec) -> ShardedTensor:
        """Reshard ``x`` onto ``spec`` over this view's lanes."""
        return _place(x, self.named(spec))

    def batch_spec(self, ndim: int) -> PartitionSpec:
        """P with the batch axes on dim 0 and the rest replicated."""
        return P(self.batch_axes, *([None] * (ndim - 1)))


def single_device_mesh_info(device=None) -> MeshInfo:
    """Degenerate 1-lane ``(data, model)`` view over ``device`` (default:
    the current CUDA device)."""
    grid = lane_grid(lanes_for([resolve_device(device)]), (1, 1))
    return MeshInfo(Mesh(grid, ("data", MODEL_AXIS)), batch_axes=("data",))


def serving_mesh_info(devices: Optional[Sequence] = None) -> MeshInfo:
    """Merged serving fabric: ONE ``(data=1, model=N)`` view over the given
    devices or lanes (default: every CUDA device)."""
    lanes = lanes_for(devices)
    return MeshInfo(Mesh(lane_grid(lanes, (1, len(lanes))), ("data", MODEL_AXIS)),
                    batch_axes=("data",))


# =============================================================================
# partition rules (the JAX package's, for the same inputs)
# =============================================================================


def _divisible(dim: int, by: int) -> bool:
    return dim >= by and dim % by == 0


def spec_for_param(path: str, ndim: int, shape: tuple[int, ...], model_size: int
                   ) -> PartitionSpec:
    """Tensor-parallel PartitionSpec for one parameter leaf; ``path`` in
    ``jax.tree_util.keystr``'s form. Rules key on substrings so they apply
    under optimizer-state prefixes too."""
    if model_size <= 1 or ndim == 0:
        return P()
    parts: list[Any] = [None] * ndim
    first = 1 if ndim >= 3 else 0  # a stacked-layer dim 0 is scanned over, never sharded

    # MoE expert stacks [L, E, d, f]: the exact `['moe']` segment, not the
    # shared expert (a plain MLP) nor attention under `moe_blocks`
    if "['moe']" in path and "shared" not in path and ndim == 4:
        if _divisible(shape[1], model_size):
            parts[1] = MODEL_AXIS
            return P(*parts)

    # attention projections [L, d, (kv_)heads, head_dim]: heads, then head_dim
    if "attn" in path and ndim == 4:
        for dim in (2, 3):
            if _divisible(shape[dim], model_size):
                parts[dim] = MODEL_AXIS
                return P(*parts)

    # generic rule: the largest shardable dim wins
    for dim in sorted(range(first, ndim), key=lambda d: shape[d], reverse=True):
        if _divisible(shape[dim], model_size):
            parts[dim] = MODEL_AXIS
            return P(*parts)
    return P()


def _add_fsdp_dim(
    spec: PartitionSpec,
    shape: tuple[int, ...],
    info: MeshInfo,
    data_size: int,
    threshold: int = DEFAULT_FSDP_THRESHOLD,
) -> PartitionSpec:
    """ZeRO/FSDP second-dim sharding: the batch axes on the largest free dim
    of a big leaf; a stacked-layer dim 0 (ndim ≥ 3) is never eligible."""
    ndim = len(shape)
    if ndim == 0 or math.prod(shape) < threshold:
        return spec
    parts: list[Any] = list(spec) + [None] * (ndim - len(spec))
    first = 1 if ndim >= 3 else 0
    candidates = [
        d for d in range(first, ndim)
        if parts[d] is None and _divisible(shape[d], max(data_size, 1))
    ]
    if not candidates:
        return spec
    best = max(candidates, key=lambda d: shape[d])
    parts[best] = info.batch_axes
    return P(*parts)


def spec_for_batch(shape: tuple[int, ...], data_size: int, batch_axes: tuple[str, ...]
                   ) -> PartitionSpec:
    """Batch-leaf spec: dim 0 over the batch axes when divisible, replicated
    otherwise (odd global batches, scalars)."""
    if not shape or data_size <= 0 or not _divisible(shape[0], max(data_size, 1)):
        return P()
    return P(batch_axes, *([None] * (len(shape) - 1)))


# =============================================================================
# tree builders
# =============================================================================


def param_shardings(
    tree: Any,
    info: MeshInfo,
    *,
    fsdp: bool = False,
    fsdp_threshold: int = DEFAULT_FSDP_THRESHOLD,
) -> Any:
    """NamedSharding tree for params (or anything param-shaped) of JAX's
    layout; leaves are anything with a ``shape``. ``fsdp=True`` also shards
    big leaves over the batch axes."""
    model_size = info.model_size

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0 or math.prod(shape) < MIN_SHARD_ELEMS:
            spec = P()
        else:
            spec = spec_for_param(keystr(path), len(shape), shape, model_size)
        if fsdp:
            spec = _add_fsdp_dim(spec, shape, info, info.data_size, fsdp_threshold)
        return info.named(spec)

    return tree_map_with_path(one, tree)


def serve_param_shardings(tree: Any, info: MeshInfo) -> Any:
    """The merged view's placement, for serving and for training: ``param_shardings``,
    except that
    an attention output projection ``wo`` [L, H, hd, d] it shards places its
    heads (dim 1) on the ``model`` axis where they divide. The attention
    rule tries dims 2 and 3, written for wq/wk/wv's [L, d, heads, hd], and
    so splits wo's head_dim; GSPMD reshards that silently, while each lane
    of the port multiplies its own heads' outputs by its own rows of wo, a
    partial product that stays on the lane. The bytes placed are the same.

    The rules key on a leaf's last path entry and its shape, so one call
    places a training state ``(params, AdamWState)`` whole: each moment
    (``.mu[...]``, ``.nu[...]``) on its parameter's block, the step
    replicated. (``opt_shardings``, JAX's rule, would put wo's moments on
    head_dim blocks beside a parameter placed by heads.)"""
    model_size = info.model_size

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0 or math.prod(shape) < MIN_SHARD_ELEMS:
            return info.named(P())
        key = keystr(path)
        spec = spec_for_param(key, len(shape), shape, model_size)
        if ("attn" in key and path[-1] == "wo" and len(shape) == 4
                and any(p is not None for p in spec) and _divisible(shape[1], model_size)):
            spec = P(None, MODEL_AXIS, None, None)
        return info.named(spec)

    return tree_map_with_path(one, tree)


def opt_shardings(opt_tree: Any, info: MeshInfo, **kwargs: Any) -> Any:
    """Optimizer-state shardings: moments mirror their parameter's spec (the
    rules key on path substrings); scalars replicate."""
    return param_shardings(opt_tree, info, **kwargs)


def batch_shardings(tree: Any, info: MeshInfo) -> Any:
    """NamedSharding tree for a data batch: leading dim over the batch axes,
    replicated when the batch does not divide ``data_size``."""
    data_size = info.data_size
    return tree_map_with_path(
        lambda _, leaf: info.named(
            spec_for_batch(tuple(leaf.shape), data_size, info.batch_axes)),
        tree,
    )


def replicated(info: MeshInfo) -> NamedSharding:
    """Fully replicated sharding on this view (scalars, metrics)."""
    return info.named(P())


# cache leaves whose dim 2 is the SEQUENCE axis ([L, B, S, ...])
_SEQ_CACHE_KEYS = frozenset(
    {"k", "v", "k_scale", "v_scale", "attn_k", "attn_v", "ckv", "krope"}
)


def serve_cache_shardings(cache_shape: Any, info: MeshInfo) -> Any:
    """KV-cache placement for the serving slot pool: the slot (B) and
    sequence (S) dims are never sharded. Positional caches (leaf names in
    ``_SEQ_CACHE_KEYS``) partition only dims past the sequence axis — KV
    heads first, head_dim / latent rank as the fallback; recurrent SSM
    leaves take their widest dim from 2 on. The layer dim 0 never shards."""
    ms = info.model_size

    def leaf_spec(path, leaf):
        ndim = len(leaf.shape)
        parts: list[Any] = [None] * ndim
        if ms > 1 and ndim >= 2:
            name = path[-1] if path else None
            if name in _SEQ_CACHE_KEYS:
                order = [d for d in (ndim - 2, ndim - 1) if d >= 3]
            else:
                order = sorted(range(2, ndim), key=lambda d: leaf.shape[d], reverse=True)
            for d in order:
                if _divisible(leaf.shape[d], ms):
                    parts[d] = MODEL_AXIS
                    break
        return info.named(P(*parts))

    return tree_map_with_path(leaf_spec, cache_shape)


def serve_state_shardings(tree: Any, info: MeshInfo) -> Any:
    """Per-slot engine state: replicated on every lane (one controller)."""
    return tree_map_with_path(lambda _, __: replicated(info), tree)
