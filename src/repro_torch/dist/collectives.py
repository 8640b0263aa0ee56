"""Ring collective matmuls over a lane axis (counterpart of
``repro/dist/collectives.py``), and the lane collectives of merged serving.

JAX runs these inside ``shard_map`` bodies, each device seeing its local
shard and ringing over a mesh axis with ``ppermute``. The port runs the whole
ring from one thread: the operands are :class:`ShardedTensor` values, each
lane's product queues on the lane's stream (a plain ``torch.matmul``: the
JAX bodies are ``jnp.dot``, no Pallas kernel), and each hop is a copy onto
the next lane of the ring, ordered by CUDA events — the host never waits.
Lanes that differ in another mesh axis form rings of their own.

* ``ring_rs_matmul`` — x [M, K] sharded ``P(A, axis)``, w [K, N] sharded
  ``P(axis, B)``: every lane multiplies its K slice, and the partial
  products are ring reduce-scattered, so each lane ends with its fully
  summed row block; y [M, N] sharded ``P((*A, axis), B)`` ("row-parallel").
* ``ring_ag_matmul`` — x [M, K] sharded ``P(axis, None)``, w [K, N] sharded
  ``P(None, B)``: x's row blocks travel the ring, each hop contributing one
  output block; y [M, N] sharded ``P(None, B)`` ("column-parallel").

The merged (tensor-parallel) serving step combines per-lane tensors that
GSPMD would combine in JAX (it has no source for them): plain torch copies
and adds, ordered by CUDA events. The first lane of the list is the root
(the controller lane). A lane on the root's device reads the root's tensor
itself once its stream waits on the root's: two lanes of one card share
its memory, so moving a value between them is an event, not a copy. A lane
on another device gets a copy.

* ``lane_reduce`` / ``lane_all_reduce`` — the sum of one partial a lane, in
  lane order, on the root (and then on every lane: the same bits
  everywhere);
* ``lane_gather`` / ``lane_all_gather`` — the lanes' blocks concatenated
  along one axis, in lane order;
* ``lane_broadcast`` — the root's tensor on every lane.

Inside :func:`counting` (the production dry run; off everywhere else) each
collective adds the bytes of its result on each lane that receives one,
under the kind names of JAX's HLO: a reduce's sum on the root is
``all-reduce``, a gather's whole on the root ``all-gather``, a broadcast's
copy on every other lane, a ring hop's on its receiver and the block a
gather's backward hands back to each lane ``collective-permute``. The
all-variants are a reduce or a gather and then a broadcast, and an autograd
Function's backward counts as the collective it runs. Eager runs each
collective as often as it executes, so these totals are what JAX's
``roofline/hlo_loops.py`` rebuilds from a loop body's trip counts.

Under autograd (a grad-requiring input, grad mode on) each of the three is
a ``torch.autograd.Function`` whose backward is its transpose, queued on the
lane streams with the forward's event ordering: broadcast's backward is the
reduce of the grads onto the root in lane order, reduce's the broadcast of
the root's grad, gather's the split of the grad along ``dim`` with each
block handed back to its lane (a copy, ordered by its own events, where the
lane lies on another device). The all-variants compose from these. This is
what the merged training forward differentiates through.

A backward keeps autograd's stream contract: the engine hands it its grads
ready on the current stream and takes what it returns as made there (the
next node reads it with no wait of its own: a select's backward on the
caller's stream, say). So every lane waits for the current stream before
the backward's work, the current stream waits for every lane after it, and
each returned tensor is kept for that stream (:func:`_backward_streams`).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import (
    NamedSharding,
    P,
    ShardedTensor,
    copy_between,
    spec_axes,
)


_COUNTS: Optional[dict] = None  # {lane: {kind: bytes}} inside counting()


@contextlib.contextmanager
def counting():
    """Count the lane collectives run inside: yields ``{lane: {kind:
    bytes}}``, the bytes of each collective's result that land on each
    lane, filled as they run (the backward's too, from any thread)."""
    global _COUNTS
    prev, _COUNTS = _COUNTS, {}
    try:
        yield _COUNTS
    finally:
        _COUNTS = prev


def count(kind: str, lane, t: torch.Tensor) -> None:
    """Add ``t``'s bytes, received by ``lane``, under ``kind`` (inside
    :func:`counting` only)."""
    if _COUNTS is not None:
        per = _COUNTS.setdefault(lane, {})
        per[kind] = per.get(kind, 0) + t.numel() * t.element_size()


def _spec(x: ShardedTensor, ndim: int = 2) -> tuple:
    return tuple(x.sharding.spec) + (None,) * (ndim - len(x.sharding.spec))


def _rings(x: ShardedTensor, axis_name: str) -> list[list[int]]:
    """The flat lane indices of each ring: lanes equal in every other axis,
    in ``axis_name``'s order."""
    mesh = x.sharding.mesh
    if axis_name not in mesh.shape:
        raise ValueError(f"axis {axis_name!r} not in {mesh.axis_names}")
    flat = np.arange(mesh.size).reshape(mesh.devices.shape)
    ax = mesh.axis_names.index(axis_name)
    return np.moveaxis(flat, ax, -1).reshape(-1, mesh.shape[axis_name]).tolist()


def _check(x: ShardedTensor, w: ShardedTensor) -> None:
    if x.sharding.mesh is not w.sharding.mesh:
        raise ValueError("x and w must be sharded over one mesh")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}: need [M, K] @ [K, N]")


def _hop(t: torch.Tensor, src, dst) -> torch.Tensor:
    """``t`` from lane ``src`` copied onto lane ``dst`` (one ring hop)."""
    with dst.use():
        out = torch.empty(t.shape, dtype=t.dtype, device=dst.device)
    copy_between(out, dst, t, src)
    return out


def _to_root(t: torch.Tensor, src, root) -> torch.Tensor:
    """``t``, made on lane ``src``, readable on ``root``'s stream: the root
    waits for ``src`` and keeps ``t``'s memory for that read; a copy where the
    two lie on different devices."""
    if src is root:
        return t
    if not root.shares_memory(src):
        return _hop(t, src, root)
    root.wait_for(src)
    root.keep(t)
    return t


def _broadcast(t: torch.Tensor, lanes) -> list[torch.Tensor]:
    root = lanes[0]
    out = [t]
    for lane in lanes[1:]:
        count("collective-permute", lane, t)
        if lane.shares_memory(root):
            lane.wait_for(root)
            lane.keep(t)
            out.append(t)
        else:
            out.append(_hop(t, root, lane))
    return out


def _reduce(parts, lanes) -> torch.Tensor:
    root = lanes[0]
    acc = parts[0]
    with root.use():
        for t, lane in zip(parts[1:], lanes[1:]):
            acc = acc + _to_root(t, lane, root)
    if len(parts) > 1:
        count("all-reduce", root, acc)
    return acc


def _gather(parts, lanes, dim: int) -> torch.Tensor:
    root = lanes[0]
    with root.use():
        out = torch.cat([_to_root(t, lane, root) for t, lane in zip(parts, lanes)], dim=dim)
    if len(parts) > 1:
        count("all-gather", root, out)
    return out


def _from_root(t: torch.Tensor, root, lane) -> torch.Tensor:
    """``t``, made on ``root``, readable on ``lane``'s stream (the transpose
    of :func:`_to_root`)."""
    if lane is root:
        return t
    if not lane.shares_memory(root):
        return _hop(t, root, lane)
    lane.wait_for(root)
    lane.keep(t)
    return t


def _alias(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An output of an autograd Function that hands ``like`` on unchanged:
    a new view where ``t`` is ``like`` itself (a Function's outputs are
    tensors of their own)."""
    return t.view_as(t) if t is like else t


@contextlib.contextmanager
def _backward_streams(lanes):
    """Run a backward's lane work under autograd's stream contract: the
    lanes wait for the current stream of their device on entry; on exit
    that stream waits for every lane, and each tensor appended to the
    yielded list is kept for it (the caching allocator must not hand its
    memory to a lane's next tensor while the engine still reads it)."""
    ambient = {lane.device: torch.cuda.current_stream(lane.device)
               for lane in lanes if lane.stream is not None}
    for lane in lanes:
        if lane.stream is not None:
            lane.stream.wait_stream(ambient[lane.device])
    outs: list = []
    yield outs
    for lane in lanes:
        if lane.stream is not None:
            ambient[lane.device].wait_stream(lane.stream)
    for t in outs:
        if t is not None and t.device in ambient:
            t.record_stream(ambient[t.device])


class _Broadcast(torch.autograd.Function):
    """``lane_broadcast``; backward sums the lanes' grads onto the root in
    lane order (``lane_reduce``)."""

    @staticmethod
    def forward(ctx, lanes, t):
        ctx.lanes = lanes
        return tuple(_alias(o, t) for o in _broadcast(t, lanes))

    @staticmethod
    def backward(ctx, *grads):
        with _backward_streams(ctx.lanes) as outs:
            outs.append(_reduce(grads, ctx.lanes))
        return None, outs[0]


class _Reduce(torch.autograd.Function):
    """``lane_reduce``; backward hands the root's grad to every lane
    (``lane_broadcast``)."""

    @staticmethod
    def forward(ctx, lanes, *parts):
        ctx.lanes = lanes
        return _alias(_reduce(parts, lanes), parts[0])

    @staticmethod
    def backward(ctx, grad):
        with _backward_streams(ctx.lanes) as outs:
            outs.extend(_broadcast(grad, ctx.lanes))
        return (None, *outs)


class _Gather(torch.autograd.Function):
    """``lane_gather``; backward splits the root's grad along ``dim`` and
    hands each block back to its lane."""

    @staticmethod
    def forward(ctx, lanes, dim, *parts):
        ctx.lanes, ctx.dim = lanes, dim
        ctx.sizes = [p.shape[dim] for p in parts]
        return _gather(parts, lanes, dim)

    @staticmethod
    def backward(ctx, grad):
        root = ctx.lanes[0]
        blocks = torch.split(grad, ctx.sizes, dim=ctx.dim)
        for b, lane in zip(blocks[1:], ctx.lanes[1:]):
            count("collective-permute", lane, b)
        with _backward_streams(ctx.lanes) as outs:
            outs.extend(_from_root(b, root, lane) for b, lane in zip(blocks, ctx.lanes))
        return (None, None, *outs)


def _differentiable(parts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in parts)


def lane_broadcast(t: torch.Tensor, lanes) -> list[torch.Tensor]:
    """``t`` (made on ``lanes[0]``, the root) on every lane: the tensor itself
    where a lane shares the root's device (its stream waits for the root's
    work so far), a copy on the lane's stream elsewhere. A list, one entry a
    lane. Under autograd its backward is ``lane_reduce`` of the grads."""
    if _differentiable([t]):
        return list(_Broadcast.apply(lanes, t))
    return _broadcast(t, lanes)


def lane_reduce(parts, lanes) -> torch.Tensor:
    """The sum of ``parts`` (one a lane, each made on its lane's stream) on
    the root ``lanes[0]``, added in lane order: ``((p0 + p1) + p2) + ...``.
    The root's stream waits for each lane's work; the host never does.
    Under autograd its backward is ``lane_broadcast`` of the grad."""
    if _differentiable(parts):
        return _Reduce.apply(lanes, *parts)
    return _reduce(parts, lanes)


def lane_all_reduce(parts, lanes) -> list[torch.Tensor]:
    """``lane_reduce`` then ``lane_broadcast``: the one sum on every lane, the
    same bits on each."""
    return lane_broadcast(lane_reduce(parts, lanes), lanes)


def lane_gather(parts, lanes, dim: int) -> torch.Tensor:
    """The lanes' blocks concatenated along ``dim`` in lane order, on the root
    ``lanes[0]``. Under autograd its backward splits the grad along ``dim``
    and hands each lane its block."""
    if _differentiable(parts):
        return _Gather.apply(lanes, dim, *parts)
    return _gather(parts, lanes, dim)


def lane_all_gather(parts, lanes, dim: int) -> list[torch.Tensor]:
    """``lane_gather`` then ``lane_broadcast``: the whole on every lane."""
    return lane_broadcast(lane_gather(parts, lanes, dim), lanes)


def ring_rs_matmul(x: ShardedTensor, w: ShardedTensor, axis_name: str) -> ShardedTensor:
    """Matmul + ring reduce-scatter over ``axis_name``. Local shapes: x
    [M', K/p], w [K/p, N']; each lane ends with its summed row block
    [M'/p, N']."""
    _check(x, w)
    (xa, xk), (wk, wb) = _spec(x), _spec(w)
    if (spec_axes(xk) != (axis_name,) or spec_axes(wk) != (axis_name,)
            or axis_name in spec_axes(xa)):
        raise ValueError(f"ring_rs_matmul over {axis_name!r} needs x P(A, {axis_name!r}) and "
                         f"w P({axis_name!r}, B); got {x.sharding.spec}, {w.sharding.spec}")
    lanes, p = x.lanes, x.sharding.mesh.shape[axis_name]
    out: list = [None] * len(lanes)
    for ring in _rings(x, axis_name):
        partial = []
        for i in ring:
            with lanes[i].use():
                partial.append(torch.matmul(x.shards[i], w.shards[i]))
        if p == 1:
            out[ring[0]] = partial[0]
            continue
        m = partial[0].shape[0]
        if m % p:
            raise ValueError(f"rows {m} not divisible by axis {axis_name!r} size {p}")
        chunks = [t.view(p, m // p, *t.shape[1:]) for t in partial]
        # lane j hands its accumulator to j-1 each hop; after p-1 hops lane i
        # holds chunk i with all p contributions
        acc = [chunks[j][(j + 1) % p] for j in range(p)]
        for t in range(1, p):
            moved = [_hop(acc[(j + 1) % p], lanes[ring[(j + 1) % p]], lanes[ring[j]])
                     for j in range(p)]
            for j in range(p):
                count("collective-permute", lanes[ring[j]], moved[j])
                with lanes[ring[j]].use():
                    moved[j].add_(chunks[j][(j + 1 + t) % p])
            acc = moved
        for j, i in enumerate(ring):
            out[i] = acc[j]
    spec = P((*spec_axes(xa), axis_name), wb)
    return ShardedTensor((x.shape[0], w.shape[1]), out[0].dtype,
                         NamedSharding(x.sharding.mesh, spec), out)


def ring_ag_matmul(x: ShardedTensor, w: ShardedTensor, axis_name: str) -> ShardedTensor:
    """All-gather-overlapped matmul over ``axis_name``. Local shapes: x
    [M/p, K], w [K, N']; each lane ends with the full-row output [M, N']
    (rows in global order)."""
    _check(x, w)
    (xm, xk), (wk, wb) = _spec(x), _spec(w)
    if spec_axes(xm) != (axis_name,) or xk is not None or wk is not None:
        raise ValueError(f"ring_ag_matmul over {axis_name!r} needs x P({axis_name!r}, None) "
                         f"and w P(None, B); got {x.sharding.spec}, {w.sharding.spec}")
    lanes, p = x.lanes, x.sharding.mesh.shape[axis_name]
    out: list = [None] * len(lanes)
    for ring in _rings(x, axis_name):
        m = x.shards[ring[0]].shape[0]
        res = []
        for i in ring:
            with lanes[i].use():
                res.append(torch.empty((p * m, w.shards[i].shape[1]),
                                       dtype=torch.result_type(x.shards[i], w.shards[i]),
                                       device=lanes[i].device))
        # lane j forwards its x block to j+1, so after t hops the buffer holds
        # lane (j - t)'s rows; each hop contributes that block of the output
        buf = [x.shards[i] for i in ring]
        for t in range(p):
            for j, i in enumerate(ring):
                src = (j - t) % p
                with lanes[i].use():
                    torch.matmul(buf[j], w.shards[i], out=res[j][src * m:(src + 1) * m])
            if t < p - 1:
                buf = [_hop(buf[(j - 1) % p], lanes[ring[(j - 1) % p]], lanes[ring[j]])
                       for j in range(p)]
                for j in range(p):
                    count("collective-permute", lanes[ring[j]], buf[j])
        for j, i in enumerate(ring):
            out[i] = res[j]
    return ShardedTensor((x.shape[0], w.shape[1]), out[0].dtype,
                         NamedSharding(x.sharding.mesh, P(None, wb)), out)
