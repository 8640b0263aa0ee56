"""Ring collective matmuls over a lane axis (counterpart of
``repro/dist/collectives.py``).

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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.sharding import (
    NamedSharding,
    P,
    ShardedTensor,
    copy_between,
    spec_axes,
)


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
        for j, i in enumerate(ring):
            out[i] = res[j]
    return ShardedTensor((x.shape[0], w.shape[1]), out[0].dtype,
                         NamedSharding(x.sharding.mesh, P(None, wb)), out)
