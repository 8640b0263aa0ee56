"""Int8 compression (counterpart of ``repro/dist/compression.py``): the
chunked quantizer of the training collectives and its ring all-reduce over
lanes, and the row-wise quantizer of the serving KV cache.

* :func:`quantize` / :func:`dequantize` — symmetric int8 with one f32 scale
  per ``chunk`` elements, ``scale = amax / 127``, round to nearest even;
  the tail chunk is its own segment (no padding).
* :func:`ring_allreduce_q8` — the mean of one tensor a lane over a ring of
  lanes with int8 hops: each lane quantizes its tensor once, the int8
  payload and its scales travel the ring lane to lane (``copy_between``, on
  the lanes' streams, ordered by CUDA events), and every lane dequantizes
  and accumulates in f32 in the JAX ring's order (its own term, then the
  one from the lane before it, ...), dividing by the lane count at the end.
  JAX runs it inside ``shard_map`` over a mesh axis; the port runs the whole
  ring from one thread over the lanes it is given.
* :func:`quantize_rows` / :func:`dequantize_rows` — one f32 scale per row
  over the LAST axis — a (position, head) row of head_dim elements — so
  insert-time quantization touches only the written rows, and the scales
  live in the cache beside the payload they describe.

The arithmetic is the JAX package's, op for op in f32 (``torch.round``
rounds half to even like ``jnp.round``, and a cast to ``float8_e4m3fn``
rounds to nearest even in both), so the two agree bitwise on the same
input.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.common.tree import leaves, unflatten
from repro_torch.dist.sharding import Lane, copy_between

# 1 KiB of int8 payload per f32 scale
CHUNK = 1024

_INT8_MAX = 127.0
_F8_MAX = 448.0  # float8_e4m3fn max finite value


def quantize_rows(x: torch.Tensor, store_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization over the last axis: ``(values,
    scales)`` with one scale per row. ``store_dtype=float32`` is the identity
    lane — values pass through untouched with all-ones f32 scales, so the
    quantized machinery at f32 storage is bit-identical to the plain path."""
    if store_dtype == torch.float32:
        return x, torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device)
    amax = x.abs().amax(dim=-1)
    if store_dtype == torch.float8_e4m3fn:
        # scale rows to the e4m3 range; the same per-row scales as int8
        scale = torch.where(amax > 0, amax, 1.0) / _F8_MAX
        q = torch.clamp(x / scale[..., None], -_F8_MAX, _F8_MAX)
        return q.to(store_dtype), scale
    if store_dtype != torch.int8:
        raise ValueError(f"unsupported store dtype {store_dtype}")
    scale = torch.where(amax > 0, amax, 1.0) / _INT8_MAX
    q = torch.clamp(torch.round(x / scale[..., None]), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`; f32 with ``q``'s shape."""
    return q.float() * scale[..., None].float()


def quantize(x: torch.Tensor, *, chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one f32 scale per ``chunk`` elements: ``(q,
    scales)``, q int8 of x's shape, scales f32 [ceil(numel / chunk)] (a
    scalar when one chunk holds it all). The full chunks and the tail are
    scaled as separate segments, as the JAX function does."""
    x = x.float()
    flat = x.reshape(-1)
    n = flat.shape[0]
    if n == 0:  # one all-zero chunk's scale, an empty payload
        return flat.to(torch.int8), torch.tensor(1.0 / _INT8_MAX, device=x.device)
    n_full = n // chunk
    rem = n - n_full * chunk
    amaxes = []
    if n_full:
        amaxes.append(flat[:n_full * chunk].reshape(n_full, chunk).abs().amax(dim=1))
    if rem:
        amaxes.append(flat[n_full * chunk:].abs().amax(dim=0, keepdim=True))
    amax = torch.cat(amaxes) if len(amaxes) > 1 else amaxes[0]
    scale = torch.where(amax > 0, amax, 1.0) / _INT8_MAX
    parts = []
    if n_full:
        body = flat[:n_full * chunk].reshape(n_full, chunk)
        parts.append(torch.clamp(torch.round(body / scale[:n_full, None]), -_INT8_MAX,
                                 _INT8_MAX).reshape(-1))
    if rem:
        parts.append(torch.clamp(torch.round(flat[n_full * chunk:] / scale[-1]), -_INT8_MAX,
                                 _INT8_MAX))
    q = (torch.cat(parts) if len(parts) > 1 else parts[0]).to(torch.int8).reshape(x.shape)
    return q, (scale[0] if scale.shape[0] == 1 else scale)


def dequantize(q: torch.Tensor, scale: torch.Tensor, *, chunk: int = CHUNK) -> torch.Tensor:
    """Inverse of :func:`quantize`: f32 of q's shape."""
    flat = q.float().reshape(-1)
    n = flat.shape[0]
    if n == 0:
        return flat.reshape(q.shape)
    scale = torch.atleast_1d(scale)
    n_full = n // chunk
    rem = n - n_full * chunk
    parts = []
    if n_full:
        parts.append((flat[:n_full * chunk].reshape(n_full, chunk)
                      * scale[:n_full, None]).reshape(-1))
    if rem:
        parts.append(flat[n_full * chunk:] * scale[n_full])
    return (torch.cat(parts) if len(parts) > 1 else parts[0]).reshape(q.shape)


def _hop(t: torch.Tensor, src: Lane, dst: Lane) -> torch.Tensor:
    """``t`` from lane ``src`` copied onto lane ``dst``: one ring hop."""
    with dst.use():
        out = torch.empty(t.shape, dtype=t.dtype, device=dst.device)
    copy_between(out, dst, t, src)
    return out


def ring_allreduce_q8(xs: list[torch.Tensor], lanes: list[Lane], *, chunk: int = CHUNK
                      ) -> list[torch.Tensor]:
    """Mean over the ring ``lanes`` (in that order) of ``xs`` (one tensor a
    lane, each made on its lane's stream), with int8 hops. Returns one f32
    tensor a lane: lane j's is (own + from j-1 + from j-2 + ...) / p, each
    term a dequantized int8 payload (the own term too, so every lane sums
    identically compressed terms). A one-lane ring returns its own term."""
    p = len(lanes)
    if len(xs) != p:
        raise ValueError(f"{len(xs)} tensors for {p} lanes")
    bufs, accs = [], []
    for x, lane in zip(xs, lanes):
        with lane.use():
            q, s = quantize(x, chunk=chunk)
            bufs.append((q, s))
            accs.append(dequantize(q, s, chunk=chunk))
    if p == 1:
        return accs
    for _ in range(p - 1):  # every payload one lane on: j -> j + 1
        bufs = [tuple(_hop(t, lanes[j - 1], lanes[j]) for t in bufs[j - 1]) for j in range(p)]
        for j, lane in enumerate(lanes):
            with lane.use():
                accs[j] = accs[j] + dequantize(*bufs[j], chunk=chunk)
    out = []
    for acc, lane in zip(accs, lanes):
        with lane.use():
            out.append(acc / p)
    return out


def allreduce_pytree_q8(trees: list[Any], lanes: list[Lane], *, chunk: int = CHUNK
                        ) -> list[Any]:
    """Leaf-wise :func:`ring_allreduce_q8` over one tree a lane (trees of one
    structure): one reduced tree a lane."""
    flat = [leaves(t) for t in trees]
    reduced = [ring_allreduce_q8(list(xs), lanes, chunk=chunk) for xs in zip(*flat)]
    return [unflatten(trees[j], [r[j] for r in reduced]) for j in range(len(trees))]
