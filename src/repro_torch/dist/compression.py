"""Row-wise quantization of the serving KV cache (``quantize_rows`` and
``dequantize_rows`` of ``repro/dist/compression.py``; the gradient
compressors there are not ported).

One f32 scale per row over the LAST axis — a (position, head) row of
head_dim elements — so insert-time quantization touches only the written
rows, and the scales live in the cache beside the payload they describe.
The arithmetic is the JAX package's, op for op in the input's dtype
(``torch.round`` rounds half to even like ``jnp.round``, and a cast to
``float8_e4m3fn`` rounds to nearest even in both), so the two agree
bitwise on the same input.
"""

from __future__ import annotations

import torch

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
