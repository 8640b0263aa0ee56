"""Shared layers: RMSNorm, RoPE, gated MLP, embeddings (counterparts of
``repro/models/layers.py``).

Params are nested dicts of tensors, with a leading ``L`` axis where the JAX
package stacks layers. Weights are stored in the config dtype; math that
needs f32 (norms, RoPE phases, SiLU) upcasts locally and casts back.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]


def trunc_normal(shape, generator: torch.Generator, dtype, device, scale: float = 1.0):
    """Standard normal truncated to [-2, 2] (as ``jax.random.truncated_normal``
    (-2, 2)), times ``scale``, drawn in f32 and cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * scale).to(dtype)


def dense_init(shape, generator, dtype, device, fan_in: int | None = None):
    """Truncated normal with 1/sqrt(fan_in) scaling (fan_in = shape[0] default)."""
    fan_in = shape[0] if fan_in is None else fan_in
    return trunc_normal(shape, generator, dtype, device, fan_in**-0.5)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 with cast back to x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for RoPE, shape [dim//2], f32."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate the halves (x[..., :d/2], x[..., d/2:]) by position phases.

    x: [..., S, n, d] (n = heads axis); positions: [..., S] int — broadcast
    against x's S axis. Phases in f32, cast back to x.dtype."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, x.device)
    angles = positions[..., None].float() * inv_freq  # [..., S, d/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (x W_in) * silu(x W_gate) W_out, SiLU in f32 cast back to h's dtype."""
    h = x @ params["w_in"]
    g = x @ params["w_gate"]
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    return h @ params["w_out"]


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens.long()]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        return x @ params["head"]
    return x @ params["tok"].T
