"""Shared layers: RMSNorm, RoPE, gated MLP, embeddings (counterparts of
``repro/models/layers.py``).

Params are nested dicts of tensors, with a leading ``L`` axis where the JAX
package stacks layers. Weights are stored in the config dtype, or as int8
``{"q8", "scale"}`` leaves (``models.quant``); math that needs f32 (norms,
RoPE phases, SiLU) upcasts locally and casts back.

The ``*_lanes`` functions are the merged (tensor-parallel) forms, the
counterparts of what GSPMD makes of the same functions over a ``model``
axis: each takes one weight block and one input a lane (a list in lane
order) and runs each lane's part on the lane's stream; the result lands on
the first lane, the controller's (``dist.collectives``). Under autograd they
differentiate through the lane collectives' backward (the merged training
forward).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.dist import collectives
from repro_torch.models.quant import qmatmul

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
    """SwiGLU: (x W_in) * silu(x W_gate) W_out, SiLU in f32 cast back to h's
    dtype; each weight dense or int8 (``models.quant.qmatmul``)."""
    h = qmatmul(x, params["w_in"])
    g = qmatmul(x, params["w_gate"])
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    return qmatmul(h, params["w_out"])


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens.long()]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        return x @ params["head"]
    return x @ params["tok"].T


def embed_tokens_lanes(tables: list[torch.Tensor], tokens: list[torch.Tensor], lanes
                       ) -> torch.Tensor:
    """Vocab-sharded lookup: lane j holds rows [j*n, (j+1)*n) of the table;
    each looks up the tokens in its range, zeros the rest, and the partials
    are summed on the controller lane (one is nonzero a token: the sum is
    the row itself)."""
    parts, start = [], 0
    for tab, tok, lane in zip(tables, tokens, lanes):
        n = tab.shape[0]
        with lane.use():
            local = tok.long() - start
            hit = (local >= 0) & (local < n)
            rows = tab[local.clamp(0, n - 1)]
            parts.append(torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                       device=rows.device)))
        start += n
    return collectives.lane_reduce(parts, lanes)


def unembed_lanes(params: list[Params], xs: list[torch.Tensor], lanes) -> torch.Tensor:
    """Vocab-sharded logits: each lane's rows of the head (or of the tied
    table), gathered along the vocabulary on the controller lane (JAX's
    ``_logits_constraint``: the sampler reads them whole)."""
    parts = []
    for p, x, lane in zip(params, xs, lanes):
        with lane.use():
            parts.append(unembed(p, x))
    return collectives.lane_gather(parts, lanes, dim=-1)


def mlp_apply_lanes(params: list[Params], xs: list[torch.Tensor], lanes) -> torch.Tensor:
    """SwiGLU over lanes: w_in / w_gate split by columns, w_out by rows; each
    lane's product is a partial [..., d], summed on the controller lane."""
    parts = []
    for p, x, lane in zip(params, xs, lanes):
        with lane.use():
            parts.append(mlp_apply(p, x))
    return collectives.lane_reduce(parts, lanes)
