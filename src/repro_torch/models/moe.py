"""Mixture-of-experts block (the counterpart of ``repro/models/moe.py``).

Routed experts with a capacity-bounded dispatch, plus always-on shared
experts. One card holds every expert, so this is the JAX package's
reference path (no mesh); its expert-parallel ``shard_map`` branch is not
ported.

* :func:`moe_dispatch` routes the flattened ``[T, d]`` tokens: f32 router
  logits, softmax, top-k (``jax.lax.top_k``'s order), renormalised top-k
  weights, the Switch aux loss ``E * sum_e f_e * P_e``, then each (token, k)
  entry's slot within its expert by an exclusive cumsum of one-hots over
  the entries in token-major order; an entry is kept while its slot is
  below the capacity C (:func:`_capacity`). It returns the ``[E, C]`` slot
  tables and the inverse map of every entry into them.
* :func:`moe_apply` gathers each expert's slots, runs the three expert
  products as batched ``bmm`` over ``[E, C, d]`` and combines each token's
  kept rows through the inverse map; the shared experts run as one SwiGLU of
  width ``n_shared * expert_ff`` (``layers.mlp_apply``).
* :func:`moe_reference_dense` is the no-drop oracle: every expert for every
  token, mixed by the renormalised top-k weights.

The expert products are plain ``torch.bmm``, as the JAX package's are plain
``jnp.einsum`` outside any Pallas call. The router is f32 and never
quantized; int8 expert stacks (``models.quant``) are read through
``qweight`` into the activation dtype, as the JAX ``moe_apply`` reads them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import Params, dense_init, mlp_apply
from repro_torch.models.quant import qweight


def moe_init(cfg: ArchConfig, generator: torch.Generator, dtype, device,
             n_layers: int) -> Params:
    """``n_layers`` MoE blocks' params, stacked [L, ...], from ``generator``
    (on ``device``). The router is f32 whatever ``dtype`` is. Each weight
    scales by its input width**-0.5: d for the router, ``w_in`` and
    ``w_gate``, ff for ``w_out``. (The JAX package's ``dense_init`` takes the
    leading axis of the stacked [E, d, ff] experts, E, as their fan-in: its
    random layers then grow the residual stream so fast that at full depth
    one bf16 rounding decorrelates the logits, and a random model there can
    hold no kernel against its plain version. The tests carry the JAX
    package's weights over, whatever their scale.)"""
    m, d, L = cfg.moe, cfg.d_model, n_layers
    ff = m.expert_ff or cfg.d_ff
    E = m.n_routed

    def w(shape, fan_in, dt=dtype):
        return dense_init((L, *shape), generator, dt, device, fan_in=fan_in)

    p: Params = {
        "router": w((d, E), d, torch.float32),
        "w_in": w((E, d, ff), d),
        "w_gate": w((E, d, ff), d),
        "w_out": w((E, ff, d), ff),
    }
    if m.n_shared:
        sf = m.n_shared * ff
        p["shared"] = {"w_in": w((d, sf), d), "w_gate": w((d, sf), d), "w_out": w((sf, d), sf)}
    return p


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots an expert takes from a call that routes ``tokens`` tokens (host
    Python, the JAX package's rule)."""
    m = cfg.moe
    c = int(tokens * m.top_k * m.capacity_factor / m.n_routed) + 1
    # tiny token counts (decode steps): give full capacity — a dropped token
    # at decode corrupts its sequence, and the slot table is tiny anyway.
    c = max(c, min(tokens, 16))
    return max(min(c, tokens), 1)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: descending, and the lower index
    first among equal values. ``torch.topk`` promises no order on ties; a
    stable descending sort keeps the indices of equal values ascending."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x_flat: torch.Tensor, router: torch.Tensor, k: int):
    """(probs [T, E], renormalised top-k weights [T, k] f32, experts [T, k])."""
    logits = x_flat.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


class Dispatch(NamedTuple):
    """One call's routing. ``slot_tok`` [E, C] int64 (0 in an empty slot),
    ``slot_w`` [E, C] f32 (the entry's top-k weight, 0 in an empty slot),
    ``slot_valid`` [E, C] bool; ``inv`` [T, k] int64 — entry (t, j)'s row in
    the flattened [E * C] tables, ``E * C`` where it was dropped; ``keep``
    [T, k] bool; ``aux`` the load-balance loss (None when not asked for)."""

    slot_tok: torch.Tensor
    slot_w: torch.Tensor
    slot_valid: torch.Tensor
    inv: torch.Tensor
    keep: torch.Tensor
    aux: Optional[torch.Tensor]


def moe_dispatch(router: torch.Tensor, cfg: ArchConfig, x_flat: torch.Tensor,
                 aux: bool = True) -> Dispatch:
    """Route the [T, d] tokens of one call to their experts' slots.

    Capacity depends on the T of the call (``_capacity``), so every token
    routed here counts, padding included: the caller passes exactly the
    tensor the JAX package routes (a fused admission's whole bucket, every
    slot of a decode step, a pack's whole T bucket, a verify pack's B·(K+1)
    rows) and never trims padding first. Entries take slots in token-major
    order, so padding placed after the live tokens (as the engine's packs
    and buckets place it) can only take slots the live tokens left over."""
    m = cfg.moe
    T = x_flat.shape[0]
    E, k = m.n_routed, m.top_k
    C = _capacity(T, cfg)
    probs, top_p, top_e = _route(x_flat, router, k)
    loss = None
    if aux:  # the serving paths drop it, as XLA drops the JAX package's dead aux
        frac = torch.bincount(top_e.reshape(-1), minlength=E).float() / (T * k)
        loss = E * torch.sum(frac * probs.mean(dim=0))

    flat_e = top_e.reshape(-1)  # [T*k], token-major
    onehot = F.one_hot(flat_e, E)  # [T*k, E]
    pos = onehot.cumsum(0) - onehot  # exclusive
    slot = (pos * onehot).sum(-1)
    keep = slot < C
    # kept entries fill distinct cells of the [E * C] tables; dropped ones go
    # to a trash cell at E * C that is cut off
    idx = torch.where(keep, flat_e * C + slot, E * C)
    flat_t = torch.arange(T * k, device=x_flat.device) // k
    n = E * C + 1
    slot_tok = torch.zeros(n, dtype=torch.int64, device=x_flat.device).scatter_(0, idx, flat_t)
    slot_w = torch.zeros(n, dtype=torch.float32, device=x_flat.device).scatter_(
        0, idx, torch.where(keep, top_p.reshape(-1), 0.0))
    slot_valid = torch.zeros(n, dtype=torch.bool, device=x_flat.device).scatter_(0, idx, keep)
    return Dispatch(slot_tok[:-1].view(E, C), slot_w[:-1].view(E, C),
                    slot_valid[:-1].view(E, C), idx.view(T, k), keep.view(T, k), loss)


def _experts(x_flat: torch.Tensor, w_in, w_gate, w_out, disp: Dispatch) -> torch.Tensor:
    """The routed experts over their slots, combined per token: [T, d] f32.

    Rounding follows the JAX package op for op: h and g are products in the
    model dtype, SiLU runs in f32 and is cast back, h * silu(g) is in the
    model dtype, ``slot_w * valid`` is cast to y's dtype before it scales y,
    and the combine sums in f32. The combine is deterministic: each token
    gathers its <= k kept rows through ``inv`` (a zero row for a dropped
    entry) and sums them in a fixed order, where a scatter-add
    (``index_add_``) would add with atomics on the card in an order that
    changes from run to run."""
    d = x_flat.shape[-1]
    xg = x_flat[disp.slot_tok] * disp.slot_valid[..., None].to(x_flat.dtype)  # [E, C, d]
    h = torch.bmm(xg, w_in)
    g = torch.bmm(xg, w_gate)
    h = h * F.silu(g.float()).to(h.dtype)
    y = torch.bmm(h, w_out)  # [E, C, d]
    y = y * (disp.slot_w * disp.slot_valid)[..., None].to(y.dtype)
    rows = torch.cat([y.reshape(-1, d), y.new_zeros(1, d)])  # the trash row: zeros
    return rows[disp.inv].float().sum(dim=1)  # [T, k, d] -> [T, d]


def moe_apply(params: Params, cfg: ArchConfig, x: torch.Tensor, *,
              aux: bool = True) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Routed experts (+ shared experts) over an activation tensor [..., d]:
    every token of it is routed in one call. Returns (out [..., d] in x's
    dtype, the aux loss, or None with ``aux=False``)."""
    d = x.shape[-1]
    x_flat = x.reshape(-1, d)
    # int8 expert stacks widen at entry (a per-layer transient); dense
    # stacks pass through untouched; the router is never quantized
    w_in = qweight(params["w_in"], x.dtype)
    w_gate = qweight(params["w_gate"], x.dtype)
    w_out = qweight(params["w_out"], x.dtype)
    disp = moe_dispatch(params["router"], cfg, x_flat, aux=aux)
    out = _experts(x_flat, w_in, w_gate, w_out, disp).to(x.dtype).reshape(x.shape)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], x)
    return out, disp.aux


def moe_reference_dense(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Oracle: every expert for every token, mixed by the renormalised top-k
    weights — no capacity drops."""
    m = cfg.moe
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    probs, top_p, top_e = _route(xf, params["router"], m.top_k)
    w = torch.zeros_like(probs).scatter_(1, top_e, top_p)
    h = torch.einsum("td,edf->tef", xf, params["w_in"])
    g = torch.einsum("td,edf->tef", xf, params["w_gate"])
    h = h * F.silu(g.float()).to(h.dtype)
    y = torch.einsum("tef,efd->ted", h, params["w_out"])
    out = torch.einsum("ted,te->td", y.float(), w).to(x.dtype).reshape(x.shape)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], x)
    return out
