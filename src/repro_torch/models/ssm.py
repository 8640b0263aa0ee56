"""State-space blocks: Mamba1 (selective scan) and Mamba2 (SSD, chunked)
(counterparts of ``repro/models/ssm.py``).

The JAX package computes every piece here in plain jnp, with no Pallas
kernel, so these are plain torch ops on the card too. Each block has a
full-sequence form (``mamba{1,2}_apply``, prefill), a one-token form against
its O(1) state (``mamba{1,2}_decode``) and a state-passing chunk of one
slot's stream (``mamba{1,2}_packed``, the engine's packs).

* **Mamba1**: the chunked selective scan. An outer loop over sequence chunks
  carries the [B, d_in, N] state; inside a chunk a log-step (Hillis-Steele)
  doubling scan with the JAX package's ``combine`` replaces
  ``jax.lax.associative_scan``. The discretized [B, Q, d_in, N] tensors
  exist for one chunk at a time, never for the whole sequence.
* **Mamba2 (SSD)**: the chunked block-matrix form, intra-chunk [B, H, Q, Q]
  score blocks plus an inter-chunk state recurrence.

Params are the JAX package's leaves (``in_proj``, ``conv_w``, ``conv_b``,
``x_proj``/``dt_proj`` or ``norm_w``, ``dt_bias``, ``A_log``, ``D``,
``out_proj``); a state cache is ``{"h": f32 state, "conv": the last K-1
pre-conv rows in the model dtype}``. Functions return a new cache dict and
leave the one passed in untouched (the model writes it back).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import Params, dense_init, rms_norm

# ---------------------------------------------------------------------------
# shared: causal depthwise conv1d
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: [B, S, C]; w: [K, C] depthwise; left-padded causal conv, the taps
    summed in f32 in order and cast back to x's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i: i + s].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def conv_step(state: torch.Tensor, xt: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Single-token conv: state [B, K-1, C] holds the last K-1 inputs, xt
    [B, C]. Returns (y [B, C], new_state [B, K-1, C])."""
    full = torch.cat([state.to(xt.dtype), xt[:, None]], dim=1)  # [B, K, C]
    y = torch.einsum("bkc,kc->bc", full.float(), w.float())
    return (y + b.float()).to(xt.dtype), full[:, 1:]


def _conv_carried(x_pre: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, n_real: Union[int, torch.Tensor]):
    """Causal conv over a chunk with a carried cross-chunk tail.

    x_pre: [B, S, C], the first ``n_real`` rows real and the rest bucket
    padding after them; conv_state: [B, K-1, C] the slot's last K-1 real
    pre-conv rows (zeros for a fresh sequence: the left-zero-padded conv).
    Returns (x_c [B, S, C], new_state [B, K-1, C] = the last K-1 REAL rows:
    the window is sliced at ``n_real``, a device scalar, so padding never
    enters a later window and the host never waits for the device)."""
    k = w.shape[0]
    x_ext = torch.cat([conv_state.to(x_pre.dtype), x_pre], dim=1)
    x_c = causal_conv1d(x_ext, w, b)[:, k - 1:]
    idx = torch.arange(k - 1, device=x_ext.device) + n_real
    return x_c, x_ext.index_select(1, idx)


def _conv_tail(x_pre: torch.Tensor, k: int) -> torch.Tensor:
    """The last K-1 pre-conv rows of a full sequence, left-padded with zeros
    when it is shorter (a prefill's conv state)."""
    s = x_pre.shape[1]
    if s >= k - 1:
        return x_pre[:, s - (k - 1):]
    return F.pad(x_pre, (0, 0, k - 1 - s, 0))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _chunk_len(cfg: ArchConfig, s: int) -> int:
    """The scan chunk: ``cfg.ssm.chunk``, or the whole sequence where that
    does not divide it."""
    chunk = min(cfg.ssm.chunk, s)
    return s if s % chunk else chunk


def _dt_mask(dt: torch.Tensor, n_real: Union[int, torch.Tensor]) -> torch.Tensor:
    """dt [B, S, ...] with rows at or past ``n_real`` set to 0: a padding row
    is then an exact state identity (exp(0·A) = 1, 0·B·x = 0)."""
    real = torch.arange(dt.shape[1], device=dt.device) < n_real
    return torch.where(real.view(1, -1, *([1] * (dt.ndim - 2))), dt, 0.0)


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------


def _uniform(shape, lo: float, hi: float, generator: torch.Generator, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        lo, hi, generator=generator)


def _dt_bias(shape, generator: torch.Generator, device) -> torch.Tensor:
    """softplus^-1 of U(1e-3, 1e-1), as the JAX package draws it."""
    return torch.log(torch.exp(_uniform(shape, 1e-3, 1e-1, generator, device)) - 1.0)


def mamba1_init(cfg: ArchConfig, generator: torch.Generator, dtype, device, n: int) -> Params:
    """``n`` Mamba1 blocks' params stacked [n, ...], the JAX package's
    leaves, shapes and scales."""
    s, d = cfg.ssm, cfg.d_model
    d_in = s.expand * d
    dt_rank = max(d // 16, 1)
    a = torch.arange(1, s.state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init((n, d, 2 * d_in), generator, dtype, device, fan_in=d),
        "conv_w": dense_init((n, s.conv_kernel, d_in), generator, dtype, device,
                             fan_in=s.conv_kernel),
        "conv_b": torch.zeros((n, d_in), dtype=dtype, device=device),
        "x_proj": dense_init((n, d_in, dt_rank + 2 * s.state), generator, dtype, device,
                             fan_in=d_in),
        "dt_proj": dense_init((n, dt_rank, d_in), generator, dtype, device, fan_in=dt_rank),
        "dt_bias": _dt_bias((n, d_in), generator, device),
        "A_log": torch.log(a).expand(n, d_in, s.state).contiguous(),
        "D": torch.ones((n, d_in), dtype=torch.float32, device=device),
        "out_proj": dense_init((n, d_in, d), generator, dtype, device, fan_in=d_in),
    }


def _selective_scan_chunked(
    x_c: torch.Tensor,  # [B, S, d_in] (post-conv, post-silu input)
    dt: torch.Tensor,  # [B, S, d_in] f32 (softplus'ed)
    A: torch.Tensor,  # [d_in, N] f32 (negative)
    Bm: torch.Tensor,  # [B, S, N] f32
    C: torch.Tensor,  # [B, S, N] f32
    h0: torch.Tensor,  # [B, d_in, N] f32
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """y[b,s,d] = Σ_n h[b,s,d,n]·C[b,s,n] with h_s = exp(dt_s A)·h_{s-1} + dt_s B_s x_s.

    An outer loop over chunks carries h; inside a chunk a doubling scan of
    (dA, dBx) pairs under ``combine(l, r) = (al·ar, bl·ar + br)`` gives the
    products and sums from the chunk's start, then h_t = acum_t·h + bacc_t.
    Returns (y [B, S, d_in] f32, h_final [B, d_in, N])."""
    b, s, d_in = x_c.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    h = h0
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        dtq = dt[:, sl, :, None]
        acc = torch.exp(dtq * A)  # [B, Q, d_in, N]
        bac = dtq * Bm[:, sl, None, :] * x_c[:, sl, :, None].float()
        off = 1
        while off < chunk:  # Hillis-Steele: position t folds in t - off
            bac = torch.cat([bac[:, :off], bac[:, :-off] * acc[:, off:] + bac[:, off:]], dim=1)
            acc = torch.cat([acc[:, :off], acc[:, :-off] * acc[:, off:]], dim=1)
            off *= 2
        hs = acc * h[:, None] + bac  # [B, Q, d_in, N]
        ys.append(torch.einsum("bqdn,bqn->bqd", hs, C[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def _mamba1_inner(params: Params, cfg: ArchConfig, x: torch.Tensor, h0: torch.Tensor,
                  conv_state: Optional[torch.Tensor], n_real):
    """The Mamba1 block over a chunk [B, S, d]: from the zero state with a
    plain causal conv (``conv_state`` None), or carried from ``(h0,
    conv_state)`` with the rows past ``n_real`` as identities. Returns (out,
    h_final, x_in (pre-conv), new_conv_state or None)."""
    s_cfg = cfg.ssm
    d = x.shape[-1]
    dt_rank, N = max(d // 16, 1), s_cfg.state
    x_in, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    new_conv = None
    if conv_state is None:
        x_c = causal_conv1d(x_in, params["conv_w"], params["conv_b"])
    else:
        x_c, new_conv = _conv_carried(x_in, conv_state, params["conv_w"], params["conv_b"],
                                      n_real)
    x_c = F.silu(x_c.float()).to(x.dtype)
    dt_r, Bm, Cm = (x_c @ params["x_proj"]).split([dt_rank, N, N], dim=-1)
    dt = _softplus((dt_r @ params["dt_proj"]).float() + params["dt_bias"])  # [B, S, d_in]
    if conv_state is not None:
        dt = _dt_mask(dt, n_real)
    A = -torch.exp(params["A_log"])  # [d_in, N]
    y, h_final = _selective_scan_chunked(x_c, dt, A, Bm.float(), Cm.float(), h0,
                                         _chunk_len(cfg, x.shape[1]))
    y = y + params["D"] * x_c.float()
    y = y * F.silu(z.float())
    return y.to(x.dtype) @ params["out_proj"], h_final, x_in, new_conv


def mamba1_apply(params: Params, cfg: ArchConfig, x: torch.Tensor, *,
                 return_state: bool = False):
    """Full-sequence Mamba1 block. x: [B, S, d] -> [B, S, d]. With
    ``return_state`` also the decode cache {'h', 'conv'} after the last
    token (prefill into the cache)."""
    b, _, d = x.shape
    h0 = torch.zeros((b, cfg.ssm.expand * d, cfg.ssm.state), dtype=torch.float32,
                     device=x.device)
    out, h, x_in, _ = _mamba1_inner(params, cfg, x, h0, None, None)
    if return_state:
        return out, {"h": h, "conv": _conv_tail(x_in, cfg.ssm.conv_kernel).to(x.dtype)}
    return out


def mamba1_init_cache(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {
        "h": torch.zeros((batch, d_in, s.state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_kernel - 1, d_in), dtype=dtype, device=device),
    }


def mamba1_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                  cache: Params) -> tuple[torch.Tensor, Params]:
    """One token. x: [B, 1, d]. Returns (out [B, 1, d], new cache)."""
    d = x.shape[-1]
    dt_rank, N = max(d // 16, 1), cfg.ssm.state
    x_in, z = (x[:, 0] @ params["in_proj"]).chunk(2, dim=-1)  # [B, d_in]
    x_c, conv_state = conv_step(cache["conv"], x_in, params["conv_w"], params["conv_b"])
    x_c = F.silu(x_c.float()).to(x.dtype)
    dt_r, Bm, Cm = (x_c @ params["x_proj"]).split([dt_rank, N, N], dim=-1)
    dt = _softplus((dt_r @ params["dt_proj"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[..., None] * A)  # [B, d_in, N]
    dBx = dt[..., None] * Bm[:, None, :].float() * x_c[..., None].float()
    h = dA * cache["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm.float())
    y = y + params["D"] * x_c.float()
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ params["out_proj"]
    return out[:, None], {"h": h, "conv": conv_state}


def mamba1_packed(params: Params, cfg: ArchConfig, x: torch.Tensor, cache: Params,
                  n_real: Union[int, torch.Tensor]) -> tuple[torch.Tensor, Params]:
    """A state-passing chunk: ONE slot's contiguous prompt chunk (bucket
    padding after the ``n_real`` real rows) through the chunked scan,
    carrying the decode cache {'h', 'conv'} in and out. x: [B, S, d].
    Padding rows are exact state identities (dt forced to 0), so the new
    state is the state after the real rows; their outputs are garbage the
    caller never samples."""
    out, h, _, conv = _mamba1_inner(params, cfg, x, cache["h"], cache["conv"], n_real)
    return out, {"h": h, "conv": conv.to(cache["conv"].dtype)}


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_init(cfg: ArchConfig, generator: torch.Generator, dtype, device, n: int) -> Params:
    """``n`` Mamba2 blocks' params stacked [n, ...], the JAX package's
    leaves, shapes and scales."""
    s, d = cfg.ssm, cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state
    return {
        "in_proj": dense_init((n, d, 2 * d_in + 2 * s.n_groups * s.state + nh), generator,
                              dtype, device, fan_in=d),
        "conv_w": dense_init((n, s.conv_kernel, conv_dim), generator, dtype, device,
                             fan_in=s.conv_kernel),
        "conv_b": torch.zeros((n, conv_dim), dtype=dtype, device=device),
        "A_log": torch.log(_uniform((n, nh), 1.0, 16.0, generator, device)),
        "D": torch.ones((n, nh), dtype=torch.float32, device=device),
        "dt_bias": _dt_bias((n, nh), generator, device),
        "norm_w": torch.ones((n, d_in), dtype=dtype, device=device),
        "out_proj": dense_init((n, d_in, d), generator, dtype, device, fan_in=d_in),
    }


def _ssd_chunked(
    xh: torch.Tensor,  # [B, S, H, P] head-split inputs
    dt: torch.Tensor,  # [B, S, H] f32 (softplus'ed)
    A: torch.Tensor,  # [H] f32 (negative)
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    chunk: int,
    state0: Optional[torch.Tensor] = None,  # [B, H, P, N] carried-in state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: y[s] = Σ_{t<=s} C_s·B_t · exp(Σ_{j∈(t,s]} dt_j A) · dt_t · x_t.

    Returns (y [B, S, H, P] f32, final_state [B, H, P, N]). The G groups
    broadcast to the H heads; ``state0`` carries a previous chunk's state in
    (None: zeros)."""
    b, s, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    rep = h // g
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if state0 is None else state0.float())
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device).tril()
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        xq, dtq = xh[:, sl].float(), dt[:, sl]
        bq = Bm[:, sl].float().repeat_interleave(rep, dim=2)  # [B, Q, H, N]
        cq = Cm[:, sl].float().repeat_interleave(rep, dim=2)
        cum = torch.cumsum(dtq * A, dim=1)  # [B, Q, H] inclusive log-decay
        cb = torch.einsum("bqhn,bthn->bhqt", cq, bq)  # [B, H, Q, Q]
        cum_t = cum.transpose(1, 2)  # [B, H, Q]
        decay = torch.exp(cum_t[:, :, :, None] - cum_t[:, :, None, :])
        m = torch.where(causal, cb * decay, 0.0) * dtq.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhqt,bthp->bqhp", m, xq)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", cq * torch.exp(cum)[..., None], state)
        seg = torch.exp(cum[:, -1:] - cum) * dtq  # [B, Q, H]
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bqhn,bqhp,bqh->bhpn", bq, xq, seg)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), state


def _mamba2_split(cfg: ArchConfig, zxbcdt: torch.Tensor):
    d_in = cfg.ssm.expand * cfg.d_model
    gn = cfg.ssm.n_groups * cfg.ssm.state
    return zxbcdt.split([d_in, d_in + 2 * gn, zxbcdt.shape[-1] - 2 * d_in - 2 * gn], dim=-1)


def _mamba2_inner(params: Params, cfg: ArchConfig, x: torch.Tensor,
                  state0: Optional[torch.Tensor], conv_state: Optional[torch.Tensor], n_real):
    """The Mamba2 block over a chunk [B, S, d], as :func:`_mamba1_inner`.
    Returns (out, final state, xBC (pre-conv), new_conv_state or None)."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    d_in = s_cfg.expand * d
    nh, G, N = d_in // s_cfg.head_dim, s_cfg.n_groups, s_cfg.state
    z, xbc_raw, dt = _mamba2_split(cfg, x @ params["in_proj"])
    new_conv = None
    if conv_state is None:
        xbc = causal_conv1d(xbc_raw, params["conv_w"], params["conv_b"])
    else:
        xbc, new_conv = _conv_carried(xbc_raw, conv_state, params["conv_w"],
                                      params["conv_b"], n_real)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xs, Bm, Cm = xbc.split([d_in, G * N, G * N], dim=-1)
    xh = xs.reshape(b, s, nh, s_cfg.head_dim)
    dt = _softplus(dt.float() + params["dt_bias"])  # [B, S, H]
    if conv_state is not None:
        dt = _dt_mask(dt, n_real)
    A = -torch.exp(params["A_log"])  # [H]
    y, state = _ssd_chunked(xh, dt, A, Bm.reshape(b, s, G, N), Cm.reshape(b, s, G, N),
                            _chunk_len(cfg, s), state0)
    y = y + params["D"][:, None] * xh.float()
    y = y.reshape(b, s, d_in) * F.silu(z.float())  # gated RMSNorm: norm(y * silu(z))
    y = rms_norm(y.to(x.dtype), params["norm_w"], cfg.norm_eps)
    return y @ params["out_proj"], state, xbc_raw, new_conv


def mamba2_apply(params: Params, cfg: ArchConfig, x: torch.Tensor, *,
                 return_state: bool = False):
    """Full-sequence Mamba2 block. x: [B, S, d] -> [B, S, d]. With
    ``return_state`` also the decode cache {'h', 'conv'}."""
    out, state, xbc_raw, _ = _mamba2_inner(params, cfg, x, None, None, None)
    if return_state:
        return out, {"h": state,
                     "conv": _conv_tail(xbc_raw, cfg.ssm.conv_kernel).to(x.dtype)}
    return out


def mamba2_init_cache(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    conv_dim = d_in + 2 * s.n_groups * s.state
    return {
        "h": torch.zeros((batch, d_in // s.head_dim, s.head_dim, s.state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim), dtype=dtype, device=device),
    }


def mamba2_decode(params: Params, cfg: ArchConfig, x: torch.Tensor,
                  cache: Params) -> tuple[torch.Tensor, Params]:
    """One token. x: [B, 1, d]. Returns (out [B, 1, d], new cache)."""
    s_cfg = cfg.ssm
    b, _, d = x.shape
    d_in = s_cfg.expand * d
    nh, G, N = d_in // s_cfg.head_dim, s_cfg.n_groups, s_cfg.state
    z, xbc, dt = _mamba2_split(cfg, x[:, 0] @ params["in_proj"])
    xbc, conv_state = conv_step(cache["conv"], xbc, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc.float()).to(x.dtype)
    xs, Bm, Cm = xbc.split([d_in, G * N, G * N], dim=-1)
    xh = xs.reshape(b, nh, s_cfg.head_dim).float()
    dt = _softplus(dt.float() + params["dt_bias"])  # [B, H]
    a = torch.exp(dt * -torch.exp(params["A_log"]))  # [B, H]
    Bm = Bm.reshape(b, G, N).float().repeat_interleave(nh // G, dim=1)  # [B, H, N]
    Cm = Cm.reshape(b, G, N).float().repeat_interleave(nh // G, dim=1)
    h = cache["h"] * a[..., None, None] + torch.einsum("bhn,bhp,bh->bhpn", Bm, xh, dt)
    y = torch.einsum("bhpn,bhn->bhp", h, Cm)
    y = (y + params["D"][:, None] * xh).reshape(b, d_in)
    y = y * F.silu(z.float())
    y = rms_norm(y.to(x.dtype), params["norm_w"], cfg.norm_eps)
    return (y @ params["out_proj"])[:, None], {"h": h, "conv": conv_state}


def mamba2_packed(params: Params, cfg: ArchConfig, x: torch.Tensor, cache: Params,
                  n_real: Union[int, torch.Tensor]) -> tuple[torch.Tensor, Params]:
    """The state-passing chunk of :func:`mamba1_packed` for Mamba2/SSD: one
    slot's contiguous chunk, the first ``n_real`` rows real, dt-masked
    padding rows exact state identities."""
    out, state, _, conv = _mamba2_inner(params, cfg, x, cache["h"], cache["conv"], n_real)
    return out, {"h": state, "conv": conv.to(cache["conv"].dtype)}


class Block(NamedTuple):
    """The five forms of one Mamba variant."""

    init: Callable
    apply: Callable
    init_cache: Callable
    decode: Callable
    packed: Callable


def block_fns(cfg: ArchConfig) -> Block:
    """The forms of the config's variant (``cfg.ssm.variant``)."""
    if cfg.ssm.variant == "mamba1":
        return Block(mamba1_init, mamba1_apply, mamba1_init_cache, mamba1_decode, mamba1_packed)
    return Block(mamba2_init, mamba2_apply, mamba2_init_cache, mamba2_decode, mamba2_packed)
