"""Exact analytic FLOP / HBM-byte / collective-byte accounting per cell
(a copy of ``repro/roofline/flops.py``: arithmetic on configs, independent
of the hardware, kept equal to the JAX package's by the port's tests).

Why analytic: XLA's cost model counts scan bodies once (see analysis.py), so
for scanned-layer models the compiled numbers undercount by ~n_layers. We
control every einsum in the model, so exact counting is feasible and is the
primary roofline source; the compiled artifact numbers are the cross-check.

Conventions:
* FLOPs: matmul [m,k]@[k,n] = 2mkn. Vector ops (rope, norms, gates) are
  counted with small explicit constants — they matter for SSMs.
* Causal attention scores/AV over a full sequence use the exact ½S(S+1)
  average context.
* Train multipliers, applied to block-level (scanned+rematted) content:
  fwd 1× + recompute 1× + bwd 2× = 4×; embedding/head get 3× (not rematted).
* HBM bytes use a documented approximate traffic model (weights ×reads ×DP
  replication; activation boundaries with remat; optimizer f32 moments;
  decode = params + cache sweep). Good to ±30% — enough to rank terms.
* Collective bytes are GLOBAL wire bytes/step: ring all-reduce of payload P
  over an axis of size n costs 2·P·(n-1) summed over the group.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeConfig

ACT_BYTES = 2  # bf16 activations
GRAD_BYTES = 2  # bf16 grads on the wire
OPT_BYTES = 4  # f32 moments


@dataclass
class CellCounts:
    flops: float  # global FLOPs / step
    hbm_bytes: float  # global HBM bytes / step
    coll_bytes: float  # global wire bytes / step
    model_flops: float  # 6·N(_active)·tokens  (training) or 2·N·tokens (inference)


def _ar_bytes(payload: float, axis: int, groups: int = 1) -> float:
    """Global ring all-reduce wire bytes for `groups` groups of size `axis`."""
    if axis <= 1:
        return 0.0
    return 2.0 * payload * (axis - 1) * groups


# ---------------------------------------------------------------------------
# per-token forward FLOPs, split into (block_flops, edge_flops)
# ---------------------------------------------------------------------------


def _attn_proj_flops(cfg: ArchConfig) -> float:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.nope_head_dim + m.rope_head_dim
        q = (
            2 * d * m.q_lora_rank + 2 * m.q_lora_rank * H * qk
            if m.q_lora_rank
            else 2 * d * H * qk
        )
        kv = 2 * d * (m.kv_lora_rank + m.rope_head_dim) + 2 * m.kv_lora_rank * H * (
            m.nope_head_dim + m.v_head_dim
        )
        o = 2 * H * m.v_head_dim * d
        return q + kv + o
    return 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d


def _attn_ctx_flops(cfg: ArchConfig, ctx: float) -> float:
    """scores + AV per query token against `ctx` context tokens."""
    H = cfg.n_heads
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.nope_head_dim + m.rope_head_dim
        return 2 * ctx * H * (qk + m.v_head_dim)
    return 2 * ctx * H * cfg.head_dim * 2


def _mla_absorbed_ctx_flops(cfg: ArchConfig, ctx: float) -> float:
    """Absorbed-form decode: latent-space scores/AV + absorb matmuls."""
    m = cfg.mla
    H = cfg.n_heads
    absorb = 2 * H * m.nope_head_dim * m.kv_lora_rank + 2 * H * m.kv_lora_rank * m.v_head_dim
    scores = 2 * ctx * H * (m.kv_lora_rank + m.rope_head_dim)
    av = 2 * ctx * H * m.kv_lora_rank
    return absorb + scores + av


def _ffn_flops(cfg: ArchConfig) -> float:
    """Per-token FFN flops for the *repeated* (scanned) layer type."""
    d = cfg.d_model
    if cfg.family == "moe":
        m = cfg.moe
        ff = m.expert_ff or cfg.d_ff
        return 2 * d * m.n_routed + m.top_k * 6 * d * ff + 6 * d * (m.n_shared * ff)
    return 6 * d * cfg.d_ff


def _mamba1_flops(cfg: ArchConfig) -> float:
    d = cfg.d_model
    s = cfg.ssm
    di = s.expand * d
    dtr = max(d // 16, 1)
    N = s.state
    proj = 2 * d * 2 * di + 2 * s.conv_kernel * di + 2 * di * (dtr + 2 * N) + 2 * dtr * di + 2 * di * d
    # associative scan ≈ 2× sequential work (4 flops/elem state update) + exp
    scan = 2 * (6 * di * N) + 2 * di * N  # update + y=C·h
    gates = 8 * di
    return proj + scan + gates


def _mamba2_flops(cfg: ArchConfig) -> float:
    d = cfg.d_model
    s = cfg.ssm
    di = s.expand * d
    nh = di // s.head_dim
    G, N, Q = s.n_groups, s.state, s.chunk
    conv_dim = di + 2 * G * N
    proj = 2 * d * (2 * di + 2 * G * N + nh) + 2 * s.conv_kernel * conv_dim + 2 * di * d
    # SSD per token: CBᵀ (2QN/head), M@X (2Q·hd/head), state upd + inter (4N·hd/head)
    ssd = nh * (2 * Q * N + 2 * Q * s.head_dim + 4 * N * s.head_dim)
    gates = 10 * di
    return proj + ssd + gates


def _block_fwd_flops_per_token(cfg: ArchConfig, ctx: float, decode: bool) -> float:
    """Per-token forward FLOPs of the full scanned stack (all L layers)."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        per = _mamba1_flops(cfg) if cfg.ssm.variant == "mamba1" else _mamba2_flops(cfg)
        return L * per
    if cfg.family == "hybrid":
        per = _mamba2_flops(cfg) * L
        n_inv = L // cfg.shared_attn_every
        attn = _attn_proj_flops(cfg) + (
            _attn_ctx_flops(cfg, ctx)
        ) + 6 * cfg.d_model * cfg.d_ff
        return per + n_inv * attn
    # dense / moe
    if decode and cfg.mla is not None:
        attn = (
            (2 * cfg.d_model * cfg.mla.q_lora_rank
             + 2 * cfg.mla.q_lora_rank * cfg.n_heads * (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim))
            if cfg.mla.q_lora_rank
            else 2 * cfg.d_model * cfg.n_heads * (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)
        )
        attn += 2 * cfg.d_model * (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
        attn += _mla_absorbed_ctx_flops(cfg, ctx)
        attn += 2 * cfg.n_heads * cfg.mla.v_head_dim * cfg.d_model
    else:
        attn = _attn_proj_flops(cfg) + _attn_ctx_flops(cfg, ctx)
    ffn = _ffn_flops(cfg)
    flops = L * (attn + ffn)
    if cfg.family == "moe" and cfg.first_k_dense:
        dff = cfg.dense_ff or cfg.d_ff
        flops += cfg.first_k_dense * ((6 * cfg.d_model * dff) - _ffn_flops(cfg))
    return flops


def _edge_fwd_flops_per_token(cfg: ArchConfig) -> float:
    return 2 * cfg.d_model * cfg.vocab_size  # unembed matmul (embed is a gather)


# ---------------------------------------------------------------------------
# HBM traffic model
# ---------------------------------------------------------------------------


def _param_bytes(cfg: ArchConfig) -> float:
    return cfg.num_params() * ACT_BYTES


def _act_width(cfg: ArchConfig) -> float:
    """Approx per-token activation stream width (elements) per layer."""
    d = cfg.d_model
    if cfg.family == "ssm":
        di = cfg.ssm.expand * d
        return 4 * d + 6 * di
    if cfg.family == "hybrid":
        di = cfg.ssm.expand * d
        return 4 * d + 6 * di + (2 * cfg.d_ff + 2 * cfg.n_heads * cfg.head_dim) / cfg.shared_attn_every
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.family == "moe":
        m = cfg.moe
        ff_eff = (m.top_k + m.n_shared) * (m.expert_ff or cfg.d_ff)
    else:
        ff_eff = cfg.d_ff
    return 4 * d + 2 * ff_eff + 2 * (H + KV) * hd


def _cache_width(cfg: ArchConfig) -> float:
    """Per-token decode-cache width in elements (KV / latent / none)."""
    if cfg.mla is not None:
        return cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
    if cfg.family == "ssm":
        return 0.0  # O(1) state, counted separately
    if cfg.family == "hybrid":
        n_inv = cfg.n_layers // cfg.shared_attn_every
        return n_inv / cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim
    return 2 * cfg.n_kv_heads * cfg.head_dim


def _ssm_state_bytes(cfg: ArchConfig, batch: int) -> float:
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    s = cfg.ssm
    di = s.expand * cfg.d_model
    if s.variant == "mamba1":
        per = di * s.state * 4 + (s.conv_kernel - 1) * di * ACT_BYTES
    else:
        nh = di // s.head_dim
        per = nh * s.head_dim * s.state * 4 + (s.conv_kernel - 1) * (
            di + 2 * s.n_groups * s.state
        ) * ACT_BYTES
    return cfg.n_layers * batch * per


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------


def count_cell(
    cfg: ArchConfig,
    shape: ShapeConfig,
    *,
    dp: int,
    tp: int,
    zero: str = "none",  # 'none' | 'zero1' | 'zero3'
) -> CellCounts:
    """Global per-step counts for one (arch × shape) on a dp×tp fabric.

    ``zero1``: post-update parameter all-gather (sharded optimizer).
    ``zero3``: additionally 3 passes of per-layer parameter gathers
    (fwd / remat-recompute / bwd) — weights stored fabric-sharded."""
    B, S = shape.global_batch, shape.seq_len
    L = cfg.n_layers
    d = cfg.d_model
    n_params = cfg.num_params()
    n_active = cfg.num_active_params()

    if shape.kind in ("train", "prefill"):
        tokens = B * S
        ctx = (S + 1) / 2.0  # causal average context
        fwd_block = _block_fwd_flops_per_token(cfg, ctx, decode=False) * tokens
        fwd_edge = _edge_fwd_flops_per_token(cfg) * tokens
        if shape.kind == "train":
            flops = 4.0 * fwd_block + 3.0 * fwd_edge  # fwd+remat+bwd / fwd+bwd
            model_flops = 6.0 * n_active * tokens
        else:
            flops = fwd_block + fwd_edge
            model_flops = 2.0 * n_active * tokens

        # HBM: weights ×reads ×DP-replication + activations + optimizer
        reads = 3 if shape.kind == "train" else 1
        w_traffic = _param_bytes(cfg) * reads * dp
        act = tokens * _act_width(cfg) * L / max(L, 1)  # per layer width
        act_traffic = tokens * _act_width(cfg) * L * (
            1.0 if shape.kind == "prefill" else 2.5  # fwd w / +bwd r + remat rw
        ) * ACT_BYTES / 1.0
        opt_traffic = (
            n_params * (2 * GRAD_BYTES + 6 * OPT_BYTES) if shape.kind == "train" else 0.0
        )
        hbm = w_traffic + act_traffic + opt_traffic

        # collectives: TP ARs per layer + DP grads. Dense blocks: 2 ARs fwd
        # (attn out + mlp out) ×3 passes for train (fwd/bwd/remat-recompute).
        # SSM blocks: ONE AR per block (in_proj column-sharded feeds
        # out_proj row-sharded directly) — the first 6-AR estimate was
        # refuted by the loop-corrected HLO measurement
        # (the JAX package's roofline/hlo_loops.py, zamba2 cell).
        ar_payload = (B / dp) * S * d * ACT_BYTES
        passes = 3 if shape.kind == "train" else 1
        if cfg.family in ("ssm", "hybrid"):
            n_ar_layer = 1 * passes
        else:
            n_ar_layer = 2 * passes
        coll = _ar_bytes(ar_payload, tp, groups=dp) * n_ar_layer * L / 2.0
        if cfg.family == "hybrid":
            # shared attention+MLP block every k layers: 2 ARs × passes
            coll += _ar_bytes(ar_payload, tp, groups=dp) * (
                2 * passes * (L // cfg.shared_attn_every)
            ) / 2.0
        if cfg.family == "moe":
            # EP psum of bf16 [T,d] per moe layer (fwd+bwd+remat)
            psum_payload = (B / dp) * S * d * ACT_BYTES
            n_moe = L - cfg.first_k_dense
            coll += _ar_bytes(psum_payload, tp, groups=dp) * (
                3 if shape.kind == "train" else 1
            ) * n_moe / 2.0
        if shape.kind == "train":
            coll += _ar_bytes(n_params / tp * GRAD_BYTES, dp, groups=tp)
            if zero in ("zero1", "zero3"):  # AG of the shard-updated params
                coll += n_params * ACT_BYTES * (dp - 1)
            if zero == "zero3":  # fwd + remat + bwd per-layer weight gathers
                coll += 3 * n_params * ACT_BYTES * (dp - 1) / dp * dp
        return CellCounts(flops, hbm, coll, model_flops)

    # ---------------- decode ----------------
    tokens = B  # one token per sequence per step
    ctx = float(S)
    fwd_block = _block_fwd_flops_per_token(cfg, ctx, decode=True) * tokens
    fwd_edge = _edge_fwd_flops_per_token(cfg) * tokens
    flops = fwd_block + fwd_edge
    model_flops = 2.0 * n_active * tokens

    # HBM: full param sweep ×DP + cache read (context) + state rw
    w_traffic = _param_bytes(cfg) * dp
    cache_read = B * ctx * _cache_width(cfg) * L * ACT_BYTES
    state_rw = 2 * _ssm_state_bytes(cfg, B)
    hbm = w_traffic + cache_read + state_rw

    ar_payload = (B / dp) * 1 * d * ACT_BYTES
    coll = _ar_bytes(ar_payload, tp, groups=dp) * 2 * L / 2.0
    if cfg.family == "moe":
        coll += _ar_bytes((B / dp) * d * ACT_BYTES, tp, groups=dp) * (
            L - cfg.first_k_dense
        ) / 2.0
    return CellCounts(flops, hbm, coll, model_flops)
