"""Architecture configs for the PyTorch port: a frozen dataclass + a registry
keyed by arch id.

A copy of the architecture part of ``repro.configs.base`` with the MLA,
MoE and SSM sub-configs (the port imports nothing of the JAX package). All
four families are ported: dense and moe, each with or without multi-head
latent attention (``mla``), ssm (a Mamba1 stack) and hybrid (a Mamba2 stack
with one weight-tied attention + MLP block every ``shared_attn_every``
layers). ``reduced()``, ``num_params()`` and ``num_active_params()`` keep
the JAX package's rules, which is what lets the tests hand the same reduced
config to both packages. The runtime knobs ``attn_impl``, ``attn_chunk`` and
``remat`` are the JAX package's too (the training forward reads them); so
are the input-shape cells (:class:`ShapeConfig` in :data:`SHAPES`, with
``applicable`` and ``all_cells``) and the training hyperparameters
(:class:`TrainConfig`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (DeepSeek/Llama4-style)."""

    n_routed: int  # number of routed experts
    top_k: int  # experts per token
    n_shared: int = 0  # always-on shared experts
    expert_ff: int = 0  # hidden width of each routed/shared expert
    capacity_factor: float = 1.25  # dispatch capacity multiplier
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.001  # load-balance auxiliary loss


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3)."""

    kv_lora_rank: int
    q_lora_rank: int = 0  # 0 => dense q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """State-space (Mamba) block config."""

    variant: str  # 'mamba1' | 'mamba2'
    state: int  # N: SSM state size
    conv_kernel: int = 4
    expand: int = 2  # d_inner = expand * d_model
    head_dim: int = 64  # mamba2 only
    n_groups: int = 1  # mamba2 only
    chunk: int = 256  # scan chunk length


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: a sequence length, a global batch and a kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid'
    modality: str = "text"  # 'text' | 'audio' | 'vlm'
    source: str = ""  # provenance string

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0  # 0 => d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0

    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    first_k_dense: int = 0  # leading dense layers in an MoE stack
    dense_ff: int = 0  # d_ff of those dense layers (0 => d_ff)
    shared_attn_every: int = 0  # hybrid: the shared block's cadence (zamba2)
    sliding_window: int = 0  # 0 => full attention

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # runtime knobs (not architecture identity)
    dtype: str = "bfloat16"  # weights and KV cache
    attn_impl: str = "chunked"  # training forward: 'dense' | 'chunked' (online softmax)
    attn_chunk: int = 512  # KV block of chunked attention
    remat: str = "block"  # 'none' | 'block' (recompute each block in backward)
    kv_cache_dtype: str = ""  # '' => dtype; 'float8_e4m3fn' halves KV memory (unscaled rows)

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode (long_500k) is in this arch's regime."""
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window > 0 and self.family in ("dense", "moe"))

    def _mamba_params(self) -> int:
        """One Mamba block's parameters, its pre-norm included."""
        d, s = self.d_model, self.ssm
        d_in = s.expand * d
        if s.variant == "mamba1":
            # in_proj, conv, x_proj (-> dt, B, C), dt_proj, A, D, out_proj
            dt_rank = max(d // 16, 1)
            per_layer = (d * 2 * d_in + s.conv_kernel * d_in + d_in * (dt_rank + 2 * s.state)
                         + dt_rank * d_in + d_in * s.state + d_in + d_in * d)
        else:  # mamba2: in_proj (-> z, x, B, C, dt), conv, A / D / dt_bias, out_proj
            n_heads = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.state
            per_layer = (d * (2 * d_in + 2 * s.n_groups * s.state + n_heads)
                         + s.conv_kernel * conv_dim + 3 * n_heads + d_in * d)
        return per_layer + d

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + final norm)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.name}: family {self.family!r} needs an SSMConfig")
        if self.family == "ssm":
            return int(emb + L * self._mamba_params() + d)
        if self.mla is not None:
            m = self.mla
            qk_dim = m.nope_head_dim + m.rope_head_dim
            if m.q_lora_rank:
                q_p = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_dim
            else:
                q_p = d * self.n_heads * qk_dim
            kv_p = (d * (m.kv_lora_rank + m.rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim))
            attn = q_p + kv_p + self.n_heads * m.v_head_dim * d
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        norms = 2 * d
        if self.family == "moe":
            if self.moe is None:
                raise ValueError(f"{self.name}: family 'moe' needs an MoEConfig")
            moe_ff = self.moe.expert_ff or f
            routed = self.moe.n_routed * 3 * d * moe_ff
            shared = self.moe.n_shared * 3 * d * moe_ff
            router = d * self.moe.n_routed
            dff = self.dense_ff or f
            kd = self.first_k_dense
            return int(emb + (L - kd) * (attn + routed + shared + router + norms)
                       + kd * (attn + 3 * d * dff + norms) + d)
        if self.family == "hybrid":  # L Mamba2 blocks + ONE shared attention + MLP block
            return int(emb + L * self._mamba_params() + attn + 3 * d * f + norms + d)
        return int(emb + L * (attn + 3 * d * f + norms) + d)

    def num_active_params(self) -> int:
        """Parameters a token reads: ``num_params`` less the routed experts
        it does not take (``n_routed - top_k`` of them a MoE layer)."""
        if self.family != "moe":
            return self.num_params()
        moe_ff = self.moe.expert_ff or self.d_ff
        inactive = ((self.n_layers - self.first_k_dense)
                    * (self.moe.n_routed - self.moe.top_k) * 3 * self.d_model * moe_ff)
        return int(self.num_params() - inactive)

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU tests (the JAX package's rules)."""
        kw: dict = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, d_head=16)
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, min(4, 4 * self.n_kv_heads // max(self.n_heads, 1)))
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_routed=4, top_k=min(self.moe.top_k, 2), expert_ff=64)
            kw["first_k_dense"] = min(self.first_k_dense, 1)
            kw["dense_ff"] = 128 if self.first_k_dense else 0
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                kv_lora_rank=32,
                q_lora_rank=32 if self.mla.q_lora_rank else 0,
                rope_head_dim=8,
                nope_head_dim=16,
                v_head_dim=16,
            )
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, state=8, head_dim=16, chunk=32)
        if self.shared_attn_every:
            kw["n_layers"] = 4
            kw["shared_attn_every"] = 2
        kw["dtype"] = "float32"
        kw["attn_chunk"] = 64
        kw["name"] = self.name + "-reduced"
        return replace(self, **kw)


ARCHS: dict[str, ArchConfig] = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in ARCHS:
        raise ValueError(f"duplicate arch {cfg.name}")
    ARCHS[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def applicable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k only for sub-quadratic archs; every arch runs the others."""
    if shape.name == "long_500k":
        return arch.sub_quadratic
    return True


def all_cells() -> list[tuple[str, str]]:
    """Every live (arch, shape) cell under ``applicable``."""
    import repro_torch.configs  # noqa: F401  (populates the registry)

    return [(aname, sname) for aname in sorted(ARCHS)
            for sname in ("train_4k", "prefill_32k", "decode_32k", "long_500k")
            if applicable(ARCHS[aname], SHAPES[sname])]


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (runtime, not architecture identity)."""

    lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_accum: int = 1  # microbatch count
