"""Architecture configs for the PyTorch port: a frozen dataclass + a registry
keyed by arch id.

A copy of the dense and mixture-of-experts parts of ``repro.configs.base``
with the MLA and MoE sub-configs (the port imports nothing of the JAX
package). The dense and moe families are ported, each with or without
multi-head latent attention (``mla``); the SSM sub-config is not carried
yet. ``reduced()``, ``num_params()`` and ``num_active_params()`` keep the JAX
package's rules for the fields carried, which is what lets the tests hand
the same reduced config to both packages.
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
class ArchConfig:
    name: str
    family: str  # 'dense' or 'moe' (each with or without ``mla``) are ported
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
    sliding_window: int = 0  # 0 => full attention

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

    dtype: str = "bfloat16"  # weights and KV cache

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + final norm)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
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
        kw["dtype"] = "float32"
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
