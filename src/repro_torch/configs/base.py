"""Architecture configs for the PyTorch port: a frozen dataclass + a registry
keyed by arch id.

A copy of the dense part of ``repro.configs.base`` with its MLA sub-config
(the port imports nothing of the JAX package). The dense family is ported,
with or without multi-head latent attention (``mla``); the MoE and SSM
sub-configs are not carried yet. ``reduced()`` keeps the JAX package's rules
for the fields carried, which is what lets the tests hand the same reduced
config to both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


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
    family: str  # only 'dense' is ported (with or without ``mla``)
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
    sliding_window: int = 0  # 0 => full attention

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
        return int(emb + L * (attn + 3 * d * f + 2 * d) + d)

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU tests (the JAX package's rules)."""
        kw: dict = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, d_head=16)
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, min(4, 4 * self.n_kv_heads // max(self.n_heads, 1)))
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
