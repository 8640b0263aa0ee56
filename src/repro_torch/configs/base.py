"""Architecture configs for the PyTorch port: a frozen dataclass + a registry
keyed by arch id.

A copy of the dense part of ``repro.configs.base`` (the port imports nothing
of the JAX package). Only the dense family is ported so far, so the MoE, MLA
and SSM sub-configs are not carried; ``reduced()`` keeps the dense rules
unchanged, which is what lets the tests hand the same reduced config to both
packages.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # only 'dense' is ported
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
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        return int(emb + L * (attn + 3 * d * f + 2 * d) + d)

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU tests (the JAX package's rules)."""
        kw: dict = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, d_head=16)
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, min(4, 4 * self.n_kv_heads // max(self.n_heads, 1)))
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
