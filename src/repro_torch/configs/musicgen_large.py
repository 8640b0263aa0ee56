"""musicgen-large — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf]
48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048

Audio modality: in the JAX package the EnCodec frontend is a stub and the
model takes precomputed frame embeddings (B, S, d_model) as ``batch["embeds"]``,
and so does the port's ``LM`` (``forward``, ``prefill``, ``decode_step``).
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="musicgen-large",
        family="dense",
        modality="audio",
        source="arXiv:2306.05284; hf",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=8192,
        vocab_size=2048,
    )
)
