"""chameleon-34b — early-fusion VLM: VQ image tokens share the text vocab.

[arXiv:2405.09818; unverified]
48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536

VLM modality: images arrive as discrete VQ-VAE codes inside the 65536-entry
vocab (early fusion), so the token pipeline is uniform; the VQ image tokenizer
itself is a stub (tokens arrive pre-quantized). qk_norm per the Chameleon
paper's training-stability fix.
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="chameleon-34b",
        family="dense",
        modality="vlm",
        source="arXiv:2405.09818; unverified",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=22016,
        vocab_size=65536,
        qk_norm=True,
    )
)
