"""mistral-large-123b — dense GQA transformer.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="mistral-large-123b",
        family="dense",
        source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_head=128,
        d_ff=28672,
        vocab_size=32768,
        rope_theta=1_000_000.0,
    )
)
