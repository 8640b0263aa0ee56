"""minicpm3-4b — dense transformer with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B; hf]
62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448 — MLA

MLA sub-config (q_lora=768, kv_lora=256, rope=32, nope=64, v=64), the JAX
package's numbers. As there, HF MiniCPM3's muP scalings (``scale_emb``,
``scale_depth``) are not modelled.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="minicpm3-4b",
        family="dense",
        source="hf:openbmb/MiniCPM3-4B; hf",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_head=96,  # nope + rope
        d_ff=6400,
        vocab_size=73448,
        mla=MLAConfig(
            kv_lora_rank=256,
            q_lora_rank=768,
            rope_head_dim=32,
            nope_head_dim=64,
            v_head_dim=64,
        ),
        tie_embeddings=True,
        norm_eps=1e-6,
    )
)
