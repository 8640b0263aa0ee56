"""deepseek-v2-lite-16b — MoE transformer with MLA.

[arXiv:2405.04434; hf]
27L d_model=2048 16H (GQA kv=16) d_ff=1408(expert) vocab=102400,
MoE 64 routed top-6 + 2 shared — MLA kv_lora=512.

The JAX package's numbers: 64 experts top-6 (the "160 routed" of the full V2
does not apply to Lite), the first layer dense at ff 10944 as in the HF
config, dense q (no q LoRA).
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        source="arXiv:2405.04434; hf",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=192,  # nope(128) + rope(64)
        d_ff=1408,
        vocab_size=102400,
        first_k_dense=1,
        dense_ff=10944,
        moe=MoEConfig(
            n_routed=64,
            top_k=6,
            n_shared=2,
            expert_ff=1408,
            capacity_factor=1.25,
            aux_loss_coef=0.001,
        ),
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=0,  # V2-Lite: dense q projection
            rope_head_dim=64,
            nope_head_dim=128,
            v_head_dim=128,
        ),
        norm_eps=1e-6,
    )
)
