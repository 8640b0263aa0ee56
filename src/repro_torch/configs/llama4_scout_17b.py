"""llama4-scout-17b-a16e — MoE (16 experts, top-1) with GQA.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192(expert) vocab=202048, MoE 16e top-1
+ 1 always-on shared expert (Llama-4 style). The JAX package's numbers.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab_size=202048,
        moe=MoEConfig(
            n_routed=16,
            top_k=1,
            n_shared=1,
            expert_ff=8192,
            capacity_factor=1.5,  # top-1 routing needs more slack
            aux_loss_coef=0.001,
        ),
        rope_theta=500_000.0,
    )
)
