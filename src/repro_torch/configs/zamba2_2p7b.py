"""zamba2-2.7b — hybrid: Mamba2 backbone + shared (weight-tied) attention block.

[arXiv:2411.15242; hf]
54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64

Every 6th Mamba2 block is followed by an invocation of the single shared
attention+MLP block (weights tied across invocations). The real model's
per-invocation LoRA deltas are simplified to pure weight tying.
"""

from repro_torch.configs.base import ArchConfig, SSMConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        source="arXiv:2411.15242; hf",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_head=80,
        d_ff=10240,
        vocab_size=32000,
        shared_attn_every=6,
        ssm=SSMConfig(
            variant="mamba2",
            state=64,
            conv_kernel=4,
            expand=2,
            head_dim=64,
            n_groups=1,
            chunk=256,
        ),
        tie_embeddings=True,
    )
)
