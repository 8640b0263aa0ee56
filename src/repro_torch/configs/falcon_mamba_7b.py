"""falcon-mamba-7b — pure Mamba1 SSM LM (attention-free).

[arXiv:2410.05355; unverified]
64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16 — mamba1 arch
"""

from repro_torch.configs.base import ArchConfig, SSMConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="falcon-mamba-7b",
        family="ssm",
        source="arXiv:2410.05355; unverified",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=65024,
        ssm=SSMConfig(
            variant="mamba1",
            state=16,
            conv_kernel=4,
            expand=2,
        ),
        tie_embeddings=True,
    )
)
