"""codeqwen1.5-7b — dense MHA (kv == heads) transformer, qwen1.5 arch.

[hf:Qwen/CodeQwen1.5-7B; hf]
32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
"""

from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(
    ArchConfig(
        name="codeqwen1.5-7b",
        family="dense",
        source="hf:Qwen/CodeQwen1.5-7B; hf",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_head=128,
        d_ff=13440,
        vocab_size=92416,
        rope_theta=1_000_000.0,
        norm_eps=1e-6,
    )
)
