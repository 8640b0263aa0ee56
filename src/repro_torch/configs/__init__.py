"""Architecture registry of the port. Importing this package registers the
archs the port serves: dense (codeqwen1.5-7b, qwen3-32b; minicpm3-4b with
multi-head latent attention) and mixture-of-experts (deepseek-v2-lite-16b
with MLA, llama4-scout-17b-a16e with GQA)."""

from repro_torch.configs.base import (
    ARCHS,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    get_arch,
    register_arch,
)

# Import every arch module for registration side effects.
from repro_torch.configs import (  # noqa: F401
    codeqwen15_7b,
    deepseek_v2_lite_16b,
    llama4_scout_17b,
    minicpm3_4b,
    qwen3_32b,
)

__all__ = ["ARCHS", "ArchConfig", "MLAConfig", "MoEConfig", "get_arch", "register_arch"]
