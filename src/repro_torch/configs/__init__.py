"""Architecture registry of the port. Importing this package registers the
JAX package's ten archs: dense (codeqwen1.5-7b, qwen3-32b, chameleon-34b,
mistral-large-123b, musicgen-large; minicpm3-4b with multi-head latent
attention), mixture-of-experts (deepseek-v2-lite-16b with MLA,
llama4-scout-17b-a16e with GQA), ssm (falcon-mamba-7b, Mamba1) and hybrid
(zamba2-2.7b, Mamba2 with a shared attention block). Beside them: the
input-shape cells (``SHAPES``) and the training hyperparameters
(``TrainConfig``)."""

from repro_torch.configs.base import (
    ARCHS,
    SHAPES,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    all_cells,
    applicable,
    get_arch,
    get_shape,
    register_arch,
)

# Import every arch module for registration side effects.
from repro_torch.configs import (  # noqa: F401
    chameleon_34b,
    codeqwen15_7b,
    deepseek_v2_lite_16b,
    falcon_mamba_7b,
    llama4_scout_17b,
    minicpm3_4b,
    mistral_large_123b,
    musicgen_large,
    qwen3_32b,
    zamba2_2p7b,
)

__all__ = ["ARCHS", "SHAPES", "ArchConfig", "MLAConfig", "MoEConfig",
           "ShapeConfig", "SSMConfig", "TrainConfig", "all_cells", "applicable", "get_arch",
           "get_shape", "register_arch"]
