"""Architecture registry of the port. Importing this package registers the
dense archs the port serves (minicpm3-4b with multi-head latent attention)."""

from repro_torch.configs.base import ARCHS, ArchConfig, MLAConfig, get_arch, register_arch

# Import every arch module for registration side effects.
from repro_torch.configs import codeqwen15_7b, minicpm3_4b, qwen3_32b  # noqa: F401

__all__ = ["ARCHS", "ArchConfig", "MLAConfig", "get_arch", "register_arch"]
