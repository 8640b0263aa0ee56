"""Architecture registry of the port. Importing this package registers the
dense archs the port serves."""

from repro_torch.configs.base import ARCHS, ArchConfig, get_arch, register_arch

# Import every arch module for registration side effects.
from repro_torch.configs import codeqwen15_7b, qwen3_32b  # noqa: F401

__all__ = ["ARCHS", "ArchConfig", "get_arch", "register_arch"]
