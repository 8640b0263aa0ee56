"""The dense decoder of the port and the bridge from JAX params."""

from repro_torch.models.bridge import params_from_jax
from repro_torch.models.model import LM

__all__ = ["LM", "params_from_jax"]
