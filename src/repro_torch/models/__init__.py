"""The dense decoder of the port (dense or block-paged KV cache, plain or
quantized rows; dense or int8 weights) and the bridge from JAX params."""

from repro_torch.models.bridge import params_from_jax
from repro_torch.models.model import LM
from repro_torch.models.quant import quantize_params

__all__ = ["LM", "params_from_jax", "quantize_params"]
