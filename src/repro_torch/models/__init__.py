"""The port's LM over its four families (dense and moe: GQA over a dense or
block-paged KV cache, plain or quantized rows, dense or int8 weights, or
multi-head latent attention over its latent cache; ssm: a Mamba1 stack;
hybrid: a Mamba2 stack with a shared attention block) and the bridge from
JAX params."""

from repro_torch.models.bridge import params_from_jax
from repro_torch.models.model import LM, input_specs, pad_seq_axis
from repro_torch.models.quant import quantize_params

__all__ = ["LM", "input_specs", "pad_seq_axis", "params_from_jax", "quantize_params"]
