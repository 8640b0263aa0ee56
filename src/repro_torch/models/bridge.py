"""Carry JAX-package params into the port.

``params_from_jax`` takes the JAX param pytree with its leaves already
converted to numpy (``jax.tree.map(np.asarray, params)``) — nested dicts,
stacked ``[L, ...]`` blocks — and returns the same tree of torch tensors.
The layouts are identical, so nothing is transposed. It takes numpy only and
never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly, narrow in torch
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)  # own, writable memory


def params_from_jax(tree, device=None):
    """Numpy-leaved JAX param tree -> the port's params on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return _leaf(tree, dev)
