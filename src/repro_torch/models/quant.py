"""Int8 weight serving: one-shot post-load quantization of the matmul weights
(the counterpart of ``repro/models/quant.py``).

:func:`quantize_params` replaces each eligible stacked matmul weight leaf
with a ``{"q8": int8, "scale": f32}`` sub-dict: symmetric per-output-channel
quantization, amax over the weight's reduction axes, keepdims scales. The
arithmetic is the JAX package's op for op in f32 (``torch.round`` rounds
half to even like ``jnp.round``), so the two give the same bits. Norms,
embeddings and the unembedding head stay dense.

:func:`qmatmul` is the consuming site: a dense leaf is a plain ``x @ w``; a
quantized leaf goes through ``ops.matmul_q8``, the fused counterpart of the
JAX package's ``qweight`` read-through, whose CUDA kernel reads the int8
weight as its only weight traffic and applies the column scale to the
finished f32 sum. :func:`qweight` keeps the read-through itself, and
:func:`layer_matmul_views` prepares one layer's int8 leaves for ``qmatmul``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels import ops

_INT8_MAX = 127.0

# subtrees whose leaves are stacked [L, ...] matmul weights; everything
# outside (embeddings, final norm, a hybrid's weight-tied ``shared`` block,
# which has no L axis) stays dense, as in the JAX package. No SSM leaf name
# (in_proj, x_proj, out_proj, ...) is eligible either, so int8 weights leave
# the ssm and hybrid families' params as they are.
_STACK_KEYS = ("blocks", "dense_blocks", "moe_blocks")


def _reduction_axes(name: str, ndim: int) -> Optional[tuple[int, ...]]:
    """Stacked-weight reduction (input) axes for an eligible leaf name.

    Axis 0 is always L. ``wq/wk/wv`` [L, d, H, hd] contract d; ``wo``
    [L, H, hd, d] contracts (H, hd); the MLP triple is [L, d, ff] /
    [L, ff, d] at ndim 3 and stacked experts [L, E, d, ff] / [L, E, ff, d]
    at ndim 4. ``router`` is deliberately absent, as in the JAX package."""
    if name in ("wq", "wk", "wv"):
        return (1,)
    if name == "wo":
        return (1, 2)
    if name in ("w_in", "w_gate", "w_out"):
        return (1,) if ndim == 3 else (2,)
    return None


def _quantize(w: torch.Tensor, axes: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    wf = w.float()
    amax = wf.abs().amax(dim=axes, keepdim=True)
    scale = torch.where(amax > 0.0, amax, 1.0) / _INT8_MAX
    q = torch.clamp(torch.round(wf / scale), -_INT8_MAX, _INT8_MAX).to(torch.int8)
    return q, scale


def quantize_leaf(w: torch.Tensor, axes: tuple[int, ...]) -> dict[str, torch.Tensor]:
    """Symmetric int8 over ``axes`` (keepdims scales), ``scale = amax/127``.

    When axis 0 is not reduced, its slices are independent and are quantized
    one at a time into preallocated outputs: the f32 transient is one layer's
    (a stacked full-width ``w_in`` widened at once would take 7 GB), and the
    bits are those of the whole-leaf computation."""
    axes = tuple(axes)
    if w.ndim < 2 or 0 in axes:
        q, scale = _quantize(w, axes)
        return {"q8": q, "scale": scale}
    inner = tuple(a - 1 for a in axes)
    scale_shape = tuple(1 if i in axes else s for i, s in enumerate(w.shape))
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(scale_shape, dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], scale[i] = _quantize(w[i], inner)
    return {"q8": q, "scale": scale}


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q8" in leaf


def qweight(w: Any, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Read-through dequant: a dense weight passes through as it is; a
    ``{"q8", "scale"}`` leaf widens in one multiply (f32, or ``dtype``)."""
    if is_quantized(w):
        dense = w["q8"].float() * w["scale"]
        return dense if dtype is None else dense.to(dtype)
    return w


def qmatmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x [..., K]`` times a weight whose leading axes flatten to K (wq/wk/wv
    [d, H, hd], wo [H, hd, d], the MLP's [d, ff] / [ff, d]): returns
    ``[..., N]``. A dense weight is one ``torch.matmul``; a quantized one is
    ``ops.matmul_q8`` over the int8 weight seen as [K, N] and its keepdims
    scale seen as one scale per output column [N]."""
    k = x.shape[-1]
    if not is_quantized(w):
        return x @ w.reshape(k, -1)
    q8, scale = w["q8"], w["scale"]
    if q8.ndim != 2:  # not yet a layer_matmul_views view
        q8, scale = q8.reshape(k, -1), scale.reshape(-1)
    if x.ndim == 2:
        return ops.matmul_q8(x, q8, scale)
    return ops.matmul_q8(x.reshape(-1, k), q8, scale).reshape(*x.shape[:-1], q8.shape[1])


def layer_matmul_views(layer: Any) -> Any:
    """One layer's params (the stacked L axis indexed away) with every int8
    leaf seen as the [K, N] weight and [N] scale :func:`qmatmul` hands the
    kernel: views, built once per layer instead of on every call."""
    if not isinstance(layer, dict):
        return layer
    out = {}
    for name, leaf in layer.items():
        axes = _reduction_axes(name, leaf["q8"].ndim + 1) if is_quantized(leaf) else None
        if axes is None or axes != tuple(range(1, len(axes) + 1)):
            out[name] = layer_matmul_views(leaf)  # a subtree, a dense leaf, or experts
            continue
        k = 1
        for d in leaf["q8"].shape[:len(axes)]:  # the leading (input) axes
            k *= d
        out[name] = {"q8": leaf["q8"].reshape(k, -1), "scale": leaf["scale"].reshape(-1)}
    return out


def quantize_params(params: Any, weight_dtype: Any = "int8") -> Any:
    """Quantize every eligible stacked matmul weight in a params tree.

    ``weight_dtype`` of ``None``/``"f32"``/``"float32"``/``torch.float32`` is
    the identity (the tree itself comes back); ``"int8"``/``"i8"``/
    ``torch.int8`` rewrites eligible leaves to ``{"q8", "scale"}``
    sub-dicts in a new dict structure whose unquantized leaves are shared,
    not copied. Anything else raises ``ValueError``. An already quantized
    tree comes back with the same leaves."""
    if weight_dtype in (None, "f32", "float32", torch.float32):
        return params
    if weight_dtype not in ("int8", "i8", torch.int8):
        raise ValueError(f"unsupported weight dtype: {weight_dtype!r}")

    def walk(tree: Any, in_stack: bool) -> Any:
        if not isinstance(tree, dict):
            return tree
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf, in_stack or name in _STACK_KEYS)
                continue
            axes = _reduction_axes(name, leaf.ndim) if in_stack else None
            if axes is not None and leaf.ndim >= 3:
                out[name] = quantize_leaf(leaf, axes)
            else:
                out[name] = leaf
        return out

    return walk(params, False)
