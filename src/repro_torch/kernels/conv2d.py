"""Wrapper of the CUDA implicit-GEMM convolution (``csrc/conv2d.cu``), the
port of ``repro/kernels/conv2d.py::conv2d`` (``_conv2d_kernel``).

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.conv2d``. :func:`route` picks the kernel body from the dtypes, C and
O alone (:data:`ROUTES`). ``launches`` counts kernel launches,
``launches_<route>`` those of each body.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks

launches = 0
launches_wgmma = 0
launches_fma = 0

# the bodies, in conv2d.cu's Route order
ROUTES = ("wgmma", "fma")

# the autotuner's candidates: output rows of a block's pixel patch (block_h
# x P / block_h, P = 128 pixels on wgmma, 64 on the FMA tile), 0 for the
# kernel's choice (the patch that pads the output plane least, the squarer
# on ties)
BLOCK_H = (0, 1, 2, 4, 8)


def route(x_dtype: torch.dtype, w_dtype: torch.dtype, c: int, o: int) -> str:
    """The body of a convolution with these dtypes, C input and O output
    channels: wgmma for bf16 x and w with C and O multiples of 8 (TMA's
    16-byte strides), the CUDA-core FMA tile for anything else."""
    if x_dtype == w_dtype == torch.bfloat16 and c % 8 == 0 and o % 8 == 0:
        return "wgmma"
    return "fma"


def conv2d(x: torch.Tensor, w: torch.Tensor, *, block_h: int = 0) -> torch.Tensor:
    """x: [B, H, W, C]; w: [KH, KW, C, O]; each f32 or bf16, not
    necessarily the same (both are widened to f32, as the TPU kernel does).
    Returns the VALID, stride-1 convolution [B, H - KH + 1, W - KW + 1, O]
    (f32 sums) in x's dtype, on x's device and stream, without
    synchronising. ``block_h``: one of :data:`BLOCK_H`."""
    global launches, launches_wgmma, launches_fma
    name = "conv2d"
    _checks.c_int_dims(name, x, w)
    _checks.cuda_operands(name, x, w)
    if x.ndim != 4 or w.ndim != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"{name}: x must be [B, H, W, C] and w [KH, KW, C, O], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    b, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    if kh < 1 or kw < 1 or h < kh or wd < kw:
        raise ValueError(f"{name}: a {kh} x {kw} window does not fit a {h} x {wd} image")
    if block_h not in BLOCK_H:
        raise ValueError(f"{name}: block_h must be one of {BLOCK_H}, got {block_h}")
    xcode, wcode = _checks.float_code(name, x), _checks.float_code(name, w)
    out = torch.empty(b, h - kh + 1, wd - kw + 1, o, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    body = route(x.dtype, w.dtype, c, o)
    if body == "wgmma" and any(t.data_ptr() % 16 for t in (x, w, out)):
        raise ValueError(f"{name}: x, w and out must be 16-byte aligned")
    rc = _build.load().repro_conv2d(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, kh, kw, o, block_h, xcode, wcode,
        ROUTES.index(body), _checks.stream(x),
    )
    _build.check(rc, name)
    launches += 1
    if body == "wgmma":
        launches_wgmma += 1
    else:
        launches_fma += 1
    return out
