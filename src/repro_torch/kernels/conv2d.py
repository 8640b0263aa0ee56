"""Wrapper of the CUDA implicit-GEMM convolution (``csrc/conv2d.cu``), the
port of ``repro/kernels/conv2d.py::conv2d`` (``_conv2d_kernel``).

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.conv2d``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks

launches = 0

# the autotuner's candidates: output rows of a block's 64-pixel patch
# (block_h x 64 / block_h), 0 for the kernel's choice (the patch that pads
# the output plane least, the squarer on ties)
BLOCK_H = (0, 1, 2, 4, 8)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, block_h: int = 0) -> torch.Tensor:
    """x: [B, H, W, C]; w: [KH, KW, C, O]; each f32 or bf16, not
    necessarily the same (both are widened to f32, as the TPU kernel does).
    Returns the VALID, stride-1 convolution [B, H - KH + 1, W - KW + 1, O]
    (f32 sums) in x's dtype, on x's device and stream, without
    synchronising. ``block_h``: one of :data:`BLOCK_H`."""
    global launches
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
    rc = _build.load().repro_conv2d(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, kh, kw, o, block_h, xcode, wcode,
        _checks.stream(x),
    )
    _build.check(rc, name)
    launches += 1
    return out
