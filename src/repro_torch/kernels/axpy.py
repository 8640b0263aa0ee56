"""Wrapper of the CUDA axpy kernel (``csrc/axpy.cu``), the port of
``repro/kernels/axpy.py::axpy`` (``_axpy_kernel``).

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.axpy``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks, ref

launches = 0

# the autotuner's candidates: elements per CUDA block, 0 for the kernel's
# choice (one 16-byte vector per thread: 1,024 f32 or 2,048 bf16 elements)
BLOCK = (0, 1024, 4096, 16384, 65536)


def axpy(alpha, x: torch.Tensor, y: torch.Tensor, *, block: int = 0) -> torch.Tensor:
    """x, y: [R, C] of one dtype, f32 or bf16. Returns ``alpha * x + y``
    (f32 math) in x's dtype, on x's device and stream, without
    synchronising. alpha is rounded to x's dtype first, as the TPU kernel
    rounds it (``ref.rounded_alpha``; a tensor alpha synchronises).
    ``block``: elements per CUDA block, or 0 for the kernel's choice."""
    global launches
    name = "axpy"
    _checks.c_int_dims(name, x, y)
    _checks.cuda_operands(name, x, y)
    if x.ndim != 2 or y.shape != x.shape:
        raise ValueError(f"{name}: x and y must be [R, C] of one shape, got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if block < 0:
        raise ValueError(f"{name}: block must be 0 or positive, got {block}")
    code = _checks.float_code(name, x, y)
    a = ref.rounded_alpha(alpha, x.dtype)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = _build.load().repro_axpy(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), a, x.shape[0], x.shape[1], block, code,
        _checks.stream(x),
    )
    _build.check(rc, name)
    launches += 1
    return out
