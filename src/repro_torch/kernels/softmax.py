"""Wrapper of the CUDA row-softmax kernel (``csrc/softmax.cu``), the port of
``repro/kernels/softmax.py::softmax`` (``_softmax_kernel``).

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.softmax``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks

launches = 0

# the autotuner's candidates: rows per CUDA block, 0 for the kernel's choice
# from the shape (one row per block for wide rows or few rows, up to 8 for
# many narrow ones)
BLOCK_ROWS = (0, 1, 2, 4, 8)


def softmax(x: torch.Tensor, *, block_rows: int = 0) -> torch.Tensor:
    """x: [R, C] f32 or bf16, any C. Returns the numerically stable softmax
    of each row (f32 math) in x's dtype, on x's device and stream, without
    synchronising. ``block_rows``: one of :data:`BLOCK_ROWS`."""
    global launches
    name = "softmax"
    _checks.cuda_operands(name, x)
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be [R, C], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = _build.load().repro_softmax(
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], block_rows,
        _checks.DTYPE_CODES[x.dtype], _checks.stream(x),
    )
    _build.check(rc, name)
    launches += 1
    return out
