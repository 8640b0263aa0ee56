"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``), the port of
``repro/kernels/rmsnorm.py::rmsnorm`` (``_rmsnorm_kernel``).

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.rmsnorm``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks

launches = 0

# the autotuner's candidates: rows per CUDA block, 0 for the kernel's choice
# from the shape (one row per block for wide rows or few rows, up to 8 for
# many narrow ones)
BLOCK_ROWS = (0, 1, 2, 4, 8)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 0) -> torch.Tensor:
    """x: [R, C] f32 or bf16; w: [C] in x's dtype or f32. Returns
    ``x * rsqrt(mean(x^2) + eps) * w`` (f32 math) in x's dtype, on x's device
    and stream, without synchronising. ``block_rows``: one of
    :data:`BLOCK_ROWS`."""
    global launches
    name = "rmsnorm"
    _checks.cuda_operands(name, x, w)
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"{name}: x must be [R, C] and w [C], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"{name}: x must be f32 or bf16 and w x's dtype or f32, got {x.dtype} "
                        f"and {w.dtype}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = _build.load().repro_rmsnorm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], float(eps),
        block_rows, _checks.DTYPE_CODES[x.dtype], _checks.DTYPE_CODES[w.dtype],
        _checks.stream(x),
    )
    _build.check(rc, name)
    launches += 1
    return out
