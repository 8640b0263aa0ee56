"""Wrapper of the CUDA row-softmax kernel (``csrc/softmax.cu``), the port of
``repro/kernels/softmax.py::softmax`` (``_softmax_kernel``).

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.softmax``. :func:`route` picks the kernel body from the shape and
``block_rows`` (:data:`ROUTES`). ``launches`` counts kernel launches,
``launches_<route>`` those of each body.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _checks

launches = 0
launches_rows = 0
launches_cluster = 0
launches_wide = 0

# the bodies, in softmax.cu's Route order
ROUTES = ("rows", "cluster", "wide")

# the autotuner's candidates: rows per CUDA block, 0 for the kernel's choice
# from the shape (one row per block for wide rows or few rows, up to 8 for
# many narrow ones; rows past one block's registers go to a cluster)
BLOCK_ROWS = (0, 1, 2, 4, 8)

THREADS = 256  # threads of a block
PER_THREAD = 64  # row elements a thread holds in registers, at most
CLUSTER = 8  # CTAs of a row's cluster (its slices)


def route(r: int, c: int, dtype: torch.dtype, block_rows: int) -> str:
    """The body for R rows of C columns of ``dtype`` at ``block_rows``:
    ``rows`` where a row fits the registers of its group of threads
    (256 / rows of them, 64 elements each; rows 1 at block_rows 0),
    ``cluster`` at block_rows 0 for rows that fit a cluster's registers
    (8 x 256 x 64 = 131,072 elements), ``wide`` (the two-pass body) for the
    rest."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"softmax: x must be f32 or bf16, got {dtype}")
    if block_rows not in BLOCK_ROWS:
        raise ValueError(f"softmax: block_rows must be one of {BLOCK_ROWS}, got {block_rows}")
    if c <= THREADS // max(block_rows, 1) * PER_THREAD:
        return "rows"
    if block_rows == 0 and c <= CLUSTER * THREADS * PER_THREAD and r * CLUSTER < 2**31:
        return "cluster"
    return "wide"


def softmax(x: torch.Tensor, *, block_rows: int = 0, body: Optional[str] = None
            ) -> torch.Tensor:
    """x: [R, C] f32 or bf16, any C. Returns the numerically stable softmax
    of each row (f32 math) in x's dtype, on x's device and stream, without
    synchronising. ``block_rows``: one of :data:`BLOCK_ROWS`. ``body`` forces
    one of :data:`ROUTES` (the cluster body takes block_rows 0 or 1; the
    kernel refuses a row past the body's registers); by default
    :func:`route`'s."""
    global launches, launches_rows, launches_cluster, launches_wide
    name = "softmax"
    _checks.cuda_operands(name, x)
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be [R, C], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    r, c = x.shape
    body = route(r, c, x.dtype, block_rows) if body is None else body
    if body not in ROUTES:
        raise ValueError(f"{name}: body must be one of {ROUTES}, got {body!r}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = _build.load().repro_softmax(
        x.data_ptr(), out.data_ptr(), r, c, block_rows, _checks.DTYPE_CODES[x.dtype],
        ROUTES.index(body), _checks.stream(x),
    )
    _build.check(rc, name)
    launches += 1
    if body == "rows":
        launches_rows += 1
    elif body == "cluster":
        launches_cluster += 1
    else:
        launches_wide += 1
    return out
