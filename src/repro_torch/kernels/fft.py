"""Wrapper of the CUDA Stockham FFT kernel (``csrc/fft.cu``), the port of
``repro/kernels/fft.py::fft`` (``_fft_kernel``).

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.fft``. Each launch is counted where it is made: ``launches`` counts
the row kernel's launches over rows that fit a block (one per call),
``launches_long`` every launch of the four-step path over longer rows (its
transposes and its row passes: five per call up to 2^28 points, nine at
2^29 and thirteen at 2^30, where a row pass recurses).

A row of up to :data:`MAX_ROW_N` points lives in one block's shared memory
through all its stages, run in passes of four stages in registers
(``ref.fft_stockham_passes`` is the plain twin) by persistent blocks that
prefetch their next tile. A longer row runs the four-step FFT
(:func:`four_step`): N = N1 * N2, a transpose, N1-row FFTs of N2 points, a
twiddle-and-transpose, N2-row FFTs of N1 points and a last transpose, all
hand-written kernels of ``csrc/fft.cu``, with f32 intermediates. From 2^29
points N2 = 2^15 passes a block, and that row pass is a four-step FFT in
turn.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build, _checks, ref

launches = 0
launches_long = 0

MAX_ROW_N = 16384  # elements of a block's rows together in shared memory (128 KiB)
MAX_N = 2**30  # every power of two a C int dimension takes (_checks.c_int_dims)
# the autotuner's candidates: rows per CUDA block, 0 for the kernel's choice
# (the most, up to 8, within 4,096 elements); rows * N may not pass
# MAX_ROW_N, so above it only 0 (the four-step path) is taken
BLOCK_ROWS = (0, 1, 2, 4, 8)

_twiddles: dict = {}  # (n, device) -> the f32 stage twiddles [n - 1, 2] on the card


def fits(n: int, block_rows: int) -> bool:
    """Whether the kernel takes rows of ``n`` points at ``block_rows``."""
    return block_rows == 0 or block_rows * n <= MAX_ROW_N


def split(n: int) -> tuple[int, int]:
    """(N1, N2) of the four-step FFT of ``n`` points: N2 the power of two
    at or just above sqrt(n), so each row pass is as short as it can be."""
    log2n = n.bit_length() - 1
    n2 = 1 << ((log2n + 1) // 2)
    return n // n2, n2


def twiddles(n: int, device: torch.device) -> torch.Tensor:
    """``ref.fft_twiddle_stages(n)`` (every stage's distinct entries of the
    TPU kernel's table, read from its last row) as one f32 [n - 1, 2]
    tensor of (re, im) pairs on ``device``, copied there once."""
    key = (n, device)
    if key not in _twiddles:
        tw_re, tw_im = ref.fft_twiddle_stages(n)
        _twiddles[key] = torch.from_numpy(np.stack([tw_re, tw_im], -1)).to(device)
    return _twiddles[key]


def four_step(re, im, row_fft, transpose, max_row: int | None = None):
    """The FFT of each row of [B, N] (re, im) as N = N1 * N2 (:func:`split`):
    with x viewed [N2, N1], the N1 columns' N2-point FFTs (a transpose to
    [N1, N2], then rows), each times W_N^(n1 k2) while transposed back to
    [N2, N1], the N2 rows' N1-point FFTs, and a transpose that puts output
    k2 + N2 k1 at [k1, k2]. ``row_fft(re, im)`` transforms the rows of a
    [rows, n] pair of at most ``max_row`` points (default
    :data:`MAX_ROW_N`); a longer row pass is a four-step FFT in turn.
    ``transpose(re, im, tw_n, dtype)`` maps [B, R, C] to [B, C, R] (times
    W_tw_n^(r c) when tw_n > 0) in ``dtype``. The kernels or their plain
    versions (``ref.fft``, ``ref.fft_transpose``) plug in alike.
    Intermediates are f32; the result has re's dtype."""
    max_row = MAX_ROW_N if max_row is None else max_row

    def rows(xr, xi):
        if xr.shape[1] > max_row:
            return four_step(xr, xi, row_fft, transpose, max_row)
        return row_fft(xr, xi)

    b, n = re.shape
    n1, n2 = split(n)
    f32 = torch.float32
    xr, xi = transpose(re.reshape(b, n2, n1), im.reshape(b, n2, n1), 0, f32)
    xr, xi = rows(xr.reshape(b * n1, n2), xi.reshape(b * n1, n2))
    xr, xi = transpose(xr.reshape(b, n1, n2), xi.reshape(b, n1, n2), n, f32)
    xr, xi = rows(xr.reshape(b * n2, n1), xi.reshape(b * n2, n1))
    xr, xi = transpose(xr.reshape(b, n2, n1), xi.reshape(b, n2, n1), 0, re.dtype)
    return xr.reshape(b, n), xi.reshape(b, n)


def _transpose(re, im, tw_n: int, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel of :func:`four_step`'s ``transpose`` (only the four-step
    path launches it)."""
    global launches_long
    b, r, c = re.shape
    ore = torch.empty(b, c, r, dtype=dtype, device=re.device)
    oim = torch.empty_like(ore)
    rc = _build.load().repro_fft_transpose(
        re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(), b, r, c, tw_n,
        _checks.DTYPE_CODES[re.dtype], _checks.DTYPE_CODES[dtype], _checks.stream(re),
    )
    _build.check(rc, "fft")
    launches_long += 1
    return ore, oim


def _row_kernel(re, im, block_rows: int = 0, long: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The row kernel over [rows, n <= MAX_ROW_N], counted in
    ``launches_long`` when it is a row pass of the four-step path."""
    global launches, launches_long
    b, n = re.shape
    tw = twiddles(n, re.device)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    rc = _build.load().repro_fft(
        re.data_ptr(), im.data_ptr(), tw.data_ptr(), ore.data_ptr(), oim.data_ptr(), b, n,
        block_rows, _checks.DTYPE_CODES[re.dtype], _checks.stream(re),
    )
    _build.check(rc, "fft")
    if long:
        launches_long += 1
    else:
        launches += 1
    return ore, oim


def fft(re: torch.Tensor, im: torch.Tensor, *, block_rows: int = 0
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """re, im: [B, N] of one dtype, f32 or bf16, N a power of two from 2 to
    2^30. Returns the FFT of each row (f32 math) as (re, im) in that dtype,
    on re's device and stream, without synchronising (the first call at a
    row length copies its stage twiddles to the card). ``block_rows``: one of
    :data:`BLOCK_ROWS` with ``block_rows * N <= 16384`` (0 above)."""
    name = "fft"
    _checks.c_int_dims(name, re, im)
    _checks.cuda_operands(name, re, im)
    if re.ndim != 2 or im.shape != re.shape:
        raise ValueError(f"{name}: re and im must be [B, N] of one shape, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    b, n = re.shape
    if n < 2 or n > MAX_N or n & (n - 1):
        raise ValueError(f"{name}: N must be a power of two from 2 to 2^{int(math.log2(MAX_N))}, "
                         f"got {n}")
    if block_rows not in BLOCK_ROWS or not fits(n, block_rows):
        raise ValueError(f"{name}: block_rows must be one of {BLOCK_ROWS} with block_rows * N "
                         f"<= {MAX_ROW_N}, got {block_rows} at N = {n}")
    _checks.float_code(name, re, im)
    if n > MAX_ROW_N and b * n >= 2**32:  # a pass of rows of >= 2 points has < 2^31 of them
        raise ValueError(f"{name}: {b} rows of {n} points pass the C interface's int in the "
                         f"four-step passes (B * N must be below 2^32)")
    if b == 0:
        return torch.empty_like(re), torch.empty_like(im)
    if n > MAX_ROW_N:
        return four_step(re, im, functools.partial(_row_kernel, long=True), _transpose)
    return _row_kernel(re, im, block_rows)
