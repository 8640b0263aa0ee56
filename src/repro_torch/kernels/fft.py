"""Wrapper of the CUDA Stockham FFT kernel (``csrc/fft.cu``), the port of
``repro/kernels/fft.py::fft`` (``_fft_kernel``).

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.fft``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _checks, ref

launches = 0

MAX_N = 16384  # elements of a block's rows together in shared memory (128 KiB)
# the autotuner's candidates: rows per CUDA block, 0 for the kernel's choice
# (the most, up to 8, within 4,096 elements); rows * N may not pass MAX_N
BLOCK_ROWS = (0, 1, 2, 4, 8)

_twiddles: dict = {}  # (n, device) -> the f32 table (re, im) on the card


def fits(n: int, block_rows: int) -> bool:
    """Whether the kernel takes rows of ``n`` points at ``block_rows``."""
    return block_rows == 0 or block_rows * n <= MAX_N


def twiddles(n: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``ref.fft_twiddles(n)`` on ``device``, copied there once."""
    key = (n, device)
    if key not in _twiddles:
        tw_re, tw_im = ref.fft_twiddles(n)
        _twiddles[key] = (torch.from_numpy(tw_re).to(device), torch.from_numpy(tw_im).to(device))
    return _twiddles[key]


def fft(re: torch.Tensor, im: torch.Tensor, *, block_rows: int = 0
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """re, im: [B, N] of one dtype, f32 or bf16, N a power of two from 2 to
    16,384. Returns the FFT of each row (f32 math) as (re, im) in that
    dtype, on re's device and stream, without synchronising (the first call
    at an N copies its twiddle table to the card). ``block_rows``: one of
    :data:`BLOCK_ROWS` with ``block_rows * N <= 16384``."""
    global launches
    name = "fft"
    _checks.c_int_dims(name, re, im)
    _checks.cuda_operands(name, re, im)
    if re.ndim != 2 or im.shape != re.shape:
        raise ValueError(f"{name}: re and im must be [B, N] of one shape, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    b, n = re.shape
    if n < 2 or n > MAX_N or n & (n - 1):
        raise ValueError(f"{name}: N must be a power of two from 2 to {MAX_N} (a row lives in "
                         f"one block's shared memory), got {n}")
    if block_rows not in BLOCK_ROWS or not fits(n, block_rows):
        raise ValueError(f"{name}: block_rows must be one of {BLOCK_ROWS} with block_rows * N "
                         f"<= {MAX_N}, got {block_rows} at N = {n}")
    code = _checks.float_code(name, re, im)
    twr, twi = twiddles(n, re.device)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return ore, oim
    rc = _build.load().repro_fft(
        re.data_ptr(), im.data_ptr(), twr.data_ptr(), twi.data_ptr(), ore.data_ptr(),
        oim.data_ptr(), b, n, block_rows, code, _checks.stream(re),
    )
    _build.check(rc, name)
    launches += 1
    return ore, oim
