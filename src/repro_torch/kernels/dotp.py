"""Wrapper of the CUDA partial dot product kernel (``csrc/dotp.cu``), the
port of ``repro/kernels/dotp.py::dotp_partials`` (``_dotp_kernel``) and
``::dotp``.

CUDA tensors only: :mod:`repro_torch.kernels.ops` routes CPU tensors to
``ref.dotp``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, _checks

launches = 0

# the autotuner's candidates: elements per partial (one CUDA block each), 0
# for the wrapper's choice from the shape (auto_block)
BLOCK = (0, 1024, 4096, 16384, 65536)


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def auto_block(r: int, c: int, sms: int) -> int:
    """block 0: the fewest elements per partial, a power of two from 2,048
    to 65,536, that leave at most 32 partials per SM (four waves of eight
    256-thread blocks), so each block's reduction is spread over many loads."""
    block = 2048
    while block < 65536 and r * -(-c // block) > 32 * sms:
        block *= 2
    return block


def dotp_partials(x: torch.Tensor, y: torch.Tensor, *, block: int = 0) -> torch.Tensor:
    """x, y: [R, C] of one dtype, f32 or bf16. Returns the f32 partial dot
    products [R, cdiv(C, block)] — partial j of row r sums x * y over
    columns [j * block, (j + 1) * block) — on x's device and stream, without
    synchronising. ``block`` 0 takes :func:`auto_block`'s."""
    global launches
    name = "dotp"
    _checks.c_int_dims(name, x, y)
    _checks.cuda_operands(name, x, y)
    if x.ndim != 2 or y.shape != x.shape:
        raise ValueError(f"{name}: x and y must be [R, C] of one shape, got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if block < 0:
        raise ValueError(f"{name}: block must be 0 or positive, got {block}")
    code = _checks.float_code(name, x, y)
    r, c = x.shape
    if block == 0:
        block = auto_block(r, c, _sms(x.device.index))
    out = torch.empty(r, -(-c // block), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    rc = _build.load().repro_dotp(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), r, c, block, code, _checks.stream(x))
    _build.check(rc, name)
    launches += 1
    return out


def dotp(x: torch.Tensor, y: torch.Tensor, *, block: int = 0) -> torch.Tensor:
    """The f32 dot product of x and y ([R, C]) as a 0-d tensor on the card:
    the kernel's partials summed by ``torch.sum``, as the TPU package sums
    its kernel's partials outside it. Does not synchronise."""
    return dotp_partials(x, y, block=block).sum()
