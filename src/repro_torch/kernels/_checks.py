"""Argument checks shared by the kernel wrappers: every tensor handed to a
kernel is on one CUDA device and contiguous, float operands are 16-byte
aligned (the kernels load rows as vectors), with the storage dtype the
kernel was built for."""

from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every operand must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.is_floating_point() and t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v and out must be 16-byte aligned")


def float_code(name: str, *tensors: torch.Tensor) -> int:
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{name}: q, k, v must share one dtype of f32/bf16, got "
                        f"{[t.dtype for t in tensors]}")
    return DTYPE_CODES[dt]


def int32_vector(name: str, what: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.int32 or t.shape != (n,):
        raise ValueError(f"{name}: {what} must be int32 of shape ({n},), got "
                         f"{t.dtype} {tuple(t.shape)}")
