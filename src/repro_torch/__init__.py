"""PyTorch/CUDA port of the serving stack and of training, beside the JAX
package ``repro``.

The module layout mirrors ``repro`` (``configs``, ``kernels``, ``models``,
``serve``, ``train``, ``data``, ``ckpt``, ...) so each counterpart is easy
to find. The port imports ``torch``, ``numpy`` and the standard library
only — never JAX, never ``repro``.

Entry points (``LM``, ``ServeEngine``, ``params_from_jax``, the data loader,
the launchers) run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of falling back.
On the CPU every kernel call routes to its plain PyTorch version in
:mod:`repro_torch.kernels.ref`. The ``meta`` device, which the production
dry run (:mod:`repro_torch.launch.dryrun`) and its tests name explicitly,
holds shapes without data: a kernel call there traces the plain version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; only an explicit CPU (or
    ``meta``) device runs elsewhere. Raises when CUDA is asked for (or
    implied) but missing. A CUDA device always comes back with its index, so
    devices compare."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
