"""Async checkpointing with reshard-on-restore (counterpart of
``repro/ckpt/checkpoint.py``).

Save: every leaf is snapshotted to host memory of its own before ``save``
returns (a CUDA tensor's copy to the host waits for the work queued before
it, a sharded value is gathered whole), so an in-place optimizer update
that follows cannot race the writer. A background thread then writes one
``.npy`` a leaf and a ``manifest.json`` into ``step_XXXXXXXX.tmp``, renames
it atomically to ``step_XXXXXXXX`` and drops all but the newest ``keep``
checkpoints; one save is in flight at a time. Leaves are in the JAX
package's order under its ``keystr`` paths (``common.tree``).

bf16 has no numpy dtype without ``ml_dtypes``: a bf16 leaf is stored as its
16-bit words (``uint16``) with ``"bfloat16"`` in the manifest, and restored
bit for bit. A JAX checkpoint's bf16 leaf (numpy's 2-byte void when read
without ``ml_dtypes``) restores the same way.

Restore takes the structure of ``state_like`` and, optionally, a target
sharding tree: a checkpoint written on one mesh restores onto any other
(the elastic-restart path, ``ft.elastic``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.tree import flatten_with_path, unflatten
from repro_torch.dist.sharding import NamedSharding, ShardedTensor, device_put, gather


def _snapshot(leaf: Any) -> tuple[np.ndarray, str]:
    """(a host array of its own, the manifest dtype) of one leaf."""
    if isinstance(leaf, ShardedTensor):
        t = gather(leaf, "cpu")
    elif isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
    else:
        arr = np.array(leaf, copy=True)
        return arr, str(arr.dtype)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _load(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":  # 16-bit words (the port) or 2-byte voids (a JAX bf16 leaf)
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclass
class SaveHandle:
    step: int
    path: str
    thread: threading.Thread

    def wait(self) -> None:
        self.thread.join()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._last_handle: Optional[SaveHandle] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: Any, *, blocking: bool = False) -> SaveHandle:
        """Snapshot ``state`` (a tree of tensors or sharded values) to the host
        now, write it in the background."""
        if self._last_handle is not None:
            self._last_handle.wait()  # one in-flight save at a time
        host = [(key, *_snapshot(leaf)) for key, leaf in flatten_with_path(state)]
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"

        def writer() -> None:
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": []}
            for i, (key, arr, dtype) in enumerate(host):
                fname = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"].append(
                    {"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        handle = SaveHandle(step, final, t)
        self._last_handle = handle
        if blocking:
            handle.wait()
        return handle

    def _gc(self) -> None:
        for s in self.list_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> tuple[Any, int]:
        """Restore into the structure of ``state_like`` (a tree whose leaves
        have shapes: tensors, meta tensors, sharded values). Each leaf comes
        back in its saved dtype: placed by ``shardings`` (one
        ``NamedSharding`` or a tree of them — reshard-on-restore) when given,
        else onto the like leaf's sharding (a sharded value) or device (a
        tensor; a meta tensor's on the CPU). Returns (state, step)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like = flatten_with_path(state_like)
        if len(flat_like) != len(manifest["leaves"]):
            raise ValueError(f"{len(flat_like)} leaves to restore, the checkpoint at step "
                             f"{step} has {len(manifest['leaves'])}")
        out = []
        for meta, (key, like) in zip(manifest["leaves"], flat_like):
            t = _load(os.path.join(path, meta["file"]), meta["dtype"])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{key}: saved {tuple(t.shape)}, expected {tuple(like.shape)}")
            if shardings is None and isinstance(like, ShardedTensor):
                t = device_put(t, like.sharding)
            elif shardings is None and isinstance(like, torch.Tensor) and like.device.type != "meta":
                t = t.to(like.device)
            out.append(t)
        if shardings is not None:
            targets = ([shardings] * len(out) if isinstance(shardings, NamedSharding)
                       else [s for _, s in flatten_with_path(shardings)])
            out = [device_put(t, s) for t, s in zip(out, targets, strict=True)]
        return unflatten(state_like, out), step

    def wait(self) -> None:
        if self._last_handle is not None:
            self._last_handle.wait()
