"""Device-placement backends: where a serving engine's tensors live and which
CUDA stream its work is queued on (counterpart of ``repro/serve/backend.py``).

The engine places its parameters and uploads its per-tick host arrays
through its backend, and allocates its cache and tick state on the
backend's device under :meth:`PlacementBackend.scope`. Two fabrics:

* :class:`PlacementBackend` — one device, the caller's current stream: no
  stream of its own.
* :class:`DeviceBackend` — pins an engine to one explicit device. On a CUDA
  device it owns one ``torch.cuda.Stream`` and the engine queues its
  dispatches and host copies there (:meth:`scope`). The current stream is
  thread-local, so two replicas pinned to one card, each driven by its own
  controller thread, queue their kernels apart — as two devices would. The
  split kernels key their ticket counters and partials by (device, stream)
  (``kernels/_checks.tickets``), so they never share scratch.

Parameters placed on the device they already live on come back as the same
tensors: two replicas on one card share one copy of the weights. The
tensor-parallel ``ShardedBackend`` is not ported yet (ROADMAP Queue 1 item
7); it would place params over the lanes of ``dist/sharding.py`` (a device
and a stream of its own each) through that module's rules.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device


def _tree_to(tree: Any, device: torch.device) -> Any:
    """A nested dict/list of tensors on ``device``. A tree already there comes
    back as the same object, and so does every subtree already there (no
    copy)."""
    if isinstance(tree, dict):
        out = {k: _tree_to(v, device) for k, v in tree.items()}
        return tree if all(out[k] is v for k, v in tree.items()) else out
    if isinstance(tree, (list, tuple)):
        out = [_tree_to(v, device) for v in tree]
        return tree if all(a is b for a, b in zip(out, tree)) else type(tree)(out)
    if isinstance(tree, torch.Tensor):
        return tree if tree.device == device else tree.to(device)
    return tree


class PlacementBackend:
    """Placement on one device with the caller's current stream.

    Subclasses override the placement hooks and :meth:`scope`."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)

    def put_params(self, model, params) -> Any:
        """Place the model parameters (once, at engine construction)."""
        return _tree_to(params, self.device)

    def put_host(self, arr: np.ndarray) -> torch.Tensor:
        """Upload a freshly built host array. On the card through pinned
        memory, so the copy is queued without waiting for earlier work on
        the stream; the caller never mutates ``arr`` afterwards."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def scope(self):
        """Context under which the engine queues its work: nothing here."""
        return contextlib.nullcontext()


class DeviceBackend(PlacementBackend):
    """Pin one engine to one explicit device (a split-mode replica). On a
    CUDA device the engine's work runs on a stream of its own."""

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self._stream: Optional[torch.cuda.Stream] = None
        self._lock = threading.Lock()

    @property
    def stream(self) -> Optional[torch.cuda.Stream]:
        """The backend's CUDA stream (made on first use); None on the CPU."""
        if self.device.type != "cuda":
            return None
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
        return self._stream

    @contextlib.contextmanager
    def scope(self):
        """Queue the enclosed work on the backend's stream. Entering, the
        stream waits for what the caller queued on its own stream (params
        placed there, say); leaving, the caller's stream waits for the
        engine's work, so a caller that reads engine tensors afterwards sees
        them finished. Both are device-side waits: the host never blocks."""
        s = self.stream
        if s is None:
            yield
            return
        outer = torch.cuda.current_stream(self.device)
        s.wait_stream(outer)
        try:
            with torch.cuda.stream(s):
                yield
        finally:
            outer.wait_stream(s)


def resolve_backend(backend: Optional[PlacementBackend] = None, device=None) -> PlacementBackend:
    """The engine's backend: ``backend`` as given, else ``DeviceBackend(device)``
    (``device=None`` is the card). Passing both raises when they disagree."""
    if backend is None:
        return DeviceBackend(device)
    if device is not None and resolve_device(device) != backend.device:
        raise ValueError(f"device={device} disagrees with the backend's {backend.device}")
    return backend
