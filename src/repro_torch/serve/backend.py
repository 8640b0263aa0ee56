"""Device-placement backends: where a serving engine's tensors live and which
CUDA stream its work is queued on (counterpart of ``repro/serve/backend.py``).

The engine places its parameters and its cache and uploads its per-tick
host arrays through its backend, and allocates its tick state on the
backend's device under :meth:`PlacementBackend.scope`. Three fabrics:

* :class:`PlacementBackend` — one device, the caller's current stream: no
  stream of its own.
* :class:`DeviceBackend` — pins an engine to one explicit device. On a CUDA
  device it owns one ``torch.cuda.Stream`` and the engine queues its
  dispatches and host copies there (:meth:`scope`). The current stream is
  thread-local, so two replicas pinned to one card, each driven by its own
  controller thread, queue their kernels apart — as two devices would. The
  split kernels key their ticket counters and partials by (device, stream)
  (``kernels/_checks.tickets``), so they never share scratch.

* :class:`ShardedBackend` — tensor-parallel placement over the ``model``
  axis of a lane mesh (``dist/sharding.py``: a lane is a device and a stream
  of its own, and one card may hold several): params through
  ``serve_param_shardings`` (attention heads, MLP columns and rows, the
  vocabulary split over the lanes), the KV cache through
  ``serve_cache_shardings`` (KV heads). The tick state and the host uploads
  live on the first lane, the controller's: one controller thread issues
  every lane's work, the merged ``LM`` hands the lanes what they read of it
  (``collectives.lane_broadcast``), and the engine queues its own work on
  the controller lane's stream (:meth:`ShardedBackend.scope`).

Parameters placed on the device they already live on come back as the same
tensors: two replicas on one card share one copy of the weights.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.dist.sharding import (
    MeshInfo,
    device_put,
    serve_cache_shardings,
    serve_param_shardings,
    stream_scope,
)


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

    def put_cache(self, model, cache) -> Any:
        """Place the decode cache the model made (once, at engine
        construction)."""
        return _tree_to(cache, self.device)

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

    def synchronize(self) -> None:
        """Block the host until the device work queued so far has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


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

    def scope(self):
        """Queue the enclosed work on the backend's stream, after what the
        caller queued on its own; the caller's stream waits for it on the
        way out (``stream_scope``)."""
        return stream_scope(self.stream, self.device)


class ShardedBackend(PlacementBackend):
    """Tensor-parallel placement over ``mesh_info``'s lanes (merge-mode
    serving): params per ``serve_param_shardings``, the KV cache per
    ``serve_cache_shardings``, everything per-slot or host-built on the
    controller lane — control state, the same for every lane, as in the
    paper's merged fabric under ONE controller."""

    def __init__(self, mesh_info: MeshInfo) -> None:
        self.mesh_info = mesh_info
        self.lanes = mesh_info.mesh.lanes
        self.device = self.lanes[0].device

    def put_params(self, model, params) -> Any:
        return device_put(params, serve_param_shardings(params, self.mesh_info))

    def put_cache(self, model, cache) -> Any:
        """A cache the merged ``LM`` laid out already keeps every shard."""
        return device_put(cache, serve_cache_shardings(cache, self.mesh_info))

    def scope(self):
        """The controller lane's stream; the other lanes wait on events the
        merged ``LM`` records there."""
        return stream_scope(self.lanes[0].stream, self.device)

    def synchronize(self) -> None:
        for dev in dict.fromkeys(lane.device for lane in self.lanes):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def describe(self) -> str:
        mi = self.mesh_info
        return f"sharded:model={mi.model_size},devices={mi.n_devices}"


def resolve_backend(backend: Optional[PlacementBackend] = None, device=None,
                    model=None) -> PlacementBackend:
    """The engine's backend: ``backend`` as given, else a
    ``ShardedBackend`` over a merged ``model``'s mesh, else
    ``DeviceBackend(device)`` (``device=None`` is the card). Passing both
    raises when they disagree."""
    if backend is None:
        if model is not None and model.merged:
            backend = ShardedBackend(model.mesh_info)
        else:
            return DeviceBackend(device)
    if device is not None and resolve_device(device) != backend.device:
        raise ValueError(f"device={device} disagrees with the backend's {backend.device}")
    return backend
