"""Block-size autotuner for the kernel API (``ops.py``), the port of
``repro.kernels.autotune``.

Each tuned op of :mod:`repro_torch.kernels.ops` asks the tuner for its
plan: a small dict of the CUDA kernel's knobs. The tuner

* buckets shapes to powers of two so one sweep covers a family of nearby
  shapes (a 1000-wide matmul and a 1024-wide one share a winner),
* sweeps a per-op candidate list, timing the real kernel on synthetic
  inputs on the card (CUDA events around a CUDA-graph replay, best of 3
  after a warm-up) at the shape of the call that missed — the JAX package
  times the bucket's rounded-up shape, but the port's kernels plan from the
  exact shape (a matmul's GEMV slice, a row kernel's grid), so the rounded
  shape can crown a candidate that is slower at the shapes that use it —
  and
* persists winners to a JSON cache so later processes hit without
  re-sweeping.

The cache file and its keys are the JAX package's: ``cache_key`` gives the
same string for the same op, shape, dtype, backend and ``kv_dtype``, so
either package reads the other's file. The port's kernels key on backend
``"cuda"``; their knobs differ from the Pallas block sizes:

* ``matmul``: ``split_k`` — 0 lets the kernel split K as its roofline
  estimate prefers, 1, 2, 4, 8 force it — and the wgmma tile ``block_m`` x
  ``block_n``, the JAX tuner's names — 0 x 0 lets the kernel choose, 128 x
  128 or 128 x 256 force it (the bodies for M <= 8, f32 and shapes outside
  the wgmma tile's domain ignore it);
* ``flash_attention``: ``block_q`` x ``block_k``, the instantiated tiles of
  the call's dtype (bf16's wgmma tiles, f32's CUDA-core tiles;
  :func:`candidates`), by default the serving path's tile of that dtype
  (:func:`default`);
* ``rmsnorm`` and ``softmax``: ``block_rows``, the rows per CUDA block —
  0 lets the kernel choose from the shape, 1, 2, 4, 8 force it;
* ``axpy``: ``block``, elements per CUDA block (0: one 16-byte vector per
  thread); ``dotp``: ``block``, elements per partial sum (0: the wrapper's
  choice from the shape);
* ``fft``: ``block_rows``, whole rows per CUDA block (0: the kernel's
  choice; rows * N may not pass 16,384, so a longer row, which runs the
  four-step kernels, takes only 0);
* ``conv2d``: ``block_h``, output rows of a block's pixel patch (128
  pixels on the wgmma body, 64 on the FMA tile; 0: the kernel's choice). Its key is x's shape, as in the JAX package; the
  measure also takes w's shape.

Cache location: ``$REPRO_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro/autotune.json``. Sweeping is opt-in via
``REPRO_AUTOTUNE=1``; without it, a cache miss returns the per-op default
and nothing is written. A cached winner on backend ``"cuda"`` that is no
longer among its op's candidates (a tile a rebuilt kernel dropped) is a
miss: it is swept again, or the default runs, and never reaches the
kernel. Entries are keyed on a schema version — bump
``_SCHEMA_VERSION`` to invalidate every cached winner at once.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import axpy as _axpy_k
from repro_torch.kernels import conv2d as _conv2d_k
from repro_torch.kernels import dotp as _dotp_k
from repro_torch.kernels import fft as _fft_k
from repro_torch.kernels import flash_attention as _flash_k
from repro_torch.kernels import matmul as _matmul_k
from repro_torch.kernels import rmsnorm as _rmsnorm_k
from repro_torch.kernels import softmax as _softmax_k

_SCHEMA_VERSION = 1

Config = dict[str, int]

# Defaults: each kernel's own choice (the matmul's K splits and tile). Flash attention's default and
# candidates depend on the dtype: :func:`default` and :func:`candidates`.
DEFAULTS: dict[str, Config] = {
    "matmul": {"block_m": 0, "block_n": 0, "split_k": 0},
    "softmax": {"block_rows": 0},
    "rmsnorm": {"block_rows": 0},
    "axpy": {"block": 0},
    "dotp": {"block": 0},
    "fft": {"block_rows": 0},
    "conv2d": {"block_h": 0},
}

# Every configuration each dtype-free op's kernel is instantiated for.
CANDIDATES: dict[str, list[Config]] = {
    "matmul": [{"block_m": m, "block_n": n, "split_k": s}
               for m, n in ((0, 0),) + _matmul_k.TILES for s in _matmul_k.SPLIT_K],
    "softmax": [{"block_rows": r} for r in _softmax_k.BLOCK_ROWS],
    "rmsnorm": [{"block_rows": r} for r in _rmsnorm_k.BLOCK_ROWS],
    "axpy": [{"block": b} for b in _axpy_k.BLOCK],
    "dotp": [{"block": b} for b in _dotp_k.BLOCK],
    "fft": [{"block_rows": r} for r in _fft_k.BLOCK_ROWS],
    "conv2d": [{"block_h": h} for h in _conv2d_k.BLOCK_H],
}

# numpy's names for torch dtypes: the JAX package names dtypes with
# ``np.dtype(dtype).name`` (bfloat16 and float8 through ml_dtypes)
_TORCH_NAMES = {
    torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8",
    torch.float8_e4m3fn: "float8_e4m3fn",
}


def dtype_name(dtype: Any) -> str:
    """numpy's name of a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_NAMES[dtype]
    if isinstance(dtype, str) and dtype in _TORCH_NAMES.values():
        return dtype  # bfloat16 / float8 need ml_dtypes to be numpy dtypes
    return np.dtype(dtype).name


def candidates(op: str, dtype: Any) -> list[Config]:
    """The configurations a sweep of ``op`` times at ``dtype``: flash
    attention's tiles of that dtype, every other op's :data:`CANDIDATES`."""
    if op == "flash_attention":
        tiles = _flash_k.TILES[_TORCH_DTYPES[dtype_name(dtype)]]
        return [{"block_q": q, "block_k": k} for q, k in tiles]
    return CANDIDATES.get(op, [DEFAULTS[op]])


def default(op: str, dtype: Any) -> Config:
    """What ``op`` runs at ``dtype`` without a cached winner: flash
    attention's serving tile of that dtype, every other op's
    :data:`DEFAULTS`."""
    if op == "flash_attention":
        tile = _flash_k.DEFAULT_TILE[_TORCH_DTYPES[dtype_name(dtype)]]
        return dict(zip(("block_q", "block_k"), tile))
    return dict(DEFAULTS[op])


def bucket_dim(n: int) -> int:
    """Round a dimension up to the next power of two (floor 8)."""
    n = max(int(n), 1)
    b = 8
    while b < n:
        b *= 2
    return b


def bucket_shape(shape: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(bucket_dim(d) for d in shape)


def cache_key(
    op: str, shape: tuple[int, ...], dtype: Any, backend: str,
    kv_dtype: Any = None,
) -> str:
    """Stable string key over the bucketed shape: nearby shapes collide by
    design so one sweep serves the whole bucket. ``kv_dtype`` (a storage
    dtype beside the compute dtype, e.g. an int8 weight) appends a
    ``|kv<name>`` component only when present."""
    dims = "x".join(str(d) for d in bucket_shape(shape))
    key = f"v{_SCHEMA_VERSION}|{op}|{dims}|{dtype_name(dtype)}|{backend}"
    if kv_dtype is not None:
        key += f"|kv{dtype_name(kv_dtype)}"
    return key


def sweep_enabled() -> bool:
    return os.environ.get("REPRO_AUTOTUNE", "0") not in ("", "0", "false")


def default_cache_path() -> str:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro", "autotune.json")


class Autotuner:
    """JSON-backed (op, shape-bucket, dtype, backend) -> config cache."""

    def __init__(self, path: Optional[str] = None, *, sweep: Optional[bool] = None):
        self.path = path or default_cache_path()
        self.sweep = sweep_enabled() if sweep is None else sweep
        self._entries: Optional[dict[str, Config]] = None
        self.sweeps_run = 0  # observability: how many sweeps this process ran
        # the last sweep's candidates: (config, seconds or None, error or None)
        self.last_sweep: list[tuple[Config, Optional[float], Optional[str]]] = []

    # ------------------------------------------------------------ persistence

    def _load(self) -> dict[str, Config]:
        if self._entries is None:
            self._entries = {}
            try:
                with open(self.path) as f:
                    raw = json.load(f)
                if isinstance(raw, dict):
                    self._entries = {k: v for k, v in raw.items() if isinstance(v, dict)}
            except (OSError, ValueError):
                pass  # missing/corrupt cache == cold cache
        return self._entries

    def save(self) -> None:
        if self._entries is None:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self._entries, f, indent=2, sort_keys=True)
        os.replace(tmp, self.path)  # atomic vs concurrent readers

    # ----------------------------------------------------------------- lookup

    def lookup(self, op, shape, dtype, backend, kv_dtype=None) -> Optional[Config]:
        return self._load().get(cache_key(op, shape, dtype, backend, kv_dtype))

    def store(self, op, shape, dtype, backend, config: Config, kv_dtype=None) -> None:
        self._load()[cache_key(op, shape, dtype, backend, kv_dtype)] = dict(config)
        self.save()

    def hit(self, op, shape, dtype, backend, kv_dtype=None) -> Optional[Config]:
        """The cached winner, unless it is on backend ``"cuda"`` and no
        longer a candidate of its op at ``dtype`` (then None: a miss)."""
        found = self.lookup(op, shape, dtype, backend, kv_dtype)
        if found is None or (backend == "cuda" and found not in candidates(op, dtype)):
            return None
        return found

    def get(
        self,
        op: str,
        shape: tuple[int, ...],
        dtype: Any,
        backend: str,
        measure: Optional[Callable[[Config], float]] = None,
        kv_dtype: Any = None,
    ) -> Config:
        """Cached winner, or (if sweeping is enabled) sweep-measure-persist,
        or the default. ``measure`` maps a candidate config to its cost in
        seconds; ``None`` disables sweeping for this call. A candidate whose
        measure raises is skipped (and logged in ``last_sweep``). A cached
        config that is no longer a candidate counts as a miss (:meth:`hit`);
        a sweep then overwrites it."""
        found = self.hit(op, shape, dtype, backend, kv_dtype)
        if found is not None:
            return dict(found)  # copy: callers must not mutate the cache
        if not self.sweep or measure is None:
            return default(op, dtype)
        best_cfg, best_t = None, float("inf")
        self.last_sweep = []
        for cfg in candidates(op, dtype):
            try:
                t = measure(cfg)
            except Exception as e:  # candidate invalid for this shape
                self.last_sweep.append((dict(cfg), None, f"{type(e).__name__}: {e}"))
                continue
            self.last_sweep.append((dict(cfg), t, None))
            if t < best_t:
                best_cfg, best_t = cfg, t
        if best_cfg is None:
            best_cfg = default(op, dtype)
        self.sweeps_run += 1
        self.store(op, shape, dtype, backend, best_cfg, kv_dtype)
        return dict(best_cfg)


# ---------------------------------------------------------------------------
# Synthetic-input measure functions (used by ops.py when sweeping is on).
# They call the kernel modules directly — never ops.py — so there is no
# import cycle, and they time the kernel exactly as dispatched.
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {name: dt for dt, name in _TORCH_NAMES.items()}


def _time_best(thunk: Callable[[], Any], repeats: int = 3, calls: int = 10) -> float:
    """Device seconds per call of ``thunk``: ``calls`` calls captured in one
    CUDA graph after a warm-up call (which also builds the kernels and raises
    for a configuration the kernel lacks), the best of ``repeats`` replays
    between CUDA events. The graph keeps the wrappers' host time out, so a
    kernel shorter than its launch is not timed as its host."""
    thunk()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            thunk()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / calls)
    return best


def _inputs(backend: str, dtype, *shapes):
    """Standard-normal tensors of ``shapes`` on the card, from a fixed seed."""
    if backend != "cuda":
        raise ValueError(f"the port's kernels are measured on backend 'cuda', not {backend!r}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = _TORCH_DTYPES[dtype_name(dtype)]
    return [torch.randn(*s, generator=gen, device="cuda").to(dt) for s in shapes]


# Each measure function times the candidates at ``shape``, the caller's
# shape (only the cache key is bucketed).


def measure_matmul(shape, dtype, backend) -> Callable[[Config], float]:
    m, k, n = shape
    a, b = _inputs(backend, dtype, (m, k), (k, n))
    return lambda cfg: _time_best(lambda: _matmul_k.matmul(a, b, **cfg))


def measure_flash_attention(shape, dtype, backend) -> Callable[[Config], float]:
    q, kv = _inputs(backend, dtype, shape, shape)
    return lambda cfg: _time_best(lambda: _flash_k.flash_attention(
        q, kv, kv, causal=True, block_q=cfg["block_q"], block_k=cfg["block_k"]))


def measure_rmsnorm(shape, dtype, backend) -> Callable[[Config], float]:
    x, w = _inputs(backend, dtype, shape, shape[-1:])
    return lambda cfg: _time_best(lambda: _rmsnorm_k.rmsnorm(x, w, block_rows=cfg["block_rows"]))


def measure_softmax(shape, dtype, backend) -> Callable[[Config], float]:
    (x,) = _inputs(backend, dtype, shape)
    return lambda cfg: _time_best(lambda: _softmax_k.softmax(x, block_rows=cfg["block_rows"]))


def measure_axpy(shape, dtype, backend) -> Callable[[Config], float]:
    x, y = _inputs(backend, dtype, shape, shape)
    return lambda cfg: _time_best(lambda: _axpy_k.axpy(1.5, x, y, block=cfg["block"]))


def measure_dotp(shape, dtype, backend) -> Callable[[Config], float]:
    x, y = _inputs(backend, dtype, shape, shape)
    return lambda cfg: _time_best(lambda: _dotp_k.dotp(x, y, block=cfg["block"]))


def measure_fft(shape, dtype, backend) -> Callable[[Config], float]:
    """A block_rows whose rows do not fit one block at this N raises in its
    first call, and the sweep skips it."""
    re, im = _inputs(backend, dtype, shape, shape)
    return lambda cfg: _time_best(lambda: _fft_k.fft(re, im, block_rows=cfg["block_rows"]))


def measure_conv2d(shape, dtype, backend, w_shape) -> Callable[[Config], float]:
    """``shape`` is x's (the cache key's), ``w_shape`` the weight's."""
    x, w = _inputs(backend, dtype, shape, w_shape)
    return lambda cfg: _time_best(lambda: _conv2d_k.conv2d(x, w, block_h=cfg["block_h"]))


MEASURES: dict[str, Callable[..., Callable[[Config], float]]] = {
    "matmul": measure_matmul,
    "flash_attention": measure_flash_attention,
    "rmsnorm": measure_rmsnorm,
    "softmax": measure_softmax,
    "axpy": measure_axpy,
    "dotp": measure_dotp,
    "fft": measure_fft,
    "conv2d": measure_conv2d,
}


def measure_for(op: str, shape, dtype, backend, *operands):
    """Measure-closure factory, or None when the op has no sweep runner.
    ``operands``: the shapes its measure needs beyond the key's (conv2d:
    w's)."""
    fn = MEASURES.get(op)
    if fn is None:
        return None
    return fn(shape, dtype, backend, *operands)


# ---------------------------------------------------------------------------
# Process-global tuner (what ops.py consults). ``generation`` feeds the
# plan memoizer in ops.py so swapping tuners invalidates memoized plans.
# ---------------------------------------------------------------------------

_tuner: Optional[Autotuner] = None
_generation = 0


def get_tuner() -> Autotuner:
    global _tuner
    if _tuner is None:
        _tuner = Autotuner()
    return _tuner


def set_tuner(tuner: Optional[Autotuner]) -> None:
    """Install a tuner (tests point this at a tmp cache); None resets to the
    env-configured default on next use."""
    global _tuner, _generation
    _tuner = tuner
    _generation += 1


def generation() -> int:
    return _generation
