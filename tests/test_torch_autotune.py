"""The port's autotuner (``repro_torch.kernels.autotune``): the semantics of
``tests/test_autotune.py`` on the port's ops and backend ``"cuda"``, and the
cache shared with the JAX package — the same key strings, and cache files
that either package reads back entry for entry. CPU only: the measure
functions are stand-ins (the card's sweep runs in ``chip_smoke.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune, ops
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels.autotune import Autotuner, bucket_shape, cache_key


@pytest.fixture
def tuner_path(tmp_path):
    return str(tmp_path / "autotune.json")


@pytest.fixture
def installed_tuner(tuner_path):
    """A tmp-backed tuner installed as the process-global one."""
    t = Autotuner(tuner_path, sweep=False)
    autotune.set_tuner(t)
    yield t
    autotune.set_tuner(None)


@pytest.fixture(scope="module")
def jtune():
    pytest.importorskip("jax")
    from repro.kernels import autotune as jautotune

    return jautotune


def test_cache_round_trip_no_resweep(tuner_path):
    calls = []

    def measure(cfg):
        calls.append(cfg)
        return float(abs(cfg["block_rows"] - 2))  # two rows per block win

    t = Autotuner(tuner_path, sweep=True)
    cfg = t.get("softmax", (40, 1000), torch.float32, "cuda", measure=measure)
    assert cfg == {"block_rows": 2}
    assert len(calls) == len(autotune.CANDIDATES["softmax"])
    assert t.sweeps_run == 1
    assert os.path.exists(tuner_path)

    # fresh tuner over the same file: hit from disk, measure NEVER called
    def boom(cfg):
        raise AssertionError("re-sweep on a cache hit")

    t2 = Autotuner(tuner_path, sweep=True)
    assert t2.get("softmax", (40, 1000), torch.float32, "cuda", measure=boom) == cfg
    assert t2.sweeps_run == 0
    assert len(json.load(open(tuner_path))) == 1


def test_shape_bucket_collision(tuner_path):
    t = Autotuner(tuner_path, sweep=False)
    win = {"block_m": 128, "block_n": 128, "split_k": 4}
    t.store("matmul", (100, 70, 130), torch.float32, "cuda", win)
    # (100, 70, 130) and (128, 128, 200) share the (128, 128, 256) bucket
    assert bucket_shape((100, 70, 130)) == bucket_shape((128, 128, 200))
    assert t.lookup("matmul", (128, 128, 200), torch.float32, "cuda") == win
    # a different bucket, dtype, backend or storage dtype is a distinct cell
    assert t.lookup("matmul", (300, 70, 130), torch.float32, "cuda") is None
    assert t.lookup("matmul", (100, 70, 130), torch.bfloat16, "cuda") is None
    assert t.lookup("matmul", (100, 70, 130), torch.float32, "pallas") is None
    assert t.lookup("matmul", (100, 70, 130), torch.float32, "cuda", kv_dtype=torch.int8) is None


def test_cache_key_is_versioned_and_stable():
    k1 = cache_key("matmul", (100, 70, 130), torch.float32, "cuda")
    assert k1 == cache_key("matmul", (128, 128, 256), "float32", "cuda")
    assert k1 == cache_key("matmul", (128, 128, 256), np.float32, "cuda")
    assert k1 == f"v{autotune._SCHEMA_VERSION}|matmul|128x128x256|float32|cuda"


def test_miss_without_sweep_returns_default_and_writes_nothing(tuner_path):
    t = Autotuner(tuner_path, sweep=False)
    for op in autotune.MEASURES:
        for dtype in (torch.bfloat16, torch.float32):
            assert t.get(op, (64, 64, 64), dtype, "cuda") == autotune.default(op, dtype)
    assert not os.path.exists(tuner_path)


def test_defaults_are_candidates():
    """Each default is a configuration its kernel is instantiated for, at
    every dtype (flash attention's differ by dtype)."""
    assert autotune.DEFAULTS.keys() == autotune.CANDIDATES.keys()
    for op in autotune.MEASURES:
        for dtype in (torch.bfloat16, torch.float32):
            assert autotune.default(op, dtype) in autotune.candidates(op, dtype), (op, dtype)


@pytest.mark.parametrize("op,shape,dtype,stale", [
    # a tile of the CUDA-core body that the bf16 wgmma body does not have, as
    # an earlier build's sweep stored it at the flat main shape
    ("flash_attention", (32, 1024, 128), torch.bfloat16, {"block_q": 32, "block_k": 64}),
    ("flash_attention", (6, 96, 16), torch.float32, {"block_q": 128, "block_k": 128}),
    ("matmul", (64, 256, 512), torch.bfloat16, {"split_k": 3}),
])
def test_a_cached_config_the_kernel_lacks_is_a_miss(tmp_path, monkeypatch, op, shape, dtype,
                                                     stale):
    """A cached winner that is no longer a candidate never reaches the
    kernel: without sweeping the default runs and the file is left as it
    was; with sweeping it is swept again and overwritten."""
    path = str(tmp_path / "stale.json")
    Autotuner(path, sweep=False).store(op, shape, dtype, "cuda", stale)
    t = Autotuner(path, sweep=False)
    assert t.lookup(op, shape, dtype, "cuda") == stale
    assert t.hit(op, shape, dtype, "cuda") is None
    assert t.get(op, shape, dtype, "cuda") == autotune.default(op, dtype)
    autotune.set_tuner(Autotuner(path, sweep=False))
    try:
        assert ops._blocks(op, shape, dtype) == autotune.default(op, dtype)
        assert Autotuner(path, sweep=False).lookup(op, shape, dtype, "cuda") == stale
        winner = autotune.candidates(op, dtype)[-1]
        monkeypatch.setattr(autotune, "measure_for",
                            lambda *a: lambda cfg: float(cfg != winner))
        autotune.set_tuner(Autotuner(path, sweep=True))
        assert ops._blocks(op, shape, dtype) == winner
        assert Autotuner(path, sweep=False).lookup(op, shape, dtype, "cuda") == winner
    finally:
        autotune.set_tuner(None)


def test_corrupt_cache_is_cold_not_fatal(tuner_path):
    with open(tuner_path, "w") as f:
        f.write("{not json")
    t = Autotuner(tuner_path, sweep=False)
    assert t.lookup("matmul", (64, 64, 64), torch.float32, "cuda") is None


def test_sweep_picks_measured_winner_and_persists(tuner_path):
    t = Autotuner(tuner_path, sweep=True)
    # the cost prefers the (128, 64) tile, a bf16 tile other than the default
    cfg = t.get(
        "flash_attention", (32, 1024, 128), torch.bfloat16, "cuda",
        measure=lambda c: abs(c["block_q"] - 128) + abs(c["block_k"] - 64),
    )
    assert cfg == {"block_q": 128, "block_k": 64}
    t2 = Autotuner(tuner_path, sweep=False)
    assert t2.lookup("flash_attention", (32, 1024, 128), torch.bfloat16, "cuda") == cfg


def test_sweep_skips_and_logs_a_failing_candidate(tuner_path):
    def measure(cfg):
        if cfg["split_k"] == 0:
            raise ValueError("not instantiated")
        return 1.0 / cfg["split_k"]

    t = Autotuner(tuner_path, sweep=True)
    assert t.get("matmul", (4, 4096, 13440), torch.bfloat16, "cuda", measure=measure) == {
        "block_m": 0, "block_n": 0, "split_k": 8}
    failed = [(cfg, err) for cfg, sec, err in t.last_sweep if err is not None]
    assert failed == [({"block_m": m, "block_n": n, "split_k": 0}, "ValueError: not instantiated")
                      for m, n in ((0, 0),) + mmk.TILES]
    assert len(t.last_sweep) == len(autotune.CANDIDATES["matmul"])


def test_env_var_cache_path(monkeypatch, tmp_path):
    p = str(tmp_path / "custom" / "cache.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", p)
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    t = Autotuner()
    assert t.path == p and t.sweep
    t.store("rmsnorm", (2048, 4096), torch.bfloat16, "cuda", {"block_rows": 4})
    assert os.path.exists(p)


def test_set_tuner_invalidates_memoised_plans(tmp_path):
    shape = (2048, 4096)
    a = Autotuner(str(tmp_path / "a.json"), sweep=False)
    a.store("rmsnorm", shape, torch.bfloat16, "cuda", {"block_rows": 8})
    autotune.set_tuner(a)
    try:
        assert ops._blocks("rmsnorm", shape, torch.bfloat16) == {"block_rows": 8}
        # the plan is memoised: the tuner is not asked again
        a.store("rmsnorm", shape, torch.bfloat16, "cuda", {"block_rows": 2})
        assert ops._blocks("rmsnorm", shape, torch.bfloat16) == {"block_rows": 8}
        autotune.set_tuner(Autotuner(str(tmp_path / "b.json"), sweep=False))
        assert ops._blocks("rmsnorm", shape, torch.bfloat16) == autotune.DEFAULTS["rmsnorm"]
        autotune.set_tuner(a)
        assert ops._blocks("rmsnorm", shape, torch.bfloat16) == {"block_rows": 2}
    finally:
        autotune.set_tuner(None)


def test_plan_sweeps_only_when_enabled(tmp_path, monkeypatch):
    """A miss with sweeping on builds the op's measure and persists the
    winner; with sweeping off the measure is never built."""
    built = []

    winner = {"block_m": 128, "block_n": 256, "split_k": 2}

    def fake_measure_for(op, shape, dtype, backend):
        built.append((op, shape, dtype, backend))
        return lambda cfg: float(cfg != winner)

    monkeypatch.setattr(autotune, "measure_for", fake_measure_for)
    path = str(tmp_path / "c.json")
    autotune.set_tuner(Autotuner(path, sweep=False))
    try:
        assert ops._blocks("matmul", (64, 256, 512), torch.bfloat16) == {
            "block_m": 0, "block_n": 0, "split_k": 0}
        assert built == []
        autotune.set_tuner(Autotuner(path, sweep=True))
        assert ops._blocks("matmul", (64, 256, 512), torch.bfloat16) == winner
        assert built == [("matmul", (64, 256, 512), "bfloat16", "cuda")]
        assert Autotuner(path, sweep=False).lookup(
            "matmul", (64, 256, 512), "bfloat16", "cuda") == winner
    finally:
        autotune.set_tuner(None)


def test_measure_functions_need_the_cuda_backend():
    assert autotune.measure_for("matmul_q8", (8, 8, 8), torch.float32, "cuda") is None
    assert set(autotune.MEASURES) == set(autotune.CANDIDATES) | {"flash_attention"}
    with pytest.raises(ValueError, match="cuda"):
        autotune.measure_for("matmul", (8, 8, 8), torch.float32, "interpret")


def test_dtype_names():
    assert [autotune.dtype_name(d) for d in (
        torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn)] == [
        "float32", "bfloat16", "int8", "float8_e4m3fn"]
    assert autotune.dtype_name("bfloat16") == "bfloat16"
    assert autotune.dtype_name(np.float32) == "float32"


# ------------------------------------------------------------ the JAX package


@pytest.mark.parametrize("op,shape", [
    ("matmul", (100, 70, 130)), ("matmul", (4, 4096, 13440)),
    ("flash_attention", (32, 1024, 128)), ("flash_attention", (6, 96, 16)),
    ("softmax", (64, 92416)), ("rmsnorm", (37, 128)), ("decode_attention", (4, 1024, 32, 128)),
    ("axpy", (1, 2**28)), ("axpy", (3, 1000003)), ("dotp", (1, 1000003)), ("fft", (8192, 16384)),
    ("fft", (37, 64)), ("conv2d", (4, 512, 512, 256)), ("conv2d", (2, 13, 9, 4)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv", [None, "int8", "float8_e4m3fn"])
def test_cache_key_equals_jax(jtune, op, shape, dtype, kv):
    import jax.numpy as jnp

    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
           "float8_e4m3fn": torch.float8_e4m3fn}
    for backend in ("cuda", "interpret"):
        want = jtune.cache_key(op, shape, getattr(jnp, dtype), backend,
                               None if kv is None else getattr(jnp, kv))
        assert cache_key(op, shape, tdt[dtype], backend,
                         None if kv is None else tdt[kv]) == want
        assert cache_key(op, shape, dtype, backend, kv) == want


def test_cache_file_written_by_jax_reads_in_the_port(jtune, tuner_path):
    import jax.numpy as jnp

    jt = jtune.Autotuner(tuner_path, sweep=False)
    entries = [
        ("matmul", (100, 70, 130), jnp.float32, "cuda",
         {"block_m": 128, "block_n": 256, "split_k": 4}, None),
        ("flash_attention", (32, 1024, 128), jnp.bfloat16, "cuda",
         {"block_q": 64, "block_k": 64}, None),
        ("matmul", (4, 4096, 13440), jnp.bfloat16, "interpret",
         {"block_m": 64, "block_n": 64, "block_k": 64}, jnp.int8),
        ("softmax", (200, 128), jnp.float32, "pallas", {"block_rows": 64}, None),
        ("axpy", (1, 2**28), jnp.float32, "cuda", {"block": 1024}, None),
        ("dotp", (1, 1000003), jnp.bfloat16, "cuda", {"block": 16384}, None),
        ("fft", (8192, 16384), jnp.float32, "cuda", {"block_rows": 1}, None),
        ("conv2d", (4, 512, 512, 256), jnp.bfloat16, "cuda", {"block_h": 2}, None),
        ("conv2d", (2, 12, 10, 8), jnp.float32, "pallas", {"block_h": 8}, None),
    ]
    for op, shape, dt, backend, cfg, kv in entries:
        jt.store(op, shape, dt, backend, cfg, kv_dtype=kv)
    t = Autotuner(tuner_path, sweep=True)
    names = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, jnp.int8: torch.int8}
    for op, shape, dt, backend, cfg, kv in entries:
        kvt = None if kv is None else names[kv]
        assert t.lookup(op, shape, names[dt], backend, kvt) == cfg
        assert t.get(op, shape, names[dt], backend, measure=None, kv_dtype=kvt) == cfg
    assert t._load() == json.load(open(tuner_path))


def test_cache_file_written_by_the_port_reads_in_jax(jtune, tuner_path):
    import jax.numpy as jnp

    t = Autotuner(tuner_path, sweep=False)
    entries = [
        ("matmul", (64, 256, 512), torch.bfloat16, jnp.bfloat16,
         {"block_m": 128, "block_n": 128, "split_k": 2}),
        ("flash_attention", (6, 96, 16), torch.float32, jnp.float32,
         {"block_q": 32, "block_k": 32}),
        ("rmsnorm", (2048, 4096), torch.bfloat16, jnp.bfloat16, {"block_rows": 4}),
        ("softmax", (4096, 1024), torch.float32, jnp.float32, {"block_rows": 8}),
        ("axpy", (64, 2**22), torch.bfloat16, jnp.bfloat16, {"block": 0}),
        ("dotp", (1, 2**28), torch.float32, jnp.float32, {"block": 65536}),
        ("fft", (65536, 1024), torch.float32, jnp.float32, {"block_rows": 4}),
        ("conv2d", (2, 128, 128, 64), torch.float32, jnp.float32, {"block_h": 8}),
    ]
    for op, shape, tdt, _, cfg in entries:
        t.store(op, shape, tdt, "cuda", cfg)
    jt = jtune.Autotuner(tuner_path, sweep=False)
    for op, shape, _, jdt, cfg in entries:
        assert jt.lookup(op, shape, jdt, "cuda") == cfg
    assert jt._load() == t._load()
