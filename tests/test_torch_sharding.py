"""The port's partition rules and tree builders (``dist/sharding.py``) against
the JAX package's (``repro/dist/sharding.py``), leaf by leaf.

CPU only, no card, no tensor allocated at full width:
- ``spec_for_param`` over every leaf of every registry config, shapes from
  ``jax.eval_shape`` of the JAX ``LM.init`` at full width and at
  ``.reduced()``, at model_size 1, 2, 4, 8 and 16;
- the port's tree paths (``keystr``) of its own ``LM.init`` at reduced width
  are JAX's ``jax.tree_util.keystr`` of the JAX params, leaf for leaf;
- ``_add_fsdp_dim`` at two thresholds (2**22 and the default 2**24) over the
  full-width leaves at data sizes 1, 2, 4 and 8;
- ``spec_for_batch`` on odd and even batches;
- the builders on meshes with model_size > 1, compared inside one
  subprocess with 16 forced host devices (JAX needs a mesh of that size):
  ``param_shardings`` (plain and FSDP at both thresholds) over full-width
  and reduced meta-tensor trees, ``batch_shardings``, and
  ``serve_cache_shardings`` on the reduced codeqwen (plain and int8),
  minicpm3 (MLA), falcon-mamba (SSM) and zamba2 (hybrid) caches, over
  ``(data, model)`` meshes of 16 lanes at model_size 1-16 and a
  ``(pod, data, model)`` mesh whose batch axes are a tuple.

Specs must be equal (1-tuples compared as their axis name, as JAX 0.9 keeps
them). JAX is imported inside the fixtures only.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.dist import sharding as sh
from repro_torch.models import LM

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(ARCHS)
MODEL_SIZES = (1, 2, 4, 8, 16)
FSDP_THRESHOLDS = (2**22, 2**24)
# (name, kv_dtype) of the serving caches held against JAX's
CACHES = (("codeqwen1.5-7b", None), ("codeqwen1.5-7b", "int8"), ("minicpm3-4b", None),
          ("falcon-mamba-7b", None), ("zamba2-2.7b", None))
CACHE_B, CACHE_S = 2, 16
BATCHES = (1, 3, 8, 12, 16, 24)
# the 16-lane meshes of the builders: (data, model) at each model size, and
# one (pod, data, model) view whose batch axes are ("pod", "data")
MESHES = [((16 // m, m), ("data", "model"), ("data",)) for m in MODEL_SIZES] + [
    ((2, 4, 2), ("pod", "data", "model"), ("pod", "data"))]

_JAX_BUILDERS = r"""
import json, sys
import repro  # noqa: F401
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS, get_arch
from repro.dist.sharding import (MeshInfo, batch_shardings, param_shardings,
                                 serve_cache_shardings)
from repro.models.model import LM

meshes, caches, batches, thresholds = json.loads(sys.argv[1])
devs = np.array(jax.devices())
assert devs.size == 16, devs.size

def specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): [list(e) if isinstance(e, tuple) else e for e in s.spec]
            for p, s in flat}

out = {"params": {}, "batch": {}, "cache": {}}
for shape, axes, batch_axes in meshes:
    info = MeshInfo(Mesh(devs.reshape(shape), tuple(axes)), batch_axes=tuple(batch_axes))
    key = "x".join(map(str, shape))
    for name in sorted(ARCHS):
        for red in (False, True):
            cfg = get_arch(name).reduced() if red else get_arch(name)
            tree = jax.eval_shape(LM(cfg).init, jax.random.key(0))
            out["params"][f"{key}/{name}/{red}/plain"] = specs(param_shardings(tree, info))
            for t in thresholds:
                out["params"][f"{key}/{name}/{red}/fsdp{t}"] = specs(
                    param_shardings(tree, info, fsdp=True, fsdp_threshold=t))
    out["batch"][key] = specs(batch_shardings(
        {f"b{b}": {"tokens": jax.ShapeDtypeStruct((b, 7), jnp.int32),
                   "scalar": jax.ShapeDtypeStruct((), jnp.float32)} for b in batches}, info))
    for name, kvd in caches:
        cache = jax.eval_shape(lambda: LM(get_arch(name).reduced()).init_cache(
            %d, %d, None if kvd is None else jnp.dtype(kvd)))
        out["cache"][f"{key}/{name}/{kvd}"] = specs(serve_cache_shardings(cache, info))
print(json.dumps(out))
""" % (CACHE_B, CACHE_S)


def _canon(spec) -> tuple:
    """A spec as a tuple of None / axis name / tuple of axis names."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import repro  # noqa: F401
    from repro.configs import get_arch as jget_arch
    from repro.dist import sharding as jsh
    from repro.models.model import LM as JaxLM

    shapes = {}
    for name in NAMES:
        for red in (False, True):
            cfg = jget_arch(name).reduced() if red else jget_arch(name)
            shapes[name, red] = jax.eval_shape(JaxLM(cfg).init, jax.random.key(0))
    return dict(jax=jax, sh=jsh, shapes=shapes)


def _leaves(jx, tree):
    """[(keystr path, shape)] of a JAX shape tree."""
    flat, _ = jx["jax"].tree_util.tree_flatten_with_path(tree)
    return [(jx["jax"].tree_util.keystr(p), tuple(s.shape)) for p, s in flat]


def _meta(jx, tree):
    """A JAX shape tree as nested dicts of meta tensors (no storage)."""
    return jx["jax"].tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


def _port_specs(tree) -> dict:
    out = {}
    sh.tree_map_with_path(lambda p, s: out.__setitem__(sh.keystr(p), tuple(s.spec)), tree)
    return out


def _lane_info(shape, axes, batch_axes) -> sh.MeshInfo:
    lanes = sh.lanes_for(["cpu"] * 16)
    return sh.MeshInfo(sh.Mesh(sh.lane_grid(lanes, tuple(shape)), tuple(axes)),
                       batch_axes=tuple(batch_axes))


@pytest.fixture(scope="module")
def jax_builders():
    """The JAX builders' specs over 16 forced host devices (one subprocess)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    arg = json.dumps([MESHES, CACHES, BATCHES, FSDP_THRESHOLDS])
    out = subprocess.run([sys.executable, "-c", _JAX_BUILDERS, arg], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", NAMES)
def test_spec_for_param_equals_jax(jx, name):
    n = 0
    for red in (False, True):
        for path, shape in _leaves(jx, jx["shapes"][name, red]):
            for ms in MODEL_SIZES:
                want = _canon(jx["sh"].spec_for_param(path, len(shape), shape, ms))
                got = tuple(sh.spec_for_param(path, len(shape), shape, ms))
                assert got == want, (name, red, path, shape, ms)
                n += 1
    assert n >= 2 * 10 * len(MODEL_SIZES)


@pytest.mark.parametrize("name", NAMES)
def test_port_params_have_jax_paths(jx, name):
    """The port's own param tree (reduced, CPU) renders JAX's leaf paths
    and shapes, so the rules see what they see in the JAX package."""
    m = LM(get_arch(name).reduced(), device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    got = {}
    sh.tree_map_with_path(lambda p, t: got.__setitem__(sh.keystr(p), tuple(t.shape)), params)
    assert got == dict(_leaves(jx, jx["shapes"][name, True]))


@pytest.mark.parametrize("threshold", FSDP_THRESHOLDS)
def test_add_fsdp_dim_equals_jax(jx, threshold):
    from jax.sharding import Mesh

    jinfo = jx["sh"].MeshInfo(Mesh(np.array(jx["jax"].devices()[:1]).reshape(1, 1),
                                   ("data", "model")))
    info = sh.MeshInfo(sh.Mesh(sh.lane_grid(sh.lanes_for(["cpu"]), (1, 1)), ("data", "model")))
    n = 0
    for name in NAMES:
        for path, shape in _leaves(jx, jx["shapes"][name, False]):
            for ms, ds in ((2, 1), (4, 2), (8, 4), (2, 8)):
                spec = sh.spec_for_param(path, len(shape), shape, ms)
                want = jx["sh"]._add_fsdp_dim(jx["sh"].spec_for_param(path, len(shape), shape, ms),
                                              shape, jinfo, ds, threshold)
                got = sh._add_fsdp_dim(spec, shape, info, ds, threshold)
                assert tuple(got) == _canon(want), (name, path, shape, ms, ds)
                n += got != spec
    assert n > 0  # the threshold put the batch axes on some leaves


def test_spec_for_batch_equals_jax(jx):
    for b in BATCHES + (0, 5, 7):
        for shape in ((b,), (b, 9), (b, 3, 4)):
            for ds in (1, 2, 3, 4, 8):
                for axes in (("data",), ("pod", "data")):
                    want = jx["sh"].spec_for_batch(shape, ds, axes)
                    assert tuple(sh.spec_for_batch(shape, ds, axes)) == _canon(want)
    assert tuple(sh.spec_for_batch((), 2, ("data",))) == ()


@pytest.mark.parametrize("name", NAMES)
def test_param_shardings_equal_jax(jx, jax_builders, name):
    for shape, axes, batch_axes in MESHES:
        info = _lane_info(shape, axes, batch_axes)
        key = "x".join(map(str, shape))
        for red in (False, True):
            tree = _meta(jx, jx["shapes"][name, red])
            variants = {"plain": {}} | {f"fsdp{t}": dict(fsdp=True, fsdp_threshold=t)
                                        for t in FSDP_THRESHOLDS}
            for tag, kw in variants.items():
                want = {p: _canon(s) for p, s in
                        jax_builders["params"][f"{key}/{name}/{red}/{tag}"].items()}
                got = _port_specs(sh.param_shardings(tree, info, **kw))
                assert got == want, (key, red, tag)
                assert _port_specs(sh.opt_shardings(tree, info, **kw)) == want


def test_batch_shardings_equal_jax(jax_builders):
    tree = {f"b{b}": {"tokens": torch.empty((b, 7), device="meta"),
                      "scalar": torch.empty((), device="meta")} for b in BATCHES}
    for shape, axes, batch_axes in MESHES:
        info = _lane_info(shape, axes, batch_axes)
        want = {p: _canon(s) for p, s in jax_builders["batch"]["x".join(map(str, shape))].items()}
        assert _port_specs(sh.batch_shardings(tree, info)) == want
        assert tuple(sh.replicated(info).spec) == ()
        assert {s for s in _port_specs(sh.serve_state_shardings(tree, info)).values()} == {()}


@pytest.mark.parametrize("name,kv_dtype", CACHES)
def test_serve_cache_shardings_equal_jax(jax_builders, name, kv_dtype):
    m = LM(get_arch(name).reduced(), device="cpu")
    cache = m.init_cache(CACHE_B, CACHE_S, None if kv_dtype is None else getattr(torch, kv_dtype))
    sharded = 0
    for shape, axes, batch_axes in MESHES:
        info = _lane_info(shape, axes, batch_axes)
        key = "x".join(map(str, shape))
        want = {p: _canon(s) for p, s in jax_builders["cache"][f"{key}/{name}/{kv_dtype}"].items()}
        got = _port_specs(sh.serve_cache_shardings(cache, info))
        assert got == want, key
        sharded += sum("model" in s for s in got.values())
    assert sharded > 0
