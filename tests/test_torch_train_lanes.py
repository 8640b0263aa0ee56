"""The port's training over lanes (``train/step.py::make_lane_train_step``,
``LM.forward`` on the merged view and ``LM.forward_rows``, the lane
collectives' autograd Functions, ``serve_param_shardings`` over a training
state, ``ft/elastic.py`` over a lane state) against JAX's sharded train step
on the CPU, f32, reduced configs.

The reference is one JAX subprocess over 8 forced host devices (module
fixture) that runs ``jax.jit(make_train_step(model, tcfg), in_shardings=(p,
o, b), out_shardings=(p, o, m))`` over ``SpatzformerCluster`` views, as
``repro/launch/train.py`` does, from the port's ``LM.init`` params (numpy):

- tensor parallelism, dense: reduced codeqwen over (pod 2, data 2, model 2)
  — every leaf under ``MIN_SHARD_ELEMS``, so replicated and sliced per
  lane — at ``grad_accum`` 1, and with a batch of 6 that does not
  divide over the 4 rows (replicated, as JAX's; JAX's model there runs
  without its activation constraints, which over this mesh put its grad
  norm off its own single-device step's: ROADMAP Queue 3); a codeqwen widened so
  every matmul leaf is sharded, over (data 2, model 2), at ``grad_accum`` 2;
- data parallelism over (pod 2, data 2, model 1) for deepseek-v2-lite-16b
  (MoE + MLA: the rows route as one batch), falcon-mamba-7b, zamba2-2.7b
  and musicgen-large (``embeds``), at ``grad_accum`` 1 or 2.

Each case takes 3 steps: loss, aux, grad_norm and lr within 1e-5 relative
each step, the params by ``_param_tol`` (``tests/test_torch_train.py``),
and every replica of every block of params and moments bitwise equal to
the others. Also: gradcheck (f64) of each lane collective over CPU lanes,
the refusals of tensor-parallel training (naming ROADMAP Queue 1 item 10),
the training placement (moments on their parameter's blocks),
``run_elastic`` over a lane training state that loses a pod, and the bf16
trajectory of reduced codeqwen on one lane against JAX's.
"""

import os
import pickle
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt import Checkpointer
from repro_torch.common.tree import flatten_with_path, leaves, tree_map
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.core import SpatzformerCluster
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.dist import collectives
from repro_torch.dist.sharding import (
    MODEL_AXIS,
    P,
    gather,
    lanes_for,
    serve_param_shardings,
)
from repro_torch.ft import run_elastic
from repro_torch.models import LM, params_from_jax
from repro_torch.train import adamw_init, make_train_step
from test_torch_train import _param_tol

ROOT = Path(__file__).resolve().parents[1]
TCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 3
S = 32
WIDE = dict(d_model=128, n_heads=8, n_kv_heads=8, d_head=32, d_ff=512, vocab_size=512)
# key: (arch, config overrides, pods, pod_shape, lanes, grad_accum, batch)
CASES = {
    "tp-replicated-accum1": ("codeqwen1.5-7b", {}, 2, None, 8, 1, 8),
    "tp-replicated-batch6": ("codeqwen1.5-7b", {}, 2, None, 8, 1, 6),
    "tp-sharded-accum2": ("codeqwen1.5-7b", WIDE, 1, None, 4, 2, 8),
    "dp-deepseek-accum2": ("deepseek-v2-lite-16b", {}, 2, (2, 1), 4, 2, 8),
    "dp-falcon-accum1": ("falcon-mamba-7b", {}, 2, (2, 1), 4, 1, 8),
    "dp-zamba2-accum1": ("zamba2-2.7b", {}, 2, (2, 1), 4, 1, 8),
    "dp-musicgen-accum2": ("musicgen-large", {}, 2, (2, 1), 4, 2, 8),
}

# the bf16 trajectory (reduced codeqwen, one batch, 6 steps, lr 3e-3)
BF16 = replace(get_arch("codeqwen1.5-7b").reduced(), dtype="bfloat16")
BF16_TCFG = dict(lr=3e-3, warmup_steps=2, total_steps=100)

_JAX_LANES = r"""
import pickle, sys
from dataclasses import replace
import numpy as np
import repro  # noqa: F401  (jax compat shims first)
import jax, jax.numpy as jnp
from repro.configs import TrainConfig, get_arch
from repro.core import SpatzformerCluster
from repro.dist.sharding import batch_shardings, param_shardings, replicated
from repro.models import LM
from repro.train import adamw_init, make_train_step

CASES, TCFG = %r
with open(sys.argv[2], "rb") as f:
    inp = pickle.load(f)
out = {}
for key, (name, over, pods, shape, n, accum, b) in CASES.items():
    # remat off: the same values, a cheaper compile (the port keeps its remat)
    cfg = replace(get_arch(name).reduced(), remat="none", **over)
    cluster = SpatzformerCluster(n_pods=pods, pod_shape=shape, devices=jax.devices()[:n])
    info = cluster.merge_info() if pods > 1 else cluster.pod_info(0)
    # a batch that does not divide over the rows: the model without its
    # activation constraints (with them, over (2, 2, 2), JAX's grad norm
    # parts from its own single-device step's; ROADMAP Queue 3)
    model = LM(cfg, mesh_info=info if b %% info.data_size == 0 else None)
    params = jax.tree.map(jnp.asarray, inp["params"][key])
    opt = adamw_init(params)
    p_sh = param_shardings(jax.eval_shape(lambda: params), info)
    o_sh = param_shardings(jax.eval_shape(lambda: opt), info)
    params, opt = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
    batches = [jax.tree.map(jnp.asarray, b) for b in inp["batches"][key]]
    b_sh = batch_shardings(jax.eval_shape(lambda: batches[0]), info)
    m_sh = {k: replicated(info) for k in ("loss", "aux", "grad_norm", "lr")}
    step = jax.jit(make_train_step(model, TrainConfig(grad_accum=accum, **TCFG)),
                   in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, m_sh))
    hist = []
    for b in batches:
        params, opt, m = step(params, opt, jax.device_put(b, b_sh))
        hist.append({k: float(v) for k, v in m.items()})
    out[key] = (hist, jax.tree.map(np.asarray, params))
# the bf16 trajectory: reduced codeqwen at bf16, 6 steps on one batch, one device
cfg = replace(get_arch("codeqwen1.5-7b").reduced(), dtype="bfloat16", remat="none")
params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), inp["bf16_in"]["params"])
opt = adamw_init(params)
step = jax.jit(make_train_step(LM(cfg), TrainConfig(**inp["bf16_in"]["tcfg"])))
batch = jax.tree.map(jnp.asarray, inp["bf16_in"]["batch"])
out["bf16"] = []
for _ in range(6):
    params, opt, m = step(params, opt, batch)
    out["bf16"].append(float(m["loss"]))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % ((CASES, TCFG),)


def _cfg(key):
    name, over = CASES[key][:2]
    return replace(get_arch(name).reduced(), **over)


def _batches(cfg, b: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        labels = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
        if cfg.modality == "audio":
            out.append({"embeds": rng.standard_normal((b, S, cfg.d_model)).astype(np.float32),
                        "labels": labels})
        else:
            out.append({"tokens": labels, "labels": labels})
    return out


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """Each case's params (the port's ``LM.init``, numpy) and batches, and
    JAX's metrics and final params over its sharded step (one subprocess, 8
    host devices)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("lanes")
    inp = {"params": {}, "batches": {}}
    for i, key in enumerate(CASES):
        cfg = _cfg(key)
        p = LM(cfg, device="cpu").init(torch.Generator().manual_seed(i))
        inp["params"][key] = tree_map(lambda t: t.numpy(), p)
        inp["batches"][key] = _batches(cfg, CASES[key][6], i)
    p = LM(BF16, device="cpu").init(torch.Generator().manual_seed(0))
    inp["bf16_in"] = dict(params=tree_map(lambda t: t.float().numpy(), p), tcfg=BF16_TCFG,
                       batch=SyntheticCorpus(DataConfig(256, 64, 4, seed=0)).batch(0))
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    out = subprocess.run([sys.executable, "-c", _JAX_LANES, str(tmp / "out.pkl"),
                          str(tmp / "in.pkl")], env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        return dict(pickle.load(f), **inp)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _info(key, devices=None):
    _, _, pods, shape, n = CASES[key][:5]
    cluster = SpatzformerCluster(n_pods=pods, pod_shape=shape,
                                 devices=devices or ["cpu"] * n)
    return cluster.merge_info() if pods > 1 else cluster.pod_info(0)


def _assert_replicas_equal(tree) -> int:
    """Every lane that holds a block of a leaf holds the same bits; returns
    how many leaves have a block on two or more lanes."""
    n = 0
    for x in leaves(tree):
        groups: dict = {}
        for t, block in zip(x.shards, x.sharding.blocks(x.shape)):
            groups.setdefault(block, []).append(t)
        for ts in groups.values():
            for t in ts[1:]:
                assert torch.equal(ts[0], t)
        n += any(len(ts) > 1 for ts in groups.values())
    return n


# ------------------------------------------------------------------ collectives


COLLECTIVES = {
    "broadcast": lambda ps, lanes: torch.stack(
        [o * (j + 1) for j, o in enumerate(collectives.lane_broadcast(ps[0], lanes))]),
    "reduce": lambda ps, lanes: collectives.lane_reduce(ps, lanes),
    "gather": lambda ps, lanes: collectives.lane_gather(ps, lanes, dim=-1) * torch.arange(
        1.0, 16.0, dtype=torch.float64),
    "all_reduce": lambda ps, lanes: torch.stack(
        [o * (j + 1) for j, o in enumerate(collectives.lane_all_reduce(ps, lanes))]),
    "all_gather": lambda ps, lanes: torch.stack(
        [o * (j + 1) for j, o in enumerate(collectives.lane_all_gather(ps, lanes, 0))]),
}


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_lane_collective_gradcheck(name):
    """Each lane collective's backward is its forward's transpose (f64
    gradcheck over three CPU lanes); without grad it is the raw collective
    (the serving path: no Function)."""
    lanes = lanes_for(["cpu"] * 3)
    g = torch.Generator().manual_seed(0)
    ps = [torch.randn(4, 5, dtype=torch.float64, generator=g, requires_grad=True)
          for _ in range(3)]
    fn = COLLECTIVES[name]
    assert torch.autograd.gradcheck(lambda *p: fn(list(p), lanes), ps)
    with torch.no_grad():
        assert fn(ps, lanes).grad_fn is None


# ------------------------------------------------------------------ the step


@pytest.mark.parametrize("key", list(CASES))
def test_lane_train_steps_equal_jax(jx, key):
    """3 steps of the lane train step against JAX's sharded step on the same
    mesh shape: metrics within 1e-5 relative each step, params within
    ``_param_tol``, and every replica bitwise equal to the others."""
    hist, want = jx[key]
    params = params_from_jax(jx["params"][key], device="cpu")
    opt = adamw_init(params)
    step = make_train_step(LM(_cfg(key), device="cpu"),
                           TrainConfig(grad_accum=CASES[key][5], **TCFG), mesh_info=_info(key))
    for i, want_m in enumerate(hist):
        params, opt, m = step(params, opt, _t(jx["batches"][key][i]))
        for k in ("loss", "aux", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(want_m[k], rel=1e-5, abs=1e-7), (i, k)
    assert int(gather(opt.step)) == STEPS
    _param_tol(tree_map(gather, params), want, TCFG["lr"], STEPS)
    assert _assert_replicas_equal((params, opt)) > 0


def test_lane_step_owns_the_placement(monkeypatch):
    """The lane step places a one-lane state (params and moments by
    ``serve_param_shardings``) at its first call; the state it returned
    comes back in place, with no second placement; any other state (here a
    fresh one-lane copy) is placed again."""
    from repro_torch.train import step as step_mod

    calls = []
    put = step_mod.device_put
    monkeypatch.setattr(step_mod, "device_put", lambda *a: calls.append(1) or put(*a))
    cfg = get_arch("codeqwen1.5-7b").reduced()
    info = SpatzformerCluster(n_pods=1, devices=["cpu"] * 4).pod_info(0)
    p = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    step = make_train_step(LM(cfg, device="cpu"), TrainConfig(**TCFG), mesh_info=info)
    batch = _t(SyntheticCorpus(DataConfig(cfg.vocab_size, 16, 4, seed=0)).batch(0))
    state = step(p, adamw_init(p), batch)[:2]
    want = serve_param_shardings(state, info)
    for (k, x), (_, sh) in zip(flatten_with_path(state), flatten_with_path(want)):
        assert x.sharding.spec == sh.spec, k
    ids = [id(x) for x in leaves(state)]
    state = step(*state, batch)[:2]
    assert calls == [1] and [id(x) for x in leaves(state)] == ids
    step(p, adamw_init(p), batch)
    assert calls == [1, 1]


@pytest.mark.cuda
def test_cuda_lanes_take_a_cpu_batch():
    """Four lanes of the card, (data 2, model 2), fed the loader's batch on
    the CPU: each row's copy lands before its lanes read it. The widened
    codeqwen at f32, 3 steps at ``grad_accum`` 1 and 2, against the same
    step over four CPU lanes: metrics within 1e-5 relative, params within
    ``_param_tol``, replicas bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    key = "tp-sharded-accum2"
    cfg = _cfg(key)
    init = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, S, 8, seed=3))
    for accum in (1, 2):
        tcfg = TrainConfig(grad_accum=accum, **TCFG)
        runs = []
        for devices in (["cpu"] * 4, [dev] * 4):
            p = tree_map(lambda t: t.clone(), init)
            o = adamw_init(p)
            step = make_train_step(LM(cfg, device="cpu"), tcfg,
                                   mesh_info=_info(key, devices=devices))
            ms = []
            for i in range(STEPS):
                p, o, m = step(p, o, _t(corpus.batch(i)))
                ms.append({k: float(v) for k, v in m.items()})
            runs.append((p, o, ms))
        (pc, _, mc), (pg, og, mg) = runs
        for a, b in zip(mg, mc):
            for k in ("loss", "aux", "grad_norm", "lr"):
                assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), (accum, k)
        _param_tol(tree_map(lambda x: gather(x).cpu(), pg),
                   tree_map(lambda x: gather(x).numpy(), pc), TCFG["lr"], STEPS)
        assert _assert_replicas_equal((pg, og)) > 0


def test_sharded_placement_keeps_moments_with_params():
    """The widened codeqwen over (data 2, model 2): every matmul leaf is
    sharded (wo by heads), the norms replicated, and each moment sits on its
    parameter's blocks (the one rule, ``serve_param_shardings``, over the
    state)."""
    key = "tp-sharded-accum2"
    info = _info(key)
    p = LM(_cfg(key), device="cpu").init(torch.Generator().manual_seed(0))
    state = (p, adamw_init(p))
    sh = serve_param_shardings(state, info)
    specs = {k: s.spec for k, s in flatten_with_path(sh)}
    want = {"wq": P(None, None, MODEL_AXIS, None), "wo": P(None, MODEL_AXIS, None, None),
            "w_in": P(None, None, MODEL_AXIS), "w_out": P(None, MODEL_AXIS, None),
            "tok": P(MODEL_AXIS, None), "head": P(None, MODEL_AXIS), "norm1": P()}
    for leaf, spec in want.items():
        hits = [v for k, v in specs.items() if k.endswith(f"['{leaf}']")]
        assert len(hits) == 3 and all(h == spec for h in hits), (leaf, hits)
    assert specs["[1].step"] == P()


@pytest.mark.parametrize("name", ["minicpm3-4b", "deepseek-v2-lite-16b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "qwen3-32b"])
def test_tensor_parallel_training_refusals(name):
    """Over (pod 2, data 2, model 2) every family the merged view does not
    take (MLA, MoE, ssm, hybrid, KV heads that do not divide) raises,
    naming ROADMAP Queue 1 item 10; the same families train data-parallel."""
    model = LM(get_arch(name).reduced(), device="cpu")
    info = SpatzformerCluster(n_pods=2, devices=["cpu"] * 8).merge_info()
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        make_train_step(model, TrainConfig(**TCFG), mesh_info=info)
    dp = SpatzformerCluster(n_pods=2, pod_shape=(4, 1), devices=["cpu"] * 8).merge_info()
    assert callable(make_train_step(model, TrainConfig(**TCFG), mesh_info=dp))


def test_data_rows_refuse_serving():
    """An ``LM`` is one lane or one (data=1, model=N) view: a view of several
    data rows raises there, naming the train step that takes it."""
    with pytest.raises(ValueError, match=r"make_train_step\(\.\.\., mesh_info=\)"):
        LM(get_arch("codeqwen1.5-7b").reduced(),
           mesh_info=SpatzformerCluster(n_pods=2, devices=["cpu"] * 8).merge_info())


def test_run_elastic_on_a_lane_state_equal_jax(jx, tmp_path):
    """A lane training state over (pod 2, data 2, model 2) loses pod 1 at
    step 2, after the checkpoint of step 2: it is restored onto the
    survivors' (data 2, model 2) view by JAX's rule (``param_shardings``),
    the lane step places it its own way, and the third step's params equal
    JAX's three straight steps within ``_param_tol``."""
    key = "tp-replicated-accum1"
    hist, want = jx[key]
    cluster = SpatzformerCluster(n_pods=2, devices=["cpu"] * 8)
    seen = []

    def make_state(info):
        p = params_from_jax(jx["params"][key], device="cpu")
        return p, adamw_init(p)

    def factory(info):
        seen.append(info.mesh.shape)
        step = make_train_step(LM(_cfg(key), device="cpu"), TrainConfig(**TCFG), mesh_info=info)

        def run(state, batch, i):
            params, opt, m = step(*state, batch)
            assert float(m["loss"]) == pytest.approx(hist[i]["loss"], rel=1e-5)
            return params, opt

        return run

    state, rep = run_elastic(cluster, make_state, factory,
                             lambda i: _t(jx["batches"][key][i]),
                             Checkpointer(str(tmp_path), keep=3), total_steps=STEPS,
                             ckpt_every=1, fail_at={2: 1})
    assert (rep.steps_done, rep.failures, rep.restarts) == (STEPS, 1, [(2, 4)])
    assert seen == [{"pod": 2, "data": 2, "model": 2}, {"data": 2, "model": 2}]
    _param_tol(tree_map(gather, state[0]), want, TCFG["lr"], STEPS)
    _assert_replicas_equal(state)


def test_bf16_trajectory_within_rounding(jx):
    """Reduced codeqwen at bf16, 6 steps on one batch, one lane, against JAX's
    (the check ROADMAP Queue 3 asked for): every loss within 2e-3 relative,
    one bf16 rounding of a logit (2^-9); the two packages round their bf16
    GEMMs and sums in other orders. Both fall on the batch."""
    p = LM(BF16, device="cpu").init(torch.Generator().manual_seed(0))
    opt = adamw_init(p)
    step = make_train_step(LM(BF16, device="cpu"), TrainConfig(**BF16_TCFG))
    batch = _t(jx["bf16_in"]["batch"])
    got = []
    for _ in range(6):
        p, opt, m = step(p, opt, batch)
        got.append(float(m["loss"]))
    for a, b in zip(got, jx["bf16"]):
        assert abs(a - b) <= 2e-3 * abs(b), (got, jx["bf16"])
    assert got[-1] < got[0] and jx["bf16"][-1] < jx["bf16"][0]
