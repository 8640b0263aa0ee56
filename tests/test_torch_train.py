"""The port's training path (``models/model.py::LM.forward``, ``train/``,
``data/``, ``dist/compression.py``'s int8 ring over lanes, ``ft/elastic.py``)
against the JAX package on the CPU, f32, reduced configs (2 layers; zamba2
4), all from one JAX subprocess over 4 forced host devices (module fixture)
that writes its params and results to a pickle:

The params are the port's ``LM.init`` from a seed, handed to JAX as numpy
(the layouts are one); JAX's results come back through ``params_from_jax``.

- ``LM.forward`` logits and aux of codeqwen1.5-7b, qwen3-32b (G 4,
  qk_norm), minicpm3-4b (MLA), deepseek-v2-lite-16b (MoE + MLA),
  falcon-mamba-7b, zamba2-2.7b and musicgen-large (through ``embeds``) at B
  2 x S 96 (two KV chunks of 64, the second padded), under both
  ``attn_impl`` values: within 2e-5 of the largest |logit| (f32 sums in
  other orders through two layers), aux within 1e-6;
- remat: ``remat="block"`` against ``"none"`` on the port, the same loss and
  grads (within 1e-5 of each leaf's largest), and no [.., Sq, chunk] score
  block saved for backward across blocks;
- ``next_token_loss`` and its logits grad, and the loss grads of codeqwen
  and deepseek-v2-lite (aux included): loss within 1e-6 relative, each grad
  leaf within 1e-4 of its largest element;
- ``warmup_cosine`` at every step 0..100: within 1e-6 relative (one f32
  cosine rounding);
- three ``make_train_step`` steps at ``grad_accum`` 1 and 2 from one
  optimizer state: metrics within 1e-5 relative; params within
  ``_param_tol`` (see there: Adam turns a grad that sits at the noise floor
  into a full step of either sign, so such elements are counted and bounded,
  not held); accumulation over 2 microbatches against one batch (JAX's
  ``test_grad_accum_equivalence``);
- ``SyntheticCorpus`` bitwise, a ``PrefetchLoader`` restart, and
  ``loader_for`` at the ``train_4k`` cell bitwise against JAX's;
- the shape cells (``SHAPES``, ``get_shape``, ``applicable`` through
  ``all_cells``, ``ArchConfig.sub_quadratic``): equal to JAX's;
- ``quantize`` against JAX's: bitwise; ``ring_allreduce_q8`` over 2 and 4
  lanes against JAX's ``shard_map``: within 2 f32 ulps of the largest mean
  (the same dequantized terms, summed in the ring's order; XLA fuses the
  adds its own way);
- the compressed-DP step over 2 lanes against JAX's over 2 devices;
- ``run_elastic``'s report and state against JAX's (a failure after a
  checkpoint, and one before the first); and ``run_elastic`` on a training
  state ``(params, AdamWState)`` placed by ``param_shardings``, whose three
  steps (one on the survivors) match JAX's three straight steps within
  ``_param_tol``;
- the training forward reaches no kernel: every ``ops`` entry raises, and
  ``attention_apply`` without ``return_kv`` goes through
  ``chunked_attention`` (or ``dense_attention``).
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
from repro_torch.common.tree import leaves, tree_map
from repro_torch.configs import ARCHS, SHAPES, TrainConfig, all_cells, get_arch, get_shape
from repro_torch.core import SpatzformerCluster
from repro_torch.data import DataConfig, PrefetchLoader, SyntheticCorpus, loader_for
from repro_torch.dist.compression import dequantize, quantize, ring_allreduce_q8
from repro_torch.dist.sharding import (
    Mesh,
    NamedSharding,
    P,
    ShardedTensor,
    device_put,
    gather,
    lanes_for,
    param_shardings,
)
from repro_torch.ft import run_elastic
from repro_torch.kernels import ops
from repro_torch.models import LM, attention as attn_mod, params_from_jax
from repro_torch.train import (
    AdamWState,
    adamw_init,
    make_compressed_dp_train_step,
    make_loss_fn,
    make_train_step,
    next_token_loss,
    value_and_grad,
    warmup_cosine,
)

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("codeqwen1.5-7b", "qwen3-32b", "minicpm3-4b", "deepseek-v2-lite-16b",
            "falcon-mamba-7b", "zamba2-2.7b", "musicgen-large")
B, S = 2, 96
TCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 3
SCHED = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)

_JAX_TRAIN = r"""
import pickle, sys
from dataclasses import replace
import numpy as np
import repro  # noqa: F401  (jax compat shims first)
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import TrainConfig, get_arch
from repro.data import DataConfig, PrefetchLoader, SyntheticCorpus
from repro.dist.compression import quantize, ring_allreduce_q8
from repro.models import LM
from repro.train import adamw_init, make_compressed_dp_train_step, make_loss_fn, make_train_step
from repro.train.loss import next_token_loss
from repro.train.optimizer import warmup_cosine

FAMILIES, B, S, TCFG, STEPS, SCHED = %r
np_ = lambda t: jax.tree.map(np.asarray, t)
opt_np = lambda o: {"step": np.asarray(o.step), "mu": np_(o.mu), "nu": np_(o.nu)}
with open(sys.argv[2], "rb") as f:  # the params of every family, numpy (same layout)
    all_params = pickle.load(f)
out = {"forward": {}}
rng = np.random.default_rng(0)
for name in FAMILIES:
    base = get_arch(name).reduced()
    params = jax.tree.map(jnp.asarray, all_params[name])
    if name == "musicgen-large":
        batch = {"embeds": rng.standard_normal((B, S, base.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, base.vocab_size, (B, S)).astype(np.int32)}
    for impl in (("chunked",) if base.family == "ssm" else ("chunked", "dense")):
        m = LM(replace(base, attn_impl=impl))
        logits, aux = jax.jit(m.forward)(params, batch)
        out["forward"][name, impl] = (batch, np.asarray(logits), np.asarray(aux))

# next_token_loss and its grad
lg = rng.standard_normal((2, 16, 256)).astype(np.float32) * 3
lb = rng.integers(0, 256, (2, 16)).astype(np.int32)
l, g = jax.value_and_grad(lambda x: next_token_loss(x, lb))(lg)
out["ntl"] = (lg, lb, np.asarray(l), np.asarray(g))

# the loss grads of two families (deepseek: the aux loss too); no remat on
# this side (the same values, a cheaper compile), the port's default remat
out["grads"] = {}
for name in ("codeqwen1.5-7b", "deepseek-v2-lite-16b"):
    batch, _, _ = out["forward"][name, "chunked"]
    batch = dict(batch, labels=batch["tokens"])
    model = LM(replace(get_arch(name).reduced(), remat="none"))
    params = jax.tree.map(jnp.asarray, all_params[name])
    (loss, m), g = jax.jit(jax.value_and_grad(make_loss_fn(model), has_aux=True))(params, batch)
    out["grads"][name] = (batch, float(loss), float(m["aux"]), np_(g))

# the schedule at every step
cfg = TrainConfig(**SCHED)
out["sched"] = np.asarray(warmup_cosine(cfg)(jnp.arange(cfg.total_steps + 1, dtype=jnp.int32)))

# train steps at grad_accum 1 and 2 (codeqwen), batches from the corpus
name = "codeqwen1.5-7b"
model = LM(replace(get_arch(name).reduced(), remat="none"))
corpus = SyntheticCorpus(DataConfig(256, 48, 4, seed=2))
out["corpus"] = [corpus.batch(i) for i in range(STEPS)]
out["steps"] = {}
for accum in (1, 2):
    step = jax.jit(make_train_step(model, TrainConfig(grad_accum=accum, **TCFG)))
    params = jax.tree.map(jnp.asarray, all_params[name])
    opt = adamw_init(params)
    hist = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, out["corpus"][i]))
        hist.append(({k: float(v) for k, v in m.items()}, np_(params), opt_np(opt)))
    out["steps"][accum] = hist
loader = PrefetchLoader(SyntheticCorpus(DataConfig(1000, 16, 4, seed=9)), start_step=3)
out["loader"] = [next(loader)["tokens"] for _ in range(2)]
loader.close()

# quantize and the int8 ring over 2 and 4 devices
x = rng.standard_normal(2500).astype(np.float32) * 5
q, s = quantize(jnp.asarray(x))
out["quantize"] = (x, np.asarray(q), np.asarray(s))
out["ring"] = {}
for p in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:p]), ("model",))
    vals = rng.standard_normal((p, 2500)).astype(np.float32)
    h = jax.jit(jax.shard_map(lambda v: ring_allreduce_q8(v[0], "model")[None], mesh=mesh,
                              in_specs=(P("model", None),), out_specs=P("model", None)))
    out["ring"][p] = (vals, np.asarray(h(vals)))

# the compressed-DP step over 2 devices (codeqwen)
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
step = make_compressed_dp_train_step(model, TrainConfig(**TCFG), mesh)
params = jax.tree.map(jnp.asarray, all_params[name])
opt = adamw_init(params)
ef = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
hist = []
for i in range(STEPS):
    params, opt, ef, m = step(params, opt, ef, jax.tree.map(jnp.asarray, out["corpus"][i]))
    hist.append(({k: float(v) for k, v in m.items()}, np_(params), np_(ef)))
out["dp"] = hist

# run_elastic: a 2-pod cluster over 4 devices, a pod lost after / before a checkpoint
import tempfile
from repro.ckpt import Checkpointer
from repro.core import SpatzformerCluster
from repro.ft import run_elastic
out["elastic"] = {}
for fail_at in ({7: 0}, {2: 1}):
    def make_state(info):
        return {"w": jnp.zeros((8,)), "n": jnp.int32(0)}
    def factory(info):
        f = jax.jit(lambda st, b: {"w": st["w"] + b["x"], "n": st["n"] + 1})
        return lambda st, b, i: f(st, b)
    state, rep = run_elastic(SpatzformerCluster(n_pods=2), make_state, factory,
                             lambda i: {"x": jnp.full((8,), float(i))},
                             Checkpointer(tempfile.mkdtemp(), keep=3), total_steps=12,
                             ckpt_every=5, fail_at=dict(fail_at))
    out["elastic"][str(fail_at)] = (
        [rep.steps_done, rep.failures, rep.final_devices, [list(r) for r in rep.restarts]],
        np_(state))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % ((FAMILIES, B, S, TCFG, STEPS, SCHED),)


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """Every family's params (the port's ``LM.init`` from a seed, as numpy)
    and the JAX package's results on them (one subprocess, 4 host
    devices)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("train")
    params = {}
    for i, name in enumerate(FAMILIES):
        p = LM(get_arch(name).reduced(), device="cpu").init(torch.Generator().manual_seed(i))
        params[name] = tree_map(lambda t: t.numpy(), p)
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    # XLA's cheaper compile (no LLVM optimisation passes): the same
    # functions, compiled in about half the time
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    out = subprocess.run([sys.executable, "-c", _JAX_TRAIN, str(tmp / "jax.pkl"),
                          str(tmp / "params.pkl")], env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        return dict(pickle.load(f), params=params)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Tiny f32 work: one intra-op thread a worker (the suite runs several
    workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(jx, name):
    return params_from_jax(jx["params"][name], device="cpu")


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _model(name, **over):
    return LM(replace(get_arch(name).reduced(), **over), device="cpu")


def _near(got, want, rel):
    """|got - want| <= rel * max|want| elementwise."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------ forward


CASES = [(n, i) for n in FAMILIES for i in ("chunked", "dense")
         if not (n == "falcon-mamba-7b" and i == "dense")]


@pytest.mark.parametrize("name,impl", CASES, ids=[f"{n}-{i}" for n, i in CASES])
def test_forward_logits_and_aux_equal_jax(jx, name, impl):
    batch, want, want_aux = jx["forward"][name, impl]
    logits, aux = _model(name, attn_impl=impl).forward(_params(jx, name), _t(batch))
    _near(logits.detach(), want, 2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=1e-6)
    if name == "deepseek-v2-lite-16b":
        assert float(aux) > 0  # the one MoE layer's load-balance loss


def test_remat_changes_no_value_and_keeps_no_chunk(jx):
    """remat='block' against 'none': the same loss and grads; and under
    remat no chunk of the attention is saved for backward across blocks
    (the saved tensors of the forward are the blocks' inputs and views of
    the params, none of them a [.., Sq, chunk] score block)."""
    name = "codeqwen1.5-7b"
    batch = _t(jx["grads"][name][0])
    p = _params(jx, name)
    out = {}
    for remat in ("none", "block"):
        model = _model(name, remat=remat)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
            (loss, _), g = value_and_grad(make_loss_fn(model), p, batch)
        out[remat] = (float(loss), leaves(g), saved)
    assert out["none"][0] == pytest.approx(out["block"][0], rel=1e-6)
    for a, b in zip(out["none"][1], out["block"][1]):
        _near(b, a, 1e-5)
    chunk = get_arch(name).reduced().attn_chunk
    assert any(s[-1:] == (chunk,) for s in out["none"][2])  # without remat: kept
    assert not any(s[-1:] == (chunk,) and len(s) >= 4 for s in out["block"][2])


def test_training_forward_reaches_no_kernel(jx, monkeypatch):
    """Every ``ops`` entry raises; each family's loss and grads still come
    out, attention through the chunked (and dense) functions."""
    for fn in [f for f in dir(ops) if not f.startswith("_") and callable(getattr(ops, f))]:
        monkeypatch.setattr(ops, fn, lambda *a, _fn=fn, **k: pytest.fail(f"ops.{_fn} called"))
    calls = {"chunked": 0, "dense": 0}
    for impl in calls:
        real = getattr(attn_mod, f"{impl}_attention")

        def counted(*a, _real=real, _impl=impl, **k):
            calls[_impl] += 1
            return _real(*a, **k)

        monkeypatch.setattr(attn_mod, f"{impl}_attention", counted)
    for name in ("codeqwen1.5-7b", "minicpm3-4b", "zamba2-2.7b"):
        for impl in ("chunked", "dense"):
            batch, _, _ = jx["forward"][name, impl]
            batch = _t(dict(batch, labels=batch["tokens"]))
            (loss, _), _ = value_and_grad(make_loss_fn(_model(name, attn_impl=impl)),
                                          _params(jx, name), batch)
            assert np.isfinite(float(loss))
    # codeqwen and minicpm3: 2 layers; zamba2: 2 shared-block invocations;
    # with remat, each forward runs again in backward
    assert calls == {"chunked": 12, "dense": 12}


# ------------------------------------------------------------------ loss


def test_next_token_loss_and_grad_equal_jax(jx):
    lg, lb, want, want_g = jx["ntl"]
    x = torch.from_numpy(lg).requires_grad_(True)
    loss = next_token_loss(x, torch.from_numpy(lb))
    (g,) = torch.autograd.grad(loss, x)
    loss = loss.detach()
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    _near(g, want_g, 1e-6)


@pytest.mark.parametrize("name", ["codeqwen1.5-7b", "deepseek-v2-lite-16b"])
def test_loss_grads_equal_jax(jx, name):
    batch, want, want_aux, want_g = jx["grads"][name]
    (loss, m), g = value_and_grad(make_loss_fn(_model(name)), _params(jx, name), _t(batch))
    assert float(loss) == pytest.approx(want, rel=1e-6)
    assert float(m["aux"]) == pytest.approx(want_aux, rel=1e-6, abs=1e-7)
    flat_want = leaves(params_from_jax(want_g, device="cpu"))
    assert len(leaves(g)) == len(flat_want)
    for a, b in zip(leaves(g), flat_want):
        _near(a, b, 1e-4)


def test_warmup_cosine_every_step_equal_jax(jx):
    got = warmup_cosine(TrainConfig(**SCHED))(torch.arange(SCHED["total_steps"] + 1))
    np.testing.assert_allclose(got.numpy(), jx["sched"], rtol=1e-6, atol=0)
    assert float(got[0]) == 0.0 and got.dtype == torch.float32


# ------------------------------------------------------------------ train steps


def _param_tol(got: dict, want: dict, lr: float, steps: int) -> None:
    """Params after ``steps`` AdamW steps against JAX's. Every element moves
    by about lr · m̂/sqrt(v̂) a step, |.| <= ~1 / (1 - b1) in the worst case:
    a gradient element that is pure rounding noise (the two packages sum in
    other orders) may take a step of either sign, so a difference up to
    2 · lr · steps is possible there. Elements within 1e-6 of their leaf's
    scale hold; the rest must be few (under 2%) and within 2 · lr · steps."""
    n_off = n = 0
    for a, b in zip(leaves(got), leaves(params_from_jax(want, device="cpu"))):
        d = (a - b).abs()
        tol = 1e-6 * max(float(b.abs().max()), 1.0)
        n_off += int((d > tol).sum())
        n += d.numel()
        assert float(d.max()) <= 2 * lr * steps, float(d.max())
    assert n_off <= 0.02 * n, (n_off, n)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_equal_jax(jx, accum):
    name = "codeqwen1.5-7b"
    params = _params(jx, name)
    opt = adamw_init(params)
    step = make_train_step(_model(name), TrainConfig(grad_accum=accum, **TCFG))
    for i, (want_m, want_p, want_o) in enumerate(jx["steps"][accum]):
        params, opt, m = step(params, opt, _t(jx["corpus"][i]))
        for k in ("loss", "aux", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(want_m[k], rel=1e-5, abs=1e-7), (i, k)
        assert int(opt.step) == int(want_o["step"]) == i + 1
        _param_tol(params, want_p, TCFG["lr"], i + 1)
        _near(leaves(opt.mu)[0], leaves(want_o["mu"])[0], 1e-3)


def test_grad_accum_matches_one_batch(jx):
    """2 microbatches of 2 against the batch of 4 (the same tokens): JAX's
    ``test_grad_accum_equivalence`` tolerances, on the port; and the port's
    accum-2 step equals JAX's accum-2 step (above)."""
    name = "codeqwen1.5-7b"
    outs = []
    for accum in (1, 2):
        params = _params(jx, name)
        step = make_train_step(_model(name), TrainConfig(grad_accum=accum, **TCFG))
        params, _, m = step(params, adamw_init(params), _t(jx["corpus"][0]))
        outs.append((params, float(m["loss"])))
    (p1, l1), (p2, l2) = outs
    assert abs(l1 - l2) < 5e-3
    for a, b in zip(leaves(p1), leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2, atol=2e-4)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(_model(name), TrainConfig(grad_accum=3))(
            _params(jx, name), adamw_init(_params(jx, name)), _t(jx["corpus"][0]))


# ------------------------------------------------------------------ data


def test_corpus_bitwise_and_loader_restart(jx):
    corpus = SyntheticCorpus(DataConfig(256, 48, 4, seed=2))
    for i, want in enumerate(jx["corpus"]):
        got = corpus.batch(i)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    loader = PrefetchLoader(SyntheticCorpus(DataConfig(1000, 16, 4, seed=9)), start_step=0,
                            device="cpu")
    first = [next(loader)["tokens"] for _ in range(5)]
    loader.close()
    assert not loader._thread.is_alive()
    loader = PrefetchLoader(SyntheticCorpus(DataConfig(1000, 16, 4, seed=9)), start_step=3,
                            device="cpu")
    again = [next(loader)["tokens"] for _ in range(2)]
    assert loader.step == 5
    loader.close()
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.int32 for t in again)
    for a, b, j in zip(again, first[3:], jx["loader"]):
        assert torch.equal(a, b) and np.array_equal(a.numpy(), j)


def test_loader_for_bitwise_equal_jax():
    """``loader_for`` at the train_4k cell (reduced codeqwen's vocabulary):
    the first two batches bitwise JAX's, as int32 tensors on the CPU."""
    jcfg = pytest.importorskip("repro.configs")
    jdata = pytest.importorskip("repro.data")
    name = "codeqwen1.5-7b"
    got = loader_for(get_arch(name).reduced(), get_shape("train_4k"), seed=4, device="cpu")
    want = jdata.loader_for(jcfg.get_arch(name).reduced(), jcfg.get_shape("train_4k"), seed=4)
    try:
        for _ in range(2):
            a, b = next(got), next(want)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == torch.int32 and a[k].shape == (256, 4096)
                assert np.array_equal(a[k].numpy(), b[k])
    finally:
        got.close()
        want.close()


def test_shape_cells_equal_jax():
    """``SHAPES`` / ``get_shape``, ``sub_quadratic`` of every arch and the
    cells ``all_cells`` keeps under ``applicable``: JAX's, exactly."""
    jcfg = pytest.importorskip("repro.configs")
    assert sorted(SHAPES) == sorted(jcfg.SHAPES)
    for name in SHAPES:
        a, b = get_shape(name), jcfg.get_shape(name)
        assert ((a.name, a.seq_len, a.global_batch, a.kind, a.tokens_per_step)
                == (b.name, b.seq_len, b.global_batch, b.kind, b.tokens_per_step))
    assert {n: ARCHS[n].sub_quadratic for n in ARCHS} == {
        n: jcfg.get_arch(n).sub_quadratic for n in ARCHS}
    assert all_cells() == jcfg.all_cells()
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("train_8k")


# ------------------------------------------------------------------ int8 ring


def test_quantize_bitwise_equal_jax(jx):
    x, want_q, want_s = jx["quantize"]
    q, s = quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), want_q)
    assert np.array_equal(s.numpy(), want_s)
    err = (dequantize(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s.max()) / 2 * (1 + 1e-6)


@pytest.mark.parametrize("p", [2, 4])
def test_ring_allreduce_q8_equal_jax(jx, p):
    vals, want = jx["ring"][p]
    lanes = lanes_for(["cpu"] * p)
    got = ring_allreduce_q8([torch.from_numpy(v) for v in vals], lanes)
    for j in range(p):  # the same dequantized terms; XLA fuses the adds its own way
        np.testing.assert_allclose(got[j].numpy(), want[j], rtol=0,
                                   atol=2 * 2.0**-23 * np.abs(want[j]).max())
    assert np.abs(want[0] - vals.mean(0)).max() < 0.05 * np.abs(vals).max()


def test_compressed_dp_step_equal_jax(jx):
    name = "codeqwen1.5-7b"
    lanes = lanes_for(["cpu", "cpu"])
    mesh = Mesh(lanes, ("data",))
    rep = NamedSharding(mesh, P())

    p0 = _params(jx, name)
    params = device_put(p0, rep)
    o = adamw_init(p0)
    opt = device_put(o, rep)
    ef = device_put({k: v for k, v in o.mu.items()}, rep)
    step = make_compressed_dp_train_step(_model(name), TrainConfig(**TCFG), mesh)
    for i, (want_m, want_p, want_ef) in enumerate(jx["dp"]):
        params, opt, ef, m = step(params, opt, ef, _t(jx["corpus"][i]))
        for k in ("loss", "aux", "lr"):
            assert float(m[k]) == pytest.approx(want_m[k], rel=1e-5, abs=1e-7), (i, k)
        # the int8 ring rounds each grad to its chunk's quantum: a grad that
        # differs in its last bits may land one quantum away, so grad_norm is
        # held to the quantum's share of it
        assert float(m["grad_norm"]) == pytest.approx(want_m["grad_norm"], rel=1e-3)
        for leaf in leaves(params):  # both lanes hold the same copy
            assert torch.equal(leaf.shards[0], leaf.shards[1])
        _param_tol(tree_map(gather, params), want_p, TCFG["lr"], i + 1)


# ------------------------------------------------------------------ elastic


@pytest.mark.parametrize("fail_at", [{7: 0}, {2: 1}], ids=["after-ckpt", "before-ckpt"])
def test_run_elastic_report_equal_jax(jx, tmp_path, fail_at):
    want_rep, want_state = jx["elastic"][str(fail_at)]
    cluster = SpatzformerCluster(n_pods=2, devices=["cpu"] * 4)
    seen = []

    def make_state(info):
        return {"w": torch.zeros(8), "n": torch.tensor(0, dtype=torch.int32)}

    def factory(info):
        seen.append(info.n_devices)

        def step(state, batch, i):
            out = {}
            for k, inc in (("w", batch["x"]), ("n", 1)):
                v = state[k]
                if isinstance(v, ShardedTensor):  # after a restart: on the survivors
                    out[k] = device_put(gather(v) + inc, v.sharding)
                else:
                    out[k] = v + inc
            return out

        return step

    state, rep = run_elastic(cluster, make_state, factory,
                             lambda i: {"x": torch.full((8,), float(i))},
                             Checkpointer(str(tmp_path), keep=3), total_steps=12,
                             ckpt_every=5, fail_at=dict(fail_at))
    got = [rep.steps_done, rep.failures, rep.final_devices, [list(r) for r in rep.restarts]]
    assert got == want_rep
    assert seen == [4, 2]
    for k in ("w", "n"):
        assert isinstance(state[k], ShardedTensor) and state[k].sharding.mesh.size == 2
        assert np.array_equal(gather(state[k]).numpy(), want_state[k])


@pytest.mark.parametrize("ckpt_every", [1, 5], ids=["restore", "reshard"])
def test_run_elastic_on_train_state_equal_jax(jx, tmp_path, ckpt_every):
    """A real training state ``(params, adamw_init(params))`` goes through
    ``device_put`` / ``param_shardings`` on the merged view of 4 lanes, a
    pod is lost at step 2 (after the checkpoint of step 2, or before the
    first), and the survivors take step 3: the params equal JAX's three
    straight steps within ``_param_tol``, the optimizer's step is 3."""
    name = "codeqwen1.5-7b"
    train = make_train_step(_model(name), TrainConfig(**TCFG))
    cluster = SpatzformerCluster(n_pods=2, devices=["cpu"] * 4)
    seen = []

    def make_state(info):
        p = _params(jx, name)
        state = (p, adamw_init(p))
        return device_put(state, param_shardings(state, info))

    def factory(info):
        seen.append(info.n_devices)

        def step(state, batch, i):
            assert isinstance(state[1], AdamWState)
            params, opt, _ = train(*tree_map(gather, state), batch)
            return device_put((params, opt), param_shardings((params, opt), info))

        return step

    state, rep = run_elastic(cluster, make_state, factory, lambda i: _t(jx["corpus"][i]),
                             Checkpointer(str(tmp_path), keep=3), total_steps=STEPS,
                             ckpt_every=ckpt_every, fail_at={2: 1})
    assert (rep.steps_done, rep.failures, rep.restarts) == (STEPS, 1, [(2, 2)])
    assert seen == [4, 2]
    params, opt = state
    assert isinstance(opt, AdamWState)
    assert all(isinstance(x, ShardedTensor) and x.sharding.mesh.size == 2
               for x in leaves(state))
    assert int(gather(opt.step)) == STEPS
    _param_tol(tree_map(gather, params), jx["steps"][1][-1][1], TCFG["lr"], STEPS)
