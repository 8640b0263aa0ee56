"""The port's production dry run (``launch/dryrun.py``) and what it rests on,
against the JAX package on the CPU: ``roofline/flops.py``'s counts,
``roofline/analysis.py`` at the H100's peaks, ``input_specs`` /
``pad_seq_axis`` / ``param_specs``, the collective counter, placeholder
lanes and the production mesh, and ZeRO-1 / ZeRO-3 in the lane train step.

JAX's side of the sharded checks is one subprocess over 8 forced host
devices (module fixture), as ``tests/test_torch_train_lanes.py`` runs it:

- ``memory_analysis().argument_size_in_bytes`` of JAX's jitted step for four
  reduced cells over a (pod 2, data 2, model 2) mesh under the dry run's
  shardings — codeqwen1.5-7b prefill (TP), codeqwen1.5-7b train
  ``dp_zero3``, zamba2-2.7b train ``dp_zero1`` and musicgen-large decode
  (``embeds``) — against each placeholder lane's argument bytes;
- JAX's jitted ZeRO steps over (data 2, model 2) with TP off (3 steps of
  reduced codeqwen1.5-7b, zamba2-2.7b and falcon-mamba-7b) against the
  port's over four CPU lanes.

ZeRO's element thresholds are JAX's dry-run values (2**24 params, 2**22
moments); the reduced configs' leaves are smaller, so both sides take
``ZERO_THR`` here and every leaf that divides is sharded.
"""

import json
import math
import os
import pickle
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.common.tree import flatten_with_path, leaves, tree_map
from repro_torch.configs import TrainConfig, all_cells, get_arch, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.dist import collectives
from repro_torch.dist.sharding import (
    Mesh,
    MeshInfo,
    device_put,
    gather,
    lane_grid,
    lanes_for,
    serve_param_shardings,
    serving_mesh_info,
)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, mesh_info_for
from repro_torch.models import LM, input_specs, pad_seq_axis
from repro_torch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS, RooflineTerms, count_cell
from repro_torch.train import adamw_init, make_train_step
from repro_torch.train import step as step_mod
from test_torch_train import _param_tol

ROOT = Path(__file__).resolve().parents[1]
ZERO_THR = (2**10, 2**8)  # (params, moments): every reduced leaf that divides
TCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 3
# the dry run's (2, 2, 2) cells: key -> (arch, (seq, batch, kind), strategy)
DRY = {
    "codeqwen-prefill-tp": ("codeqwen1.5-7b", (32, 8, "prefill"), "tp"),
    "codeqwen-train-zero3": ("codeqwen1.5-7b", (32, 8, "train"), "dp_zero3"),
    "zamba2-train-zero1": ("zamba2-2.7b", (32, 8, "train"), "dp_zero1"),
    "musicgen-decode-tp": ("musicgen-large", (32, 8, "decode"), "tp"),
}
# ZeRO over four lanes: key -> (arch, zero, grad_accum, batch); a batch of
# 4 at grad_accum 2 is a microbatch of 2 over 4 rows (each sequence on two)
ZERO = {
    "codeqwen-zero1": ("codeqwen1.5-7b", "zero1", 1, 8),
    "codeqwen-zero3": ("codeqwen1.5-7b", "zero3", 1, 8),
    "codeqwen-zero3-micro2": ("codeqwen1.5-7b", "zero3", 2, 4),
    "zamba2-zero1-accum2": ("zamba2-2.7b", "zero1", 2, 8),
    "zamba2-zero3": ("zamba2-2.7b", "zero3", 1, 8),
    "falcon-zero3-accum2": ("falcon-mamba-7b", "zero3", 2, 8),
}

_JAX = r"""
import pickle, sys
from dataclasses import replace
import numpy as np
import repro  # noqa: F401  (jax compat shims first)
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import TrainConfig, get_arch
from repro.configs.base import ShapeConfig
from repro.dist.sharding import MeshInfo, batch_shardings, param_shardings, replicated
from repro.models.model import LM, input_specs
from repro.train import adamw_init, make_train_step

DRY, ZERO, THR, TCFG = %r
with open(sys.argv[2], "rb") as f:
    inp = pickle.load(f)
out = {"args": {}, "zero": {}}
M_KEYS = ("loss", "aux", "grad_norm", "lr")
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
for key, (name, (s, b, kind), strategy) in DRY.items():
    # remat off: the same arguments, a cheaper compile
    cfg = replace(get_arch(name).reduced(), remat="none")
    shape = ShapeConfig(key, s, b, kind)
    if strategy == "tp":
        info = MeshInfo(mesh, batch_axes=("pod", "data"))
    else:
        info = MeshInfo(mesh, batch_axes=("pod", "data", "model"), tp_enabled=False)
    model = LM(cfg, mesh_info=info)
    params_s = model.param_specs()
    p_sh = param_shardings(params_s, info, fsdp=strategy == "dp_zero3", fsdp_threshold=THR[0])
    batch_s = input_specs(cfg, shape)
    b_sh = batch_shardings(batch_s, info)
    with mesh:
        if kind == "train":
            opt_s = jax.eval_shape(lambda: adamw_init(params_s))
            o_sh = param_shardings(opt_s, info, fsdp=True, fsdp_threshold=THR[1])
            m_sh = {k: replicated(info) for k in M_KEYS}
            lowered = jax.jit(make_train_step(model, TrainConfig()), in_shardings=(p_sh, o_sh, b_sh),
                              out_shardings=(p_sh, o_sh, m_sh), donate_argnums=(0, 1)
                              ).lower(params_s, opt_s, batch_s)
        elif kind == "prefill":
            lowered = jax.jit(model.forward, in_shardings=(p_sh, b_sh)).lower(params_s, batch_s)
        else:
            cache_s = model.cache_specs(b, s)
            c_sh = model.cache_shardings(cache_s, info)
            lowered = jax.jit(model.decode_step, in_shardings=(p_sh, c_sh, b_sh, replicated(info)),
                              out_shardings=(None, c_sh), donate_argnums=(1,)).lower(
                params_s, cache_s, batch_s, jax.ShapeDtypeStruct((), jnp.int32))
        out["args"][key] = int(lowered.compile().memory_analysis().argument_size_in_bytes)
mesh4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
info4 = MeshInfo(mesh4, batch_axes=("data", "model"), tp_enabled=False)
for key, (name, zero, accum, _) in ZERO.items():
    cfg = replace(get_arch(name).reduced(), remat="none")
    params = jax.tree.map(jnp.asarray, inp["params"][key])
    opt = adamw_init(params)
    p_sh = param_shardings(jax.eval_shape(lambda: params), info4, fsdp=zero == "zero3",
                           fsdp_threshold=THR[0])
    o_sh = param_shardings(jax.eval_shape(lambda: opt), info4, fsdp=True, fsdp_threshold=THR[1])
    params, opt = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
    batches = [jax.tree.map(jnp.asarray, b) for b in inp["batches"][key]]
    b_sh = batch_shardings(jax.eval_shape(lambda: batches[0]), info4)
    m_sh = {k: replicated(info4) for k in M_KEYS}
    step = jax.jit(make_train_step(LM(cfg, mesh_info=info4), TrainConfig(grad_accum=accum, **TCFG)),
                   in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, m_sh))
    hist = []
    for b in batches:
        params, opt, m = step(params, opt, jax.device_put(b, b_sh))
        hist.append({k: float(v) for k, v in m.items()})
    out["zero"][key] = (hist, jax.tree.map(np.asarray, params))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % ((DRY, ZERO, ZERO_THR, TCFG),)


def _batches(cfg, seed: int, b: int = 8) -> list[dict]:
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, 16, b, seed=seed))
    return [corpus.batch(i) for i in range(STEPS)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """JAX's argument bytes of the dry run's cells and its ZeRO steps (one
    subprocess, 8 host devices), and the params and batches they took."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("dryrun")
    inp = {"params": {}, "batches": {}}
    for i, (key, (name, _, _, b)) in enumerate(ZERO.items()):
        cfg = get_arch(name).reduced()
        p = LM(cfg, device="cpu").init(torch.Generator().manual_seed(i))
        inp["params"][key] = tree_map(lambda t: t.numpy(), p)
        inp["batches"][key] = _batches(cfg, i, b)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true")
    out = subprocess.run([sys.executable, "-c", _JAX, str(tmp / "out.pkl"), str(tmp / "in.pkl")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        return dict(pickle.load(f), **inp)


@pytest.fixture
def zero_thresholds(monkeypatch):
    monkeypatch.setattr(step_mod, "ZERO_PARAM_THRESHOLD", ZERO_THR[0])
    monkeypatch.setattr(step_mod, "ZERO_OPT_THRESHOLD", ZERO_THR[1])


def _mesh(device: str, shape=(2, 2, 2), axes=("pod", "data", "model")) -> Mesh:
    return Mesh(lane_grid(lanes_for([device] * math.prod(shape)), shape), axes)


def _plan(cfg, shape, mesh, strategy: str) -> dryrun.Plan:
    """The dry run's own policy, its strategy forced (the reduced configs
    would all take ZeRO-1)."""
    info = mesh_info_for(mesh)
    plan = dryrun.policy(cfg, shape, info)
    if strategy == "tp":
        return replace(plan, info=info, strategy="tp", fsdp=False)
    zinfo = MeshInfo(mesh, batch_axes=info.batch_axes + ("model",), tp_enabled=False,
                     zero=strategy[3:])
    return replace(plan, info=zinfo, strategy=strategy, fsdp=strategy == "dp_zero3")


def _cell(key: str, device: str) -> dict:
    name, (s, b, kind), strategy = DRY[key]
    cfg = get_arch(name).reduced()
    shape = ShapeConfig(key, s, b, kind)
    mesh = _mesh(device)
    return dryrun.run_cell(cfg, shape, mesh, plan=_plan(cfg, shape, mesh, strategy))


# ------------------------------------------------------------------ roofline


@pytest.mark.parametrize("cell", all_cells(), ids=lambda c: f"{c[0]}-{c[1]}")
def test_count_cell_equals_jax(cell):
    """``count_cell`` of the port equals JAX's exactly, at (dp, tp) of (16,
    16) and (32, 16), with zero none / zero1 / zero3."""
    from repro.configs import get_arch as jax_arch
    from repro.configs import get_shape as jax_shape
    from repro.roofline.flops import count_cell as jax_count

    arch, shape = cell
    for dp, tp in ((16, 16), (32, 16)):
        for zero in ("none", "zero1", "zero3"):
            got = count_cell(get_arch(arch), get_shape(shape), dp=dp, tp=tp, zero=zero)
            want = jax_count(jax_arch(arch), jax_shape(shape), dp=dp, tp=tp, zero=zero)
            assert got.__dict__ == want.__dict__, (dp, tp, zero)


def test_roofline_terms_math_at_the_h100_peaks():
    """``tests/test_sharding_rules.py::test_roofline_terms_math`` at the
    card's published peaks (H100 SXM 80GB, 700 W, data sheet)."""
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    t = RooflineTerms(name="x", chips=256, flops=256 * 989e12, hbm_bytes=0.0, coll_bytes=0.0,
                      model_flops=128 * 989e12)
    assert t.t_compute == pytest.approx(1.0)
    assert t.bottleneck == "compute"
    assert t.mfu == pytest.approx(0.5)
    assert t.usefulness == pytest.approx(0.5)
    t2 = RooflineTerms(name="y", chips=2, flops=0.0, hbm_bytes=2 * 3.35e12,
                       coll_bytes=2 * 450e9 * 2)
    assert t2.bottleneck == "collective"
    assert t2.step_time == pytest.approx(2.0)
    assert t2.t_memory == pytest.approx(1.0)


# ------------------------------------------------------------------ stand-ins


def _shapes(tree, jax_tree=False):
    import jax

    if jax_tree:
        return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch.")) for p, x in
            flatten_with_path(tree)}


@pytest.mark.parametrize("cell", all_cells(), ids=lambda c: f"{c[0]}-{c[1]}")
def test_input_specs_equal_jax(cell):
    """Every cell's stand-ins: JAX's shapes and dtypes (int32 tokens and
    labels, ``embeds`` in the model dtype for audio), all on ``meta``."""
    from repro.configs import get_arch as jax_arch
    from repro.configs import get_shape as jax_shape
    from repro.models.model import input_specs as jax_specs

    arch, shape = cell
    got = input_specs(get_arch(arch), get_shape(shape))
    assert all(t.device.type == "meta" for t in got.values())
    assert _shapes(got) == _shapes(jax_specs(jax_arch(arch), jax_shape(shape)), jax_tree=True)


@pytest.mark.parametrize("arch", sorted({c[0] for c in all_cells()}))
def test_param_specs_equal_jax(arch):
    """``LM.param_specs`` builds ``init``'s tree as empty ``meta`` tensors
    with JAX's shapes and dtypes, drawing nothing."""
    from repro.configs import get_arch as jax_arch
    from repro.models import LM as JaxLM

    got = LM(get_arch(arch), device="cpu").param_specs()
    assert all(t.device.type == "meta" for t in leaves(got))
    assert _shapes(got) == _shapes(JaxLM(jax_arch(arch)).param_specs(), jax_tree=True)


def test_pad_seq_axis_equals_jax():
    import jax.numpy as jnp

    from repro.models.model import pad_seq_axis as jax_pad

    x = np.arange(2 * 3 * 5 * 4, dtype=np.float32).reshape(2, 3, 5, 4)
    for axis in (1, 2):
        got = pad_seq_axis(torch.from_numpy(x), axis, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pad(jnp.asarray(x), axis, 8)))
    assert pad_seq_axis(torch.from_numpy(x), 2, 5).data_ptr() == torch.from_numpy(x).data_ptr()


# ------------------------------------------------------------------ lanes


def test_production_mesh_of_placeholders():
    """256 and 512 placeholder lanes on ``meta``, JAX's axes; no stream; data
    crossing between two of them is a copy (each stands for a card)."""
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.devices.shape == shape and mesh.axis_names == axes
        lanes = mesh.lanes
        assert len({id(lane) for lane in lanes}) == math.prod(shape)
        assert all(lane.device.type == "meta" and lane.stream is None for lane in lanes)
        assert not lanes[0].shares_memory(lanes[1]) and lanes[0].shares_memory(lanes[0])
    cpu = lanes_for(["cpu", "cpu"])
    assert cpu[0].shares_memory(cpu[1])


def test_tp_disabled_view_has_one_lane_a_row():
    """``tp_enabled=False`` demotes the model axis to a batch axis: no model
    axis, model_size 1, one lane a data row in flat order."""
    from repro_torch.train.step import lane_rows

    mesh = _mesh("meta")
    info = MeshInfo(mesh, batch_axes=("pod", "data", "model"), tp_enabled=False)
    assert (info.model_axis, info.model_size, info.data_size) == (None, 1, 8)
    assert lane_rows(info) == [[lane] for lane in mesh.lanes]
    with pytest.raises(ValueError, match="zero"):
        MeshInfo(mesh, zero="zero2")


def test_collective_counter_hand_count():
    """A 2-layer reduced dense forward on the merged view over (1, 2) and,
    one merged view a row, (2, 2): each kind's bytes on each lane by hand.
    The controller lane receives the sums (``all-reduce``: the embedding,
    each layer's attention and MLP partials) and the logits' vocabulary
    blocks (``all-gather``); the other lane the broadcasts
    (``collective-permute``: tokens, positions, each layer's two normed
    inputs and the final one). Off outside ``counting()``."""
    cfg = get_arch("codeqwen1.5-7b").reduced()
    assert cfg.n_layers == 2
    p = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s, d, v = 2, 8, cfg.d_model, cfg.vocab_size
    toks = torch.zeros((b, s), dtype=torch.int32)
    for rows in (1, 2):
        row_lanes = [lanes_for(["cpu", "cpu"]) for _ in range(rows)]
        with collectives.counting() as got:
            for lanes in row_lanes:
                info = serving_mesh_info(lanes)
                with torch.no_grad():
                    LM(cfg, mesh_info=info).forward(
                        device_put(p, serve_param_shardings(p, info)), {"tokens": toks})
        act = b * s * d * 4
        want = {}
        for lanes in row_lanes:
            want[lanes[0]] = {"all-reduce": act * (1 + 2 * cfg.n_layers),
                              "all-gather": b * s * v * 4}
            want[lanes[1]] = {"collective-permute": b * s * 4 + s * 4
                              + act * (2 * cfg.n_layers + 1)}
        assert got == want
    with torch.no_grad():
        LM(cfg, mesh_info=info).forward(device_put(p, serve_param_shardings(p, info)),
                                        {"tokens": toks})
    assert collectives._COUNTS is None


# ------------------------------------------------------------------ the dry run


# JAX's argument bytes less the port's, by lane, where the two differ on
# purpose: decode's cur_len is the controller lane's (a row's first lane),
# where JAX replicates its 4 bytes on every device; and ``jax.jit`` drops
# the arguments a computation never reads (``keep_unused=False``): a decode
# on embeds never reads the token table, which the port holds (replicated
# at the reduced widths)
def _intended(key: str, lane: int) -> int:
    if not key.endswith("decode-tp"):
        return 0
    cfg = get_arch(DRY[key][0]).reduced()
    return (4 if lane % 2 else 0) - cfg.vocab_size * cfg.d_model * 4


@pytest.mark.parametrize("key", list(DRY))
def test_dry_run_cell_equals_jax_and_cpu(jx, key, zero_thresholds):
    """A reduced cell on the (2, 2, 2) placeholder mesh: each lane's argument
    bytes equal JAX's ``memory_analysis`` under the same shardings (less the
    intended difference); counted FLOPs equal the same run over CPU lanes;
    no byte is left without a lane; JAX's record keys."""
    rec = _cell(key, "meta")
    cpu = _cell(key, "cpu")
    for k in ("chips", "kind", "baseline", "grad_accum", "strategy", "kv_cache_dtype", "fsdp",
              "trace_s", "counted_flops", "collectives", "analytic", "ok"):
        assert k in rec, k
    assert set(rec["mem"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
                               "unclaimed_bytes"}
    assert rec["ok"] and rec["strategy"] == DRY[key][2]
    for i, (arg, _) in enumerate(rec["lane_mem"]):
        assert jx["args"][key] - arg == _intended(key, i), i
    assert rec["counted_flops"] == cpu["counted_flops"] > 0
    assert rec["mem"]["unclaimed_bytes"] == 0 == cpu["mem"]["unclaimed_bytes"]
    assert rec["mem"]["peak_bytes"] == rec["mem"]["argument_bytes"] + rec["mem"]["temp_bytes"]
    assert rec["collectives"]
    json.dumps(rec)


@pytest.mark.parametrize("name, shape, item", [
    ("falcon-mamba-7b", (32, 8, "prefill"), "item 10"),
    ("deepseek-v2-lite-16b", (32, 8, "decode"), "item 7"),
    ("minicpm3-4b", (32, 8, "train"), "item 10"),
])
def test_refused_cells_name_their_item(name, shape, item):
    """A family the port lacks under TP records ``ok: false`` naming its
    ROADMAP item; ZeRO or FSDP with TP names item 12."""
    cfg = get_arch(name).reduced()
    sc = ShapeConfig("x", *shape)
    mesh = _mesh("meta")
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}") as e:
        dryrun.run_cell(cfg, sc, mesh, plan=_plan(cfg, sc, mesh, "tp"))
    assert dryrun.failed(name, "x", "2x2x2", e.value)["ok"] is False
    dense = get_arch("codeqwen1.5-7b").reduced()
    plan = _plan(dense, sc, mesh, "tp")
    plan = replace(plan, fsdp=True, info=replace(plan.info, zero="zero3"))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        dryrun.run_cell(dense, sc, mesh, plan=plan)


def test_dry_run_policies_match_jax():
    """The memory policies on the production mesh: grad-accum sizing,
    strategy, FSDP, the f8 KV cache and the attention chunk, as JAX's
    ``lower_cell`` derives them (its lines 73-138). A training cell's state
    on one model lane (12 bytes a param) passes 8e9 bytes in every arch, so
    JAX shards its params over the batch axes (``fsdp``) under ``dp_zero1``
    too: the port places every such cell by zero3's rule."""
    want = {("musicgen-large", "train_4k"): ("dp_zero1", 1),
            ("zamba2-2.7b", "train_4k"): ("dp_zero1", 2),
            ("codeqwen1.5-7b", "train_4k"): ("dp_zero3", 2),
            ("falcon-mamba-7b", "train_4k"): ("dp_zero3", 2),
            ("minicpm3-4b", "train_4k"): ("dp_zero3", 1),
            ("mistral-large-123b", "train_4k"): ("tp", 8)}
    info = mesh_info_for(make_production_mesh())
    for (arch, shape), (strategy, accum) in want.items():
        plan = dryrun.policy(get_arch(arch), get_shape(shape), info)
        assert (plan.strategy, plan.grad_accum) == (strategy, accum), arch
        assert plan.fsdp and plan.info.zero == "zero3"
        assert plan.info.model_size == (16 if strategy == "tp" else 1)
    plan = dryrun.policy(get_arch("codeqwen1.5-7b"), get_shape("decode_32k"), info)
    assert plan.cfg.kv_cache_dtype == "float8_e4m3fn" and not plan.fsdp
    plan = dryrun.policy(get_arch("mistral-large-123b"), get_shape("prefill_32k"), info)
    assert plan.cfg.attn_chunk == 256 and plan.fsdp
    base = dryrun.policy(get_arch("codeqwen1.5-7b"), get_shape("train_4k"), info, baseline=True)
    assert (base.strategy, base.grad_accum, base.fsdp, base.info.zero) == ("tp", 1, False, "none")


def test_cli_one_cell(tmp_path, monkeypatch, capsys):
    """``main`` over one cell that runs and one the port refuses, on a (1, 4)
    stand-in for the production mesh: JAX's OK / FAIL lines, one JSONL
    record a cell, exit 1 as any cell failed."""
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: _mesh("meta", (1, 4), ("data", "model")))
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "codeqwen1.5-7b", "--shape", "decode_32k", "--mesh", "single",
                 "--out", str(out)])
    assert json.loads(out.read_text())["ok"] is True
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "deepseek-v2-lite-16b", "--shape", "decode_32k", "--mesh",
                     "single", "--out", str(out)])
    assert e.value.code == 1
    lines = capsys.readouterr().out
    assert "OK   codeqwen1.5-7b/decode_32k/single" in lines
    assert "FAIL deepseek-v2-lite-16b/decode_32k/single" in lines
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["ok"] is False and "item 7" in rec["error"] and rec["mesh"] == "16x16"


@pytest.mark.parametrize("vocab", [256, 64], ids=["head-on-vocab", "head-on-d"])
def test_tp_training_gathers_a_split_norm(monkeypatch, vocab):
    """At full width a stacked [L, d] norm passes ``MIN_SHARD_ELEMS`` and the
    placement splits it over the model axis, and musicgen-large's head [d,
    V] (2048 each) splits on d; the merged view's training forward gathers
    them (here forced on the reduced config, the head at V = d): the lane
    step equals one lane's."""
    from repro_torch.dist import sharding

    monkeypatch.setattr(sharding, "MIN_SHARD_ELEMS", 64)
    cfg = replace(get_arch("codeqwen1.5-7b").reduced(), vocab_size=vocab)
    init = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 0)[0].items()}
    out = []
    for view in (None, MeshInfo(_mesh("cpu", (2, 2), ("data", "model")))):
        p = tree_map(lambda t: t.clone(), init)
        step = make_train_step(LM(cfg, device="cpu"), TrainConfig(**TCFG), mesh_info=view)
        p, _, m = step(p, adamw_init(p), batch)
        out.append(m)
        if view is not None:
            specs = {k: x.sharding.spec for k, x in flatten_with_path(p)}
            assert specs["['blocks']['norm1']"][1] == "model"
            assert specs["['embed']['head']"][0 if vocab == cfg.d_model else 1] == "model"
    for k in ("loss", "grad_norm"):
        assert float(out[1][k]) == pytest.approx(float(out[0][k]), rel=1e-5)


# ------------------------------------------------------------------ ZeRO


def _zero_step(key: str, zero: str):
    name, _, accum, _ = ZERO[key]
    info = MeshInfo(_mesh("cpu", (2, 2), ("data", "model")), batch_axes=("data", "model"),
                    tp_enabled=False, zero=zero)
    return make_train_step(LM(get_arch(name).reduced(), device="cpu"),
                           TrainConfig(grad_accum=accum, **TCFG), mesh_info=info)


@pytest.mark.parametrize("key", list(ZERO))
def test_zero_steps_equal_plain_and_jax(jx, key, zero_thresholds):
    """ZeRO over four CPU lanes (TP off): 3 steps against the replicated
    step on the same lanes — bitwise at ``grad_accum`` 1 and for ZeRO-1;
    ZeRO-3 with microbatches sums the rows before the microbatches, so
    there within f32 rounding (1e-6 of each leaf's scale) — and against
    JAX's jitted step under the same shardings (``test_torch_train_lanes``'s
    tolerances), also where a microbatch of 2 repeats over the 4 rows."""
    name, zero, accum, _ = ZERO[key]
    hist, want = jx["zero"][key]
    runs = {}
    for z in ("none", zero):
        p = tree_map(torch.from_numpy, jx["params"][key])
        p = tree_map(lambda t: t.clone(), p)
        o = adamw_init(p)
        step = _zero_step(key, z)
        ms = []
        for b in jx["batches"][key]:
            p, o, m = step(p, o, {k: torch.from_numpy(v) for k, v in b.items()})
            ms.append({k: float(x) for k, x in m.items()})
        runs[z] = (ms, p, o)
    (mp, pp, _), (mz, pz, oz) = runs["none"], runs[zero]
    sharded = [x for x in leaves((pz, oz)) if any(e is not None for e in x.sharding.spec)]
    assert sharded, "no leaf sharded over the batch axes"
    if zero == "zero1" or accum == 1:
        assert mz == mp
        assert all(torch.equal(gather(a), gather(b)) for a, b in zip(leaves(pz), leaves(pp)))
    else:
        for a, b in zip(leaves(pz), leaves(pp)):
            a, b = gather(a), gather(b)
            assert (a - b).abs().max() <= 1e-6 * max(float(b.abs().max()), 1.0)
    for i, want_m in enumerate(hist):
        for k in ("loss", "aux", "grad_norm", "lr"):
            assert mz[i][k] == pytest.approx(want_m[k], rel=1e-5, abs=1e-7), (i, k)
    _param_tol(tree_map(gather, pz), want, TCFG["lr"], STEPS)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["codeqwen-zero3", "zamba2-zero3"])
def test_cuda_zero3_waits_for_the_root_lane(monkeypatch, zero_thresholds, key):
    """ZeRO-3 over four lanes of one card, with the root lane's stream held
    back (~20 ms of sleep) before each lane reduce: bitwise the replicated
    step. A collective's backward hands autograd tensors that the caller's
    stream reads with no wait of its own (the select of a stacked layer's
    block), so it has to order that stream after its lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    name, zero, accum, b = ZERO[key]
    cfg = get_arch(name).reduced()
    init = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in mb.items()}
               for mb in _batches(cfg, 0, b)]
    plain = collectives._reduce

    def held(parts, lanes):
        with torch.cuda.stream(lanes[0].stream):
            torch.cuda._sleep(4 * 10**7)
        return plain(parts, lanes)

    runs = {}
    for z in ("none", zero):
        if z == zero:
            monkeypatch.setattr(collectives, "_reduce", held)
        info = MeshInfo(_mesh(dev, (2, 2), ("data", "model")), batch_axes=("data", "model"),
                        tp_enabled=False, zero=z)
        step = make_train_step(LM(cfg, device=dev), TrainConfig(grad_accum=accum, **TCFG),
                               mesh_info=info)
        p = tree_map(lambda t: t.clone(), init)
        o = adamw_init(p)
        losses = []
        for batch in batches:
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
        runs[z] = (losses, [gather(x) for x in leaves(p)])
    assert runs[zero][0] == runs["none"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[zero][1], runs["none"][1]))


def test_zero_with_tensor_parallelism_is_refused(zero_thresholds):
    """ZeRO over a view whose model axis spans two lanes raises, naming
    ROADMAP Queue 1 item 12."""
    info = MeshInfo(_mesh("cpu", (2, 2), ("data", "model")), zero="zero1")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        make_train_step(LM(get_arch("codeqwen1.5-7b").reduced(), device="cpu"),
                        TrainConfig(**TCFG), mesh_info=info)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        step_mod.state_shardings((None, None), info)


def test_tp_step_keeps_bf16_leaves():
    """The ZeRO-3 path (f32 blocks for autograd, gathers) is the zero3
    view's only: a bf16 step over (data 2, model 2) trains its bf16 shards
    as they are, finite, every leaf still bf16."""
    cfg = replace(get_arch("codeqwen1.5-7b").reduced(), dtype="bfloat16", d_model=128,
                  n_heads=8, n_kv_heads=8, d_head=16, d_ff=512, vocab_size=512)
    p = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 0, 4)[0].items()}
    step = make_train_step(LM(cfg, device="cpu"), TrainConfig(**TCFG),
                           mesh_info=MeshInfo(_mesh("cpu", (2, 2), ("data", "model"))))
    p, o, m = step(p, adamw_init(p), batch)
    assert math.isfinite(float(m["loss"]))
    assert {x.dtype for x in leaves(p)} == {torch.bfloat16}


@pytest.mark.parametrize("name, kind", [("codeqwen1.5-7b", "train"), ("minicpm3-4b", "train"),
                                        ("falcon-mamba-7b", "train"), ("zamba2-2.7b", "train"),
                                        ("codeqwen1.5-7b", "prefill")])
def test_core_replay_matches_a_full_trace(monkeypatch, name, kind):
    """The cores the dry run replays (attention, selective scan, SSD: one
    probe a set of shapes) against tracing every call, on one placeholder
    lane: the same FLOPs and argument bytes, temp bytes within 10%."""
    cfg = get_arch(name).reduced()
    shape = ShapeConfig("x", 64, 2, kind)
    mesh = _mesh("meta", (1, 1), ("data", "model"))
    plan = dryrun.Plan(cfg, mesh_info_for(mesh))
    replayed = dryrun.run_cell(cfg, shape, mesh, plan=plan)
    monkeypatch.setattr(dryrun, "_CORES", ())
    whole = dryrun.run_cell(cfg, shape, mesh, plan=plan)
    assert replayed["counted_flops"] == whole["counted_flops"]
    assert replayed["mem"]["argument_bytes"] == whole["mem"]["argument_bytes"]
    assert abs(replayed["mem"]["temp_bytes"] / whole["mem"]["temp_bytes"] - 1) <= 0.10
