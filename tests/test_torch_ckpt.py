"""The port's ``Checkpointer`` (``ckpt/checkpoint.py``) and the training
launcher (``launch/train.py``) on the CPU.

- the five cases of the JAX package's ``tests/test_ckpt.py`` on the port:
  a blocking round trip, an async save, retention, a chosen step, a missing
  checkpoint;
- against the JAX package (one subprocess, module fixture): the JAX
  ``Checkpointer`` restores the port's checkpoint and the port restores the
  JAX one, a bf16 leaf included (JAX writes ``ml_dtypes`` bfloat16, read
  here as 16-bit words): every value bitwise, the manifests' keys and
  dtypes equal;
- bf16 leaves (NaN, infinities, subnormals among them) restored bitwise, and
  the snapshot taken before ``save`` returns (an in-place update after it
  does not reach the files);
- a resume equal bitwise to a straight run: 6 train steps against 3, a
  save, a restore into fresh state, then 3 (reduced codeqwen1.5-7b, f32);
- ``python -m repro_torch.launch.train --device cpu``, then ``--resume``:
  the resumed steps' losses bitwise those of a straight run, and a second
  lane refused.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt import Checkpointer
from repro_torch.common.tree import flatten_with_path, leaves, tree_map
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.launch import train as launch_train
from repro_torch.models import LM
from repro_torch.train import adamw_init, make_train_step

ROOT = Path(__file__).resolve().parents[1]

_JAX_CKPT = r"""
import json, sys
import numpy as np
import repro  # noqa: F401
import jax, jax.numpy as jnp
from repro.ckpt import Checkpointer
port_dir, jax_dir, out_path = sys.argv[1:4]
# restore the port's checkpoint into the structure it was written from
like = {"params": {"w": jax.ShapeDtypeStruct((8, 16), jnp.float32),
                   "b": jax.ShapeDtypeStruct((16,), jnp.float32)},
        "step": jax.ShapeDtypeStruct((), jnp.int32),
        "nested": [jax.ShapeDtypeStruct((3,), jnp.float32),
                   {"x": jax.ShapeDtypeStruct((5,), jnp.int32)}]}
tree, step = Checkpointer(port_dir).restore(like)
got = {k: np.asarray(v) for k, v in
       zip([jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]],
           jax.tree.leaves(tree))}
# the JAX checkpoint of the same values, and a bf16 leaf
state = {"params": {"w": jnp.asarray(got["['params']['w']"]), "b": jnp.asarray(got["['params']['b']"])},
         "step": jnp.int32(7), "nested": [jnp.ones((3,)), {"x": jnp.arange(5)}],
         "half": (jnp.arange(12, dtype=jnp.float32) / 7).astype(jnp.bfloat16).reshape(3, 4)}
Checkpointer(jax_dir).save(9, state, blocking=True)
np.savez(out_path, step=step, half=np.asarray(state["half"].astype(jnp.float32)), **got)
"""


def _state(seed=0):
    """The JAX test's state: params, a scalar int32 step, a nested list."""
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 16, generator=g), "b": torch.zeros(16)},
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [torch.ones(3), {"x": torch.arange(5, dtype=torch.int32)}],
    }


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Tiny f32 work: one intra-op thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ the JAX cases


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = _state()
    ck.save(10, state, blocking=True)
    restored, step = ck.restore(state)
    assert step == 10
    _equal(restored, state)


def test_async_save_then_restore(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    h = ck.save(1, _state())  # non-blocking
    h.wait()
    assert ck.latest_step() == 1 and not h.thread.is_alive()


def test_retention_policy(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s), blocking=True)
    assert ck.list_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]


def test_restore_specific_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    for s in (5, 6):
        ck.save(s, _state(s), blocking=True)
    restored, step = ck.restore(_state(), step=5)
    assert step == 5
    _equal(restored, _state(5))


def test_restore_missing_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore(_state())
    ck.save(1, _state(), blocking=True)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"w": torch.zeros(1)})


# ------------------------------------------------------------------ against JAX


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """The port's checkpoint of ``_state()`` read by the JAX Checkpointer, and
    a JAX checkpoint of the same values (plus a bf16 leaf) for the port."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("ckpt")
    Checkpointer(str(tmp / "port")).save(3, _state(), blocking=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_CKPT, str(tmp / "port"), str(tmp / "jax"),
                          str(tmp / "out.npz")], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return tmp, dict(np.load(tmp / "out.npz"))


def test_checkpoints_cross_between_the_packages(jx):
    tmp, got = jx
    # the JAX Checkpointer read the port's checkpoint: every leaf bitwise
    assert int(got.pop("step")) == 3
    half = got.pop("half")
    want = {k: v.numpy() for k, v in flatten_with_path(_state())}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # the port reads the JAX checkpoint, bf16 leaf included
    like = dict(_state(), half=torch.empty(3, 4, dtype=torch.bfloat16, device="meta"))
    tree, step = Checkpointer(str(tmp / "jax")).restore(like)
    assert step == 9
    _equal({k: v for k, v in tree.items() if k != "half"}, _state())
    assert tree["half"].dtype == torch.bfloat16 and tree["half"].device.type == "cpu"
    assert np.array_equal(tree["half"].float().numpy(), half)
    # one manifest layout: keys, shapes and dtypes of the same leaves
    man = [json.load(open(tmp / d / f"step_{s:08d}" / "manifest.json"))["leaves"]
           for d, s in (("port", 3), ("jax", 9))]
    jax_rows = {r["key"]: r for r in man[1]}
    assert jax_rows["['half']"]["dtype"] == "bfloat16"
    for row in man[0]:
        assert {k: row[k] for k in ("key", "shape", "dtype")} == \
            {k: jax_rows[row["key"]][k] for k in ("key", "shape", "dtype")}


# ------------------------------------------------------------------ bf16, snapshot


def test_bf16_leaves_bitwise_and_snapshot_before_return(tmp_path):
    words = torch.tensor([0x0000, 0x8000, 0x0001, 0x7F80, 0xFF80, 0x7FC1, 0x3F80, 0xC2F7],
                         dtype=torch.int32).to(torch.int16)
    state = {"a": words.view(torch.bfloat16), "b": torch.randn(5, 7).bfloat16(),
             "c": torch.arange(4.0)}
    keep = tree_map(lambda t: t.clone(), state)
    ck = Checkpointer(str(tmp_path))
    h = ck.save(2, state)
    for t in leaves(state):  # an in-place update right after save returns
        t.add_(1)
    h.wait()
    restored, _ = ck.restore(state)
    for got, want in zip(leaves(restored), leaves(keep)):
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype == torch.bfloat16 else want)
    meta = json.load(open(tmp_path / "step_00000002" / "manifest.json"))["leaves"]
    assert [r["dtype"] for r in meta] == ["bfloat16", "bfloat16", "float32"]


# ------------------------------------------------------------------ resume


def test_resume_is_bitwise_a_straight_run(tmp_path):
    cfg = get_arch("codeqwen1.5-7b").reduced()
    model = LM(cfg, device="cpu")
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, 32, 4, seed=5))
    batch = lambda i: {k: torch.from_numpy(v) for k, v in corpus.batch(i).items()}
    step = make_train_step(model, TrainConfig(lr=1e-3, warmup_steps=2, total_steps=6))

    def fresh():
        p = model.init(torch.Generator().manual_seed(0))
        return p, adamw_init(p)

    params, opt = fresh()
    straight = []
    for i in range(6):
        params, opt, m = step(params, opt, batch(i))
        straight.append(float(m["loss"]))

    p, o = fresh()
    for i in range(3):
        p, o, _ = step(p, o, batch(i))
    ck = Checkpointer(str(tmp_path))
    ck.save(3, (p, o))
    p, o = fresh()  # the saved run's state is gone; only the files are left
    (p, o), at = ck.restore((p, o))
    assert at == 3 and int(o.step) == 3
    resumed = []
    for i in range(3, 6):
        p, o, m = step(p, o, batch(i))
        resumed.append(float(m["loss"]))
    assert resumed == straight[3:]
    _equal((p, o), (params, opt))


def test_launcher_trains_resumes_and_refuses_lanes(tmp_path, capsys):
    """``launch.train`` on the CPU: 4 steps and a save, then ``--resume`` to
    8; the resumed losses are a straight 8-step run's (the warmup is 5
    steps, so the first 4 steps' learning rates do not depend on --steps).
    Over two CPU lanes it trains data-parallel; tensor parallelism of a
    family the merged view refuses raises, naming the ROADMAP item."""
    args = ["--arch", "codeqwen1.5-7b", "--reduced", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--log-every", "2", "--ckpt-every", "2"]
    straight = launch_train.main(args + ["--steps", "8", "--ckpt-dir", str(tmp_path / "a")])
    first = launch_train.main(args + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    again = launch_train.main(args + ["--steps", "8", "--ckpt-dir", str(tmp_path / "b"),
                                      "--resume"])
    out = capsys.readouterr().out
    assert first["losses"] == straight["losses"][:4]
    assert again["start_step"] == 4 and again["losses"] == straight["losses"][4:]
    assert "resumed from step 4" in out and "arch=codeqwen1.5-7b-reduced" in out
    assert [s for s in Checkpointer(str(tmp_path / "b")).list_steps()] == [4, 6, 8]
    # over lanes: two CPU lanes are (data 2, model 1), the straight run's
    # losses; tensor parallelism of a family the merged view refuses raises
    two = launch_train.main(args + ["--steps", "2", "--devices", "cpu,cpu",
                                    "--ckpt-dir", str(tmp_path / "c")])
    assert two["losses"] == pytest.approx(straight["losses"][:2], rel=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        launch_train.main(["--arch", "falcon-mamba-7b", "--reduced", "--devices",
                           "cpu,cpu,cpu,cpu", "--pods", "1", "--ckpt-dir", str(tmp_path / "d")])
