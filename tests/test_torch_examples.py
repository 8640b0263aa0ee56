"""The six ``examples/torch_*.py`` (twins of ``examples/*.py`` on the
PyTorch port) and ``repro_torch.launch.train`` over lanes, in-process on the
CPU at a tiny size:

- each example's ``main(argv)`` runs over one CPU lane and over several,
  and computes what its JAX twin computes: a finite forward and a loss near
  ln(vocab) (quickstart); a falling loss and a resume that goes on from the
  checkpoint (train_lm); the same streams from one lane and from a merged
  engine over two, a cancel (serve_batch); the same results split and
  merged, the staged FFT agreeing (mixed_workload_demo); JAX's elastic
  report for a pod lost at step 12 (elastic_restart); two archs trained one
  per pod and two tenants pinned to their replicas (dual_tenant);
- ``launch.train --devices cpu x8 --mode merge --pods 2`` (pod 2, data 2,
  model 2) trains, ``--resume`` goes on, and the two runs' losses are a
  straight run's; ``--mode split`` trains on pod 0's four lanes, with the
  same losses as the merged run (one global batch, one mean).
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt import Checkpointer
from repro_torch.launch import train as launch_train

ROOT = Path(__file__).resolve().parents[1]
CPU8 = ",".join(["cpu"] * 8)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("lanes", [["--device", "cpu"], ["--devices", "cpu,cpu"]],
                         ids=["one-lane", "two-lanes"])
def test_quickstart(lanes):
    out = _example("torch_quickstart").main(lanes + ["--seq", "16"])
    assert out["finite"] and abs(out["loss"] - math.log(256)) < 0.5
    assert len(out["decoded"]) == 4 and out["mode"] == "merge"


def test_train_lm_falls_and_resumes(tmp_path):
    mod = _example("torch_train_lm")
    args = ["--steps", "12", "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path)]
    first = mod.main(args + ["--device", "cpu"])
    assert first["final_loss"] < first["first_loss"]
    # resumed over four lanes (data 2, model 2) from the one-lane checkpoint
    again = mod.main(["--steps", "16", "--batch", "4", "--seq", "32", "--ckpt-dir",
                      str(tmp_path), "--resume", "--devices", "cpu,cpu,cpu,cpu"])
    assert again["start"] == 12 and again["final_loss"] < first["first_loss"]
    assert Checkpointer(str(tmp_path)).latest_step() == 16


def test_serve_batch_one_lane_and_merged():
    mod = _example("torch_serve_batch")
    args = ["--requests", "5", "--max-new", "6"]
    one = mod.main(args + ["--device", "cpu"])
    merged = mod.main(args + ["--devices", "cpu,cpu"])
    assert one["served"] == merged["served"] >= 4  # the cancelled one may not count
    assert one["finish"][4] == "cancelled" and one["finish"][0] == "length"
    assert one["streamed"] == one["generated"][0] and len(one["streamed"]) == 6
    for rid in range(4):  # every request that ran to its length: the same stream
        assert merged["generated"][rid] == one["generated"][rid]


def test_mixed_workload_demo():
    out = _example("torch_mixed_workload_demo").main(
        ["--devices", "cpu,cpu,cpu,cpu", "--rows", "64", "--cols", "32", "--fft", "64"])
    assert out["fft_agree"]
    for name, want in out["split"].items():
        if name.startswith("gemm"):
            assert out["merge"][name] == pytest.approx(want, rel=1e-5)
    assert out["split"]["coremark"] == out["merge"]["coremark"]


def test_elastic_restart_report():
    """JAX's example over 8 devices and over 4: a pod lost at step 12
    restarts from the checkpoint of step 10 on half the lanes, and the state
    counts every step once: w = 0 + 1 + ... + 24."""
    out = _example("torch_elastic_restart").main(["--devices", "cpu,cpu,cpu,cpu"])
    assert (out["steps_done"], out["failures"], out["final_devices"]) == (25, 1, 2)
    assert out["restarts"] == [(10, 2)] and out["steps"] == 25
    assert np.array_equal(out["w"].numpy(), np.full(64, float(sum(range(25)))))


def test_dual_tenant():
    out = _example("torch_dual_tenant").main(["--devices", "cpu,cpu", "--steps", "2",
                                               "--max-new", "4"])
    assert sorted(out["train"]) == ["train:codeqwen1.5-7b", "train:falcon-mamba-7b"]
    for r in out["train"].values():
        assert math.isfinite(float(r.rsplit(" ", 1)[1]))
    assert out["serve"]["served"] == 8 and out["serve"]["homes"] == {"tenantA": 0,
                                                                      "tenantB": 1}
    assert all(len(g) == 4 for g in out["serve"]["generated"].values())


def test_launcher_merge_resume_and_split(tmp_path, capsys):
    """8 CPU lanes in 2 pods: the merge view trains and resumes onto the
    same placement, matching a straight run; split trains on pod 0's lanes
    with the same losses (the same batches, one mean per step)."""
    args = ["--arch", "codeqwen1.5-7b", "--reduced", "--batch", "8", "--seq", "32",
            "--devices", CPU8, "--log-every", "1", "--ckpt-every", "2"]
    straight = launch_train.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    first = launch_train.main(args + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    again = launch_train.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b"),
                                      "--resume"])
    split = launch_train.main(args + ["--steps", "2", "--mode", "split",
                                      "--ckpt-dir", str(tmp_path / "c")])
    out = capsys.readouterr().out
    assert "devices=8" in out and "devices=4" in out and "resumed from step 4" in out
    assert first["losses"] == straight["losses"][:4]
    assert again["start_step"] == 4 and again["losses"] == straight["losses"][4:]
    assert split["losses"] == pytest.approx(straight["losses"][:2], rel=1e-5)
