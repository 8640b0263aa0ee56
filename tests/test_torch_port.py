"""Boundaries of the PyTorch port: it imports no JAX and nothing of the JAX
package, its entry points refuse to run without CUDA unless the caller asks
for the CPU, and ``chip_smoke.py`` fails (printing no result) without a card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15 and bad == "[]", out.stdout


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 16
    for f in files:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro"}, f


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.models import LM, params_from_jax
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("codeqwen1.5-7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({})
    m = LM(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(m, p)
    assert ServeEngine(m, p, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_cannot_run(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo, the
    port is missing and the script fails before printing a result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run(
        [sys.executable, str(lone)], env=env, capture_output=True, text=True, timeout=120,
        cwd=tmp_path,
    )
    assert out.returncode != 0
    assert "No module named 'repro_torch'" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
