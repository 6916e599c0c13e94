"""Nothing the harness or the reference imports has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``pamnet_tpu`` (compared whole: the port's
``pamnet_tpu_torch`` begins with ``pamnet_tpu``), the reference imports
nothing of the program, and a run without a card fails with no result."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

ROOT = run.ROOT
SOURCES = sorted(p for p in run.HERE.rglob("*.py") if "tests" not in p.parts)


def _imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(run.HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((run.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    # importlib: ``steps.model_of`` finds the configuration's reference module
    # under ``benchmark.reference`` by name
    assert _imported(path) <= {"__future__", "math", "functools", "importlib", "numpy",
                               "torch", "benchmark"}
    text = path.read_text()
    assert "pamnet_tpu" not in "\n".join(line for line in text.splitlines()
                                          if "import" in line)


def test_the_harness_loads_no_forbidden_module():
    """Every module of the harness, the drivers (which import the port) and
    the reference, imported in a fresh interpreter: no forbidden top-level
    name among what they brought in."""
    code = (
        "import sys\n"
        "before = {m.split('.')[0] for m in sys.modules}\n"
        "import benchmark.run, benchmark.calibrate, benchmark.trace, benchmark.check\n"
        "import benchmark.drivers.train_epochs, benchmark.drivers.score_service\n"
        "import benchmark.reference.steps\n"
        "import pamnet_tpu_torch.serve, pamnet_tpu_torch.train.loop\n"
        "import pamnet_tpu_torch.models.pamnet, pamnet_tpu_torch.data.loader\n"
        "new = {m.split('.')[0] for m in sys.modules} - before\n"
        "print(sorted(new & set(benchmark.run.FORBIDDEN)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pamnet_tpu_torch_fake", sys)
    assert "pamnet_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pamnet_tpu.fake", sys)
    assert "pamnet_tpu" in run.forbidden_modules()


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "qm9_train",
                          "--seed", "2147483650", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
    assert "CUDA card" in out.stderr
