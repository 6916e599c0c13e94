"""The port, its kernel checker and its card tests import nothing of JAX or
of the JAX package.  Read from the source (AST), since a process here may
hold jax in sys.modules already."""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pamnet_tpu"}
# The card's tests run where JAX is not installed: they import none of it either.
FILES = sorted((ROOT / "pamnet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "test_torch_card_paths.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.is_file()
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom pamnet_tpu.ops import ell\n"
                     "from pamnet_tpu_torch import serve\n")
    assert _imported_roots(probe) & FORBIDDEN == {"jax", "pamnet_tpu"}


def test_scan_covers_every_module_of_the_port():
    """The training modules, the three training entry points, the bench,
    the graph-construction and geometry modules, the artifact reader, the
    data-parallel modules, the structure cache, the data-preparation
    modules (preprocessors, mol2, SMARTS, featurizer, PDB) and the epoch
    pipeline's modules (the loader's ``prefetch``, the batch's copies, the
    CSV driver) are among the scanned files."""
    scanned = {str(p.relative_to(ROOT)) for p in FILES}
    for rel in ("pamnet_tpu_torch/train/loop.py", "pamnet_tpu_torch/train/ema.py",
                "pamnet_tpu_torch/train/schedules.py", "pamnet_tpu_torch/main_qm9.py",
                "pamnet_tpu_torch/data/qm9.py", "pamnet_tpu_torch/data/synthetic.py",
                "pamnet_tpu_torch/serve.py", "pamnet_tpu_torch/main_rna_puzzles.py",
                "pamnet_tpu_torch/train/checkpoint.py", "pamnet_tpu_torch/data/tu.py",
                "pamnet_tpu_torch/main_pdbbind.py", "pamnet_tpu_torch/bench.py",
                "pamnet_tpu_torch/metrics.py", "pamnet_tpu_torch/data/native.py",
                "pamnet_tpu_torch/ops/neighbors.py", "pamnet_tpu_torch/models/device_graph.py",
                "pamnet_tpu_torch/ops/basis.py", "pamnet_tpu_torch/data/torchpickle.py",
                "pamnet_tpu_torch/parallel/__init__.py", "pamnet_tpu_torch/parallel/dp.py",
                "pamnet_tpu_torch/data/structcache.py", "pamnet_tpu_torch/data/mol2.py",
                "pamnet_tpu_torch/data/smarts.py", "pamnet_tpu_torch/data/featurizer.py",
                "pamnet_tpu_torch/data/pdb.py", "pamnet_tpu_torch/preprocess_pdbbind.py",
                "pamnet_tpu_torch/preprocess_rna_puzzles.py", "pamnet_tpu_torch/profiling.py",
                "pamnet_tpu_torch/data/loader.py", "pamnet_tpu_torch/data/batch.py",
                "pamnet_tpu_torch/inference_rna_puzzles.py", "chip_smoke.py"):
        assert rel in scanned, rel
