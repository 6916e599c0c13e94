"""The port's RNA-Puzzles batch CSV driver (``python -m
pamnet_tpu_torch.inference_rna_puzzles``) against the JAX package's
``inference_rna_puzzles.py``, both run in-process on the CPU in a temporary
working directory, on the same TU files (written by the port's TU writer
from synthetic RNA structures, with their file names) and the same weights
(a seeded model exported by ``export_state_dict`` as a reference ``.pt``).

Tolerances: in float32 each score within the scoring service's limit,
5e-5 + 1e-4 |score|; in bfloat16 within 1e-2 * max|score| of JAX's bfloat16
driver (the folded bfloat16 model's rule, ``tests/test_torch_sbf_bf16.py``)
and 3e-2 * max|score| of the port's float32 scores.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import csv
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from pamnet_tpu_torch import inference_rna_puzzles
from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.batch import PadSizes, precompute_structure, structure_counts
from pamnet_tpu_torch.data.synthetic import synthetic_rna_dataset
from pamnet_tpu_torch.data.tu import write_tu_split
from pamnet_tpu_torch.models.pamnet import PAMNet
from pamnet_tpu_torch.train.checkpoint import export_state_dict, save_checkpoint
from pamnet_tpu_torch.train.loop import Optimizer
from pamnet_tpu_torch.train.schedules import constant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = "rna_p17"  # puzzle_number "17": the name from its sixth character
STRUCTURES, BATCH = 5, 2  # batches of 2, 2 and 1 structures


def _jax_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_inference_rna_puzzles", os.path.join(REPO, "inference_rna_puzzles.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """(working directory, data root, the structures): TU files of
    ``STRUCTURES`` named structures and ``save/model.pt``, seeded weights of
    the published model (dim 16, 1 layer)."""
    work = tmp_path_factory.mktemp("rna_csv")
    mols = synthetic_rna_dataset(STRUCTURES, seed=11, n_atoms=60)
    for i, m in enumerate(mols):
        m["name"] = f"{DATASET}_candidate_{i}.pdb"
    root = str(work / "data" / "RNA-Puzzles")
    write_tu_split(root, DATASET, mols)
    cfg = PAMNetConfig(dataset=DATASET, dim=16, n_layer=1, cutoff_l=2.6, cutoff_g=20.0,
                       flow="target_to_source")
    model = PAMNet(cfg, torch.Generator().manual_seed(5))
    export_state_dict(model.state_dict(), str(work / "save" / "model.pt"))
    save_checkpoint(str(work / "save" / "model.ckpt"), model,
                    Optimizer(model.parameters(), constant(1e-4)))
    return work, root, mols


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return rows


def _port(monkeypatch, staged, *extra):
    work, root, _ = staged
    monkeypatch.chdir(work)
    res = inference_rna_puzzles.main(["--dataset", DATASET, "--batch_size", str(BATCH),
                                      "--saved_model", "model.pt", "--data_root", root,
                                      "--device", "cpu", *extra])
    rows = _read_csv(work / "rna_puzzles_predictions" / f"{DATASET}.csv")
    return res, rows


@pytest.fixture(scope="module")
def jax_rows(staged):
    """The JAX driver's CSV rows on the staged files, by compute dtype."""
    work, root, _ = staged
    driver = _jax_driver()
    out = {}
    cwd, argv = os.getcwd(), sys.argv
    try:
        os.chdir(work)
        for dtype in ("float32", "bfloat16"):
            sys.argv = ["inference_rna_puzzles.py", "--platform", "cpu", "--dataset", DATASET,
                        "--batch_size", str(BATCH), "--saved_model", "model.pt",
                        "--data_root", root, "--compute_dtype", dtype]
            driver.main()
            out[dtype] = _read_csv(work / "rna_puzzles_predictions" / f"{DATASET}.csv")
    finally:
        os.chdir(cwd)
        sys.argv = argv
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csv_matches_the_jax_driver(monkeypatch, staged, jax_rows, dtype):
    """The same header, tags (file names without ".pdb") and puzzle number,
    one row a structure in order, and scores within the dtype's limit."""
    res, rows = _port(monkeypatch, staged, "--compute_dtype", dtype)
    want = jax_rows[dtype]
    with open(res["csv"]) as f:
        assert f.readline() == "PAMNet,tag,puzzle_number\n"
    assert len(rows) == len(want) == STRUCTURES
    assert [r["tag"] for r in rows] == [w["tag"] for w in want] == [
        f"{DATASET}_candidate_{i}" for i in range(STRUCTURES)]
    assert {r["puzzle_number"] for r in rows} == {w["puzzle_number"] for w in want} == {"17"}
    got = np.array([float(r["PAMNet"]) for r in rows])
    ref = np.array([float(w["PAMNet"]) for w in want])
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got.astype(np.float32), res["scores"])
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


def test_each_batch_runs_at_its_exact_pads(monkeypatch, staged):
    """Every batch at its own counts rounded up to 128 rows and at least 8
    graphs (``PadSizes.for_counts``, JAX's ``ladder_pads="exact"``);
    ``--fixed_pads`` pads every batch to the set's worst case."""
    _, _, mols = staged
    counts = [structure_counts(precompute_structure(m, "rna", 2.6, 20.0)) for m in mols]
    batches = [list(range(s, min(s + BATCH, STRUCTURES))) for s in range(0, STRUCTURES, BATCH)]
    want = []
    for idxs in batches:
        n, eg, el, t2, t1 = np.sum([counts[i] for i in idxs], axis=0)
        want.append(PadSizes.for_counts(int(n), int(eg), int(el), int(t2), int(t1), len(idxs)))
    res, _ = _port(monkeypatch, staged)
    assert res["pads"] == want
    assert len(set(res["pads"])) > 1  # the batches differ in size
    fixed, _ = _port(monkeypatch, staged, "--fixed_pads")
    assert len(set(fixed["pads"])) == 1
    assert all(getattr(fixed["pads"][0], f) >= max(getattr(p, f) for p in want)
               for f in PadSizes.__dataclass_fields__)
    np.testing.assert_allclose(fixed["scores"], res["scores"], rtol=1e-5, atol=1e-6)


def test_bf16_scores_finite_and_near_f32(monkeypatch, staged):
    """``--compute_dtype bfloat16`` folds the published model (kernel B's
    bfloat16 version): finite scores within 3e-2 * max|score| of float32."""
    f32, _ = _port(monkeypatch, staged)
    b16, _ = _port(monkeypatch, staged, "--compute_dtype", "bfloat16")
    assert b16["scores"].dtype == np.float32 and np.all(np.isfinite(b16["scores"]))
    np.testing.assert_allclose(b16["scores"], f32["scores"], rtol=0,
                               atol=3e-2 * np.abs(f32["scores"]).max())
    assert not np.array_equal(b16["scores"], f32["scores"])


def test_port_checkpoint_scores_as_its_export(monkeypatch, staged):
    """A port training checkpoint (``save_checkpoint``) scores as the
    reference ``.pt`` exported from the same model."""
    pt, rows_pt = _port(monkeypatch, staged)
    ckpt, rows_ckpt = _port(monkeypatch, staged, "--saved_model", "model.ckpt")
    np.testing.assert_array_equal(ckpt["scores"], pt["scores"])
    assert rows_ckpt == rows_pt


def test_cuda_by_default_never_falls_back(monkeypatch, staged):
    """Without ``--device`` the driver runs on the card, and raises where
    there is none rather than scoring on the CPU."""
    work, root, _ = staged
    monkeypatch.chdir(work)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference_rna_puzzles.main(["--dataset", DATASET, "--saved_model", "model.pt",
                                    "--data_root", root])
