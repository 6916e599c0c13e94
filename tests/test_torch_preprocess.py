"""The port's data-preparation path against the JAX package's: the mol2
parser, the SMARTS engine and the featurizer (every mol2 fixture of
``tests/test_preprocess.py``, the ``ours`` column of the featurizer
divergence registry, complexes of the raw PDBbind fixture), the PDB parser
and its ``rms`` label, both preprocessors writing the JAX preprocessors'
TU files byte for byte from the same raw trees, and the whole chain from
raw mol2 files through ``main_pdbbind`` on the CPU.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import ast
import os
import re
import textwrap
from pathlib import Path

import numpy as np
import pytest

import preprocess_pdbbind as jpre_pdbbind  # the JAX drivers, from the repository root
import preprocess_rna_puzzles as jpre_rna
from pamnet_tpu.data import featurizer as jfeat
from pamnet_tpu.data import mol2 as jmol2
from pamnet_tpu.data import pdb as jpdb
from pamnet_tpu.data import smarts as jsmarts
from pamnet_tpu.data.featurizer_divergences import EXPECTED_DIVERGENCES, VERIFIED_MATCHES
from pamnet_tpu_torch import preprocess_pdbbind as tpre_pdbbind
from pamnet_tpu_torch import preprocess_rna_puzzles as tpre_rna
from pamnet_tpu_torch.data import featurizer as tfeat
from pamnet_tpu_torch.data import mol2 as tmol2
from pamnet_tpu_torch.data import pdb as tpdb
from pamnet_tpu_torch.data import smarts as tsmarts
from pamnet_tpu_torch.data.synthetic import (synthetic_rna_dataset, write_raw_pdbbind,
                                             write_raw_rna_puzzles)

TESTS = Path(__file__).resolve().parent


def _string_constants(path: Path, keep) -> list[str]:
    """The string literals of a test module that ``keep`` accepts, in
    source order, without repeats."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and keep(node.value):
            if node.value not in out:
                out.append(node.value)
    return out


MOL2_FIXTURES = [textwrap.dedent(s) for s in _string_constants(
    TESTS / "test_preprocess.py", lambda s: "@<TRIPOS>MOLECULE" in s)]
SMARTS_PATTERNS = sorted(set(_string_constants(
    TESTS / "test_smarts.py", lambda s: s.startswith("[") and s.endswith("]"))
    + list(jfeat.REFERENCE_SMARTS.values())))
REGISTRY = EXPECTED_DIVERGENCES + VERIFIED_MATCHES
PDB_TEXT = _string_constants(TESTS / "test_preprocess.py",
                             lambda s: s.startswith("ATOM ") and "rms" in s)[0]


def _same_mol2(a, b) -> None:
    for f in ("atomic_num", "pos", "charge"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.sybyl, a.subst, a.bonds) == (b.sybyl, b.subst, b.bonds)


def _same_features(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse and featurize ``path`` in both packages; assert the parsed
    molecules and the (coords, features) arrays are equal bit for bit."""
    tm, jm = tmol2.parse_mol2(path), jmol2.parse_mol2(path)
    _same_mol2(tm, jm)
    got, want = tfeat.featurize_mol2(tm), jfeat.featurize_mol2(jm)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    return got


def test_fixtures_were_found():
    assert len(MOL2_FIXTURES) >= 12 and len(SMARTS_PATTERNS) >= 30 and REGISTRY


@pytest.mark.parametrize("idx", range(len(MOL2_FIXTURES)))
def test_featurizer_matches_jax_on_test_fixtures(tmp_path, idx):
    path = tmp_path / "fixture.mol2"
    path.write_text(MOL2_FIXTURES[idx])
    coords, feats = _same_features(str(path))
    assert feats.shape[1] == len(tfeat.FEATURE_NAMES) == 18


@pytest.mark.parametrize("entry", REGISTRY, ids=lambda d: d.name)
def test_registry_ours_column(tmp_path, entry):
    """The port's featurizer emits the registry's ``ours`` value on every
    divergence and verified-match entry, and JAX's features bit for bit."""
    path = tmp_path / f"{entry.name}.mol2"
    path.write_text(entry.mol2)
    _, feats = _same_features(str(path))
    assert float(feats[entry.atom, tfeat.FEATURE_NAMES.index(entry.feature)]) == entry.ours


def test_featurizer_matches_jax_on_raw_complexes(tmp_path):
    ids = write_raw_pdbbind(str(tmp_path), 3, 1, seed=21, pocket_heavy=(120, 160))
    for pid in ids:
        for part in ("ligand", "pocket"):
            _same_features(str(tmp_path / "refined-set" / pid / f"{pid}_{part}.mol2"))


def _perceived(pkg, seed: int, n: int = 120):
    """A random perception (``tests/test_smarts.py``'s random graphs) as the
    package's ``PerceivedMol``."""
    rng = np.random.default_rng(seed)
    nbrs = [[] for _ in range(n)]
    for _ in range(2 * n):
        i, j = int(rng.integers(0, n)), int(rng.integers(0, n))
        order = str(rng.choice(["1", "2", "3", "ar", "am"]))
        nbrs[i].append((j, order))
        nbrs[j].append((i, order))
    return pkg.PerceivedMol(
        z=rng.choice([1, 5, 6, 7, 8, 9, 15, 16, 17, 34, 30], n).astype(np.int64),
        aromatic=rng.random(n) < 0.3, formal_charge=rng.choice([-2, -1, 0, 0, 0, 1, 2], n),
        num_h=rng.integers(0, 4, n), connectivity=rng.integers(0, 5, n),
        valence=rng.integers(0, 7, n), hyb=rng.integers(0, 4, n),
        in_ring=rng.random(n) < 0.4, neighbors=nbrs)


@pytest.mark.parametrize("pattern", SMARTS_PATTERNS)
def test_smarts_matches_jax(pattern):
    try:
        want_pat = jsmarts.compile_smarts(pattern)
    except ValueError:
        with pytest.raises(ValueError):
            tsmarts.compile_smarts(pattern)
        return
    got_pat = tsmarts.compile_smarts(pattern)
    for seed in range(3):
        got = got_pat.match_all(_perceived(tsmarts, seed))
        want = want_pat.match_all(_perceived(jsmarts, seed))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_smarts_unsupported_constructs_raise():
    for bad in ("[r5]", "[$([C](N)O)]", "C", "[@]"):
        with pytest.raises(ValueError):
            tsmarts.compile_smarts(bad)


def test_pdb_parser_and_rms_label(tmp_path):
    path = tmp_path / "cand.pdb"
    path.write_text(PDB_TEXT)
    got, want = tpdb.parse_pdb_atoms(str(path)), jpdb.parse_pdb_atoms(str(path))
    assert got[0] == want[0] == ["P", "C", "N", "O", "H"]
    assert got[1].dtype == want[1].dtype and np.array_equal(got[1], want[1])
    lines = tpdb.parse_pdb_atoms(PDB_TEXT.splitlines())  # the service's form
    assert lines[0] == got[0] and np.array_equal(lines[1], got[1])
    assert tpdb.parse_rms_label(str(path)) == jpdb.parse_rms_label(str(path)) == 4.321
    bad = tmp_path / "no_rms.pdb"
    bad.write_text(PDB_TEXT.replace("rms", "xyz"))
    with pytest.raises(ValueError, match="no rms record"):
        tpdb.parse_rms_label(str(bad))


def _tree_bytes(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.txt"))}


def test_preprocess_pdbbind_writes_jax_bytes(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    ids = write_raw_pdbbind(str(raw), 5, 2, seed=3, pocket_heavy=(150, 200))
    out = {}
    for name in ("port", "jax"):
        data = tmp_path / name
        for split in ("refined-set", "core-set"):
            os.makedirs(data, exist_ok=True)
            os.symlink(raw / split, data / split)
    mols = tpre_pdbbind.main(["--data_dir", str(tmp_path / "port")])
    monkeypatch.setattr("sys.argv", ["preprocess_pdbbind.py", "--data_dir",
                                     str(tmp_path / "jax")])
    jpre_pdbbind.main()
    for name in ("port", "jax"):
        out[name] = {k: v for k, v in _tree_bytes(tmp_path / name).items()
                     if k.startswith(("train_val", "test"))}
    assert sorted(out["port"]) == sorted(out["jax"]) and len(out["port"]) == 8
    assert out["port"] == out["jax"]
    assert [len(mols["test"]), len(mols["train_val"])] == [2, 3]
    assert ids[-2:] == sorted(os.listdir(raw / "core-set"))
    # The 6 A cut leaves complexes of a few hundred atoms in the three-subgraph
    # layout; the labels keep two decimals.
    assert all(m["feat"].shape == (len(m["pos"]), 18) for m in mols["test"])
    labels = (tmp_path / "port" / "test" / "raw" / "test_graph_labels.txt").read_text()
    assert all(re.fullmatch(r"-?\d+\.\d\d", v) for v in labels.splitlines())


def test_pdbbind_build_complex_matches_jax(tmp_path):
    write_raw_pdbbind(str(tmp_path), 1, 0, seed=4, pocket_heavy=(150, 200))
    (pid,) = [d for d in os.listdir(tmp_path / "refined-set") if d != "index"]
    args = [str(tmp_path / "refined-set" / pid / f"{pid}_{p}.mol2") for p in ("ligand", "pocket")]
    got, want = tpre_pdbbind.build_complex(*args), jpre_pdbbind.build_complex(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    pocket = tmol2.parse_mol2(args[1])
    n = tpre_pdbbind.pocket_heavy_atom_count(pocket)
    assert n == jpre_pdbbind.pocket_heavy_atom_count(jmol2.parse_mol2(args[1]))
    assert n < int((pocket.atomic_num > 1).sum())  # the waters are cut
    assert (got[0][len(got[0]) // 2:, 0] > 40).all() and (got[0][: len(got[0]) // 2, 0] < 40).all()


def test_preprocess_rna_writes_jax_bytes(tmp_path):
    write_raw_rna_puzzles(str(tmp_path / "raw"), 3, 2, seed=5, n_atoms=80)
    mols = tpre_rna.main(["--data_dir", str(tmp_path / "raw"),
                          "--save_dir", str(tmp_path / "port")])
    for split, save in (("example_train", "train"), ("example_val", "val")):
        jpre_rna.construct_graphs(str(tmp_path / "raw"), str(tmp_path / "jax"), split, save)
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 10 and got == want
    # C/N/O only, in order, with the rms labels of the files.
    src = synthetic_rna_dataset(5, seed=5, n_atoms=80)
    for m, s in zip(mols["train"] + mols["val"], src):
        assert np.array_equal(m["z"], s["z"]) and m["y"] == round(s["y"], 3)
        np.testing.assert_allclose(m["pos"], s["pos"], rtol=0, atol=6e-4)


def test_full_chain_raw_files_to_training(tmp_path):
    """Raw mol2 files -> the port's preprocessor -> TU files ->
    ``main_pdbbind`` for one epoch on the CPU at dim 8, reading the
    preprocessed complexes as written."""
    from pamnet_tpu_torch import main_pdbbind
    from pamnet_tpu_torch.data.tu import TUDataset

    data = tmp_path / "PDBbind"
    write_raw_pdbbind(str(data), 7, 2, seed=6, pocket_heavy=(120, 160))
    mols = tpre_pdbbind.main(["--data_dir", str(data)])
    read = TUDataset(str(data), "train_val").molecules()
    assert len(read) == len(mols["train_val"]) == 5
    for r, m in zip(read, mols["train_val"]):
        np.testing.assert_allclose(r["pos"], m["pos"], atol=5e-4)
        np.testing.assert_allclose(r["feat"], m["feat"], atol=5e-5)
    res = main_pdbbind.main(["--data_root", str(data), "--epochs", "1", "--dim", "8",
                             "--n_layer", "1", "--batch_size", "2", "--device", "cpu",
                             "--save_dir", str(tmp_path / "save"),
                             "--structure_cache", str(tmp_path / "cache")])
    assert len(res["train"]) == 1 and all(np.isfinite(res["train"][0]))
    assert np.isfinite(res["test"][0])
