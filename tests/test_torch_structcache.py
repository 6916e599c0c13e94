"""The port's on-disk structure cache (``pamnet_tpu_torch/data/structcache.py``)
against direct builds and against the JAX package's cache: the cases of
``tests/test_structcache.py`` on the port (cache equals direct build, a hit
builds nothing, a changed cutoff or a moved atom invalidates, a partial
build resumes, PAMNet_s's empty t2, PDBbind features, the loader reads the
cache), a cache directory shared both ways between the packages with no
chunk rebuilt (the same chunk names, the structures bit for bit), the
spawn pool bit for bit the in-process build, a collate plan over cached
structures bit for bit one over fresh ones, and the drivers'
``--structure_cache`` meeting JAX's loaders' keys.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import glob
import os

import numpy as np
import pytest

import pamnet_tpu.data.structcache as jsc
from pamnet_tpu.data.loader import GraphLoader as JaxLoader
from pamnet_tpu_torch.data import structcache as tsc
from pamnet_tpu_torch.data.batch import CollatePlan, collate_structures
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule, synthetic_pdbbind_dataset,
                                             synthetic_qm9_dataset, synthetic_rna_dataset)
from test_torch_collate_plan import assert_same_batch

SPEC = tsc.BuildSpec("qm9", 5.0, 5.0)
KINDS = {
    "qm9": (lambda: synthetic_qm9_dataset(7, seed=11), dict(cutoff_l=5.0, cutoff_g=5.0)),
    "qm9_s": (lambda: synthetic_qm9_dataset(5, seed=12),
              dict(cutoff_l=5.0, cutoff_g=5.0, variant="s", precompute_basis=False)),
    "pdbbind": (lambda: [pdbbind_molecule(g) for g in synthetic_pdbbind_dataset(5, seed=13)],
                dict(cutoff_l=2.0, cutoff_g=6.0)),
    "rna": (lambda: synthetic_rna_dataset(4, seed=14, n_atoms=60),
            dict(cutoff_l=2.6, cutoff_g=20.0, precompute_basis=False)),
}


def _spec(pkg, kind: str):
    kw = dict(KINDS[kind][1])
    return pkg.BuildSpec("qm9" if kind.startswith("qm9") else kind, kw.pop("cutoff_l"),
                         kw.pop("cutoff_g"), **kw)


def _assert_structs_equal(got, want):
    """Every field of every structure equal in value, dtype and shape."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            pairs = [(a[k][kk], b[k][kk]) for kk in b[k]] if k in ("t2", "t1") \
                else [(a[k], b[k])]
            for x, y in pairs:
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and x.shape == y.shape, k
                np.testing.assert_array_equal(x, y, err_msg=k)


def _chunks(path) -> list[str]:
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(str(path), "*.npz")))


def _no_build(monkeypatch, pkg_module, name):
    def boom(*a, **k):
        raise AssertionError("cache miss: a chunk was rebuilt")

    monkeypatch.setattr(pkg_module, name, boom)


def test_cache_matches_direct_build(tmp_path):
    mols = synthetic_qm9_dataset(10, seed=1)
    got = tsc.load_or_build(mols, SPEC, str(tmp_path), chunk_size=4)
    assert tsc.load_or_build.built == 3 and len(_chunks(tmp_path)) == 3  # ceil(10/4)
    _assert_structs_equal(got, tsc.build_structures(mols, SPEC))
    for s in got:  # the (2, E) arrays are C-contiguous, as built
        assert s["eg"].flags.c_contiguous and s["el"].flags.c_contiguous


def test_cache_hit_builds_nothing(tmp_path, monkeypatch, capsys):
    mols = synthetic_qm9_dataset(6, seed=2)
    first = tsc.load_or_build(mols, SPEC, str(tmp_path), chunk_size=4, progress=True)
    assert "structcache: built 2/2 chunks" in capsys.readouterr().out
    _no_build(monkeypatch, tsc, "build_structures")
    second = tsc.load_or_build(mols, SPEC, str(tmp_path), chunk_size=4, progress=True)
    assert tsc.load_or_build.built == 0 and capsys.readouterr().out == ""
    _assert_structs_equal(second, first)


def test_content_addressing_invalidates(tmp_path):
    mols = synthetic_qm9_dataset(4, seed=3)
    tsc.load_or_build(mols, SPEC, str(tmp_path), chunk_size=4)
    n0 = len(_chunks(tmp_path))
    tsc.load_or_build(mols, tsc.BuildSpec("qm9", 4.0, 5.0), str(tmp_path), chunk_size=4)
    assert tsc.load_or_build.built == 1 and len(_chunks(tmp_path)) == n0 + 1
    moved = [dict(m) for m in mols]
    moved[0]["pos"] = moved[0]["pos"] + 0.1
    assert tsc.mol_fingerprint(moved[0]) != tsc.mol_fingerprint(mols[0])
    got = tsc.load_or_build(moved, SPEC, str(tmp_path), chunk_size=4)
    assert tsc.load_or_build.built == 1 and len(_chunks(tmp_path)) == n0 + 2
    _assert_structs_equal(got, tsc.build_structures(moved, SPEC))


def test_resume_after_partial_build(tmp_path):
    mols = synthetic_qm9_dataset(8, seed=4)
    tsc.load_or_build(mols[:4], SPEC, str(tmp_path), chunk_size=4)
    assert len(_chunks(tmp_path)) == 1
    got = tsc.load_or_build(mols, SPEC, str(tmp_path), chunk_size=4)
    assert tsc.load_or_build.built == 1 and len(_chunks(tmp_path)) == 2
    _assert_structs_equal(got, tsc.build_structures(mols, SPEC))


def test_unreadable_chunk_raises_and_is_not_rebuilt(tmp_path):
    mols = synthetic_qm9_dataset(4, seed=5)
    tsc.load_or_build(mols, SPEC, str(tmp_path), chunk_size=4)
    (path,) = glob.glob(str(tmp_path / "*.npz"))
    with open(path, "wb") as f:
        f.write(b"not a chunk")
    with pytest.raises(Exception):
        tsc.load_or_build(mols, SPEC, str(tmp_path), chunk_size=4)
    assert open(path, "rb").read() == b"not a chunk"


def test_pack_roundtrip_variant_s_empty_t2():
    spec = tsc.BuildSpec("qm9", 5.0, 5.0, variant="s", precompute_basis=False)
    structs = tsc.build_structures(synthetic_qm9_dataset(3, seed=5), spec)
    assert structs[0]["t2"]["idx_ji"].size == 0
    _assert_structs_equal(tsc.unpack_chunk(tsc.pack_chunk(structs)), structs)


def test_pack_roundtrip_pdbbind_features():
    rng = np.random.default_rng(6)
    mols = [{"pos": rng.normal(size=(n, 3)).astype(np.float32) * 3,
             "feat": rng.normal(size=(n, 18)).astype(np.float32), "y": float(rng.normal())}
            for n in rng.integers(8, 16, size=3)]
    structs = tsc.build_structures(mols, tsc.BuildSpec("pdbbind", 2.0, 6.0))
    _assert_structs_equal(tsc.unpack_chunk(tsc.pack_chunk(structs)), structs)


@pytest.mark.parametrize("geometry", ["host", "derive"])
def test_loader_uses_cache(tmp_path, geometry):
    mols = synthetic_qm9_dataset(6, seed=7)
    kw = dict(batch_size=2, shuffle=True, seed=3, build_perms=True, wire_geometry=geometry)
    cached = GraphLoader(mols, "qm9", 5.0, 5.0, cache_dir=str(tmp_path), **kw)
    assert cached.cache_built == 1 and _chunks(tmp_path)
    fresh = GraphLoader(mols, "qm9", 5.0, 5.0, **kw)
    assert fresh.cache_built is None
    # Derive batches build no host basis, so the spec (and the chunk) differ.
    assert ("sbf_radial" in cached.structs[0]) == (geometry == "host")
    for a, b in zip(cached, fresh):
        assert_same_batch(a, b)
    again = GraphLoader(mols, "qm9", 5.0, 5.0, cache_dir=str(tmp_path), **kw)
    assert again.cache_built == 0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jax_cache_is_served_by_the_port(tmp_path, monkeypatch, kind):
    mols = KINDS[kind][0]()
    want = jsc.load_or_build(mols, _spec(jsc, kind), str(tmp_path), chunk_size=3)
    names = _chunks(tmp_path)
    _no_build(monkeypatch, tsc, "build_structures")
    got = tsc.load_or_build(mols, _spec(tsc, kind), str(tmp_path), chunk_size=3)
    assert tsc.load_or_build.built == 0 and _chunks(tmp_path) == names
    _assert_structs_equal(got, want)
    monkeypatch.undo()
    _assert_structs_equal(got, tsc.build_structures(mols, _spec(tsc, kind)))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_cache_is_served_by_jax(tmp_path, monkeypatch, kind):
    mols = KINDS[kind][0]()
    got = tsc.load_or_build(mols, _spec(tsc, kind), str(tmp_path), chunk_size=3)
    names = _chunks(tmp_path)
    assert tsc.load_or_build.built == len(names) == -(-len(mols) // 3)
    _no_build(monkeypatch, jsc, "_build_structs")
    want = jsc.load_or_build(mols, _spec(jsc, kind), str(tmp_path), chunk_size=3)
    assert _chunks(tmp_path) == names
    _assert_structs_equal(got, want)


def test_spec_key_holds_python_values():
    """A numpy scalar cutoff keys as the Python float JAX's drivers pass."""
    spec = tsc.BuildSpec("qm9", np.float64(5.0), np.float32(5.0), "full", np.bool_(True),
                         np.int64(7), 6, 5)
    assert spec.key() == tsc.BuildSpec("qm9", 5.0, 5.0).key() == jsc.BuildSpec("qm9", 5.0, 5.0).key()
    assert isinstance(spec.cutoff_l, float) and type(spec.precompute_basis) is bool
    assert tsc.BuildSpec("rna", 2.6, 20.0).key() == jsc.BuildSpec("rna", 2.6, 20.0).key()


def test_fingerprint_ignores_the_readers_dtypes():
    mol = synthetic_qm9_dataset(1, seed=9)[0]
    other = dict(mol, z=mol["z"].astype(np.int64), edge_index=mol["edge_index"].astype(np.int32),
                 pos=mol["pos"].astype(np.float64), y=np.float64(mol["y"]))
    assert tsc.mol_fingerprint(other) == tsc.mol_fingerprint(mol) == jsc.mol_fingerprint(mol)


def test_workers_match_in_process_build(tmp_path):
    mols = synthetic_qm9_dataset(8, seed=8)
    got = tsc.load_or_build(mols, SPEC, str(tmp_path / "pool"), chunk_size=2, num_workers=2)
    assert tsc.load_or_build.built == 4
    want = tsc.load_or_build(mols, SPEC, str(tmp_path / "inproc"), chunk_size=2)
    assert _chunks(tmp_path / "pool") == _chunks(tmp_path / "inproc")
    _assert_structs_equal(got, want)
    _assert_structs_equal(got, tsc.build_structures(mols, SPEC))


@pytest.mark.parametrize("kind", ["qm9", "pdbbind", "rna"])
def test_plan_over_cached_structures(tmp_path, kind):
    """The port's counterpart of tests/test_collate_plan.py:123: a plan over
    structures read back from the cache collates bit for bit as one over
    freshly built structures, and reads none of them through a copy."""
    mols = KINDS[kind][0]()
    spec = _spec(tsc, kind)
    cached = tsc.load_or_build(mols, spec, str(tmp_path), chunk_size=3)
    fresh = tsc.build_structures(mols, spec)
    p_cached, p_fresh = CollatePlan(cached), CollatePlan(fresh)
    assert all(np.array_equal(p_cached.addr[k], p_cached._live[k]) for k in p_cached.addr)
    for idxs in ([0, 1], [2, 0, 3], list(range(len(mols)))):
        for perms in (False, True):
            kw = dict(build_perms=perms, variant=spec.variant)
            assert_same_batch(collate_structures(None, plan=p_cached, idxs=idxs, **kw),
                              collate_structures(None, plan=p_fresh, idxs=idxs, **kw))
            assert_same_batch(collate_structures(None, plan=p_cached, idxs=idxs, **kw),
                              collate_structures([fresh[i] for i in idxs], **kw))


@pytest.mark.parametrize("which", ["qm9", "pdbbind", "rna"])
def test_driver_cache_serves_jax_loaders(tmp_path, monkeypatch, which):
    """A port driver run with ``--structure_cache`` writes the chunks JAX's
    loaders, built with the JAX driver's cache arguments over the same
    splits, are served from without a build (train derive: no host basis;
    evaluation: host basis); a second port run builds nothing."""
    from pamnet_tpu_torch import main_pdbbind, main_qm9, main_rna_puzzles
    from pamnet_tpu_torch.data.tu import write_tu_split

    cache = str(tmp_path / "cache")
    common = ["--epochs", "1", "--dim", "8", "--n_layer", "1", "--device", "cpu",
              "--save_dir", str(tmp_path / "save"), "--structure_cache", cache]
    if which == "qm9":
        driver, kind = main_qm9, "qm9"
        argv = common + ["--synthetic", "--limit", "20", "--batch_size", "4",
                         "--cache_workers", "0"]
    elif which == "pdbbind":
        driver, kind = main_pdbbind, "pdbbind"
        graphs = [pdbbind_molecule(g) for g in synthetic_pdbbind_dataset(12, seed=4)]
        write_tu_split(str(tmp_path / "pdb"), "train_val", graphs[:9], label_fmt="%.2f")
        write_tu_split(str(tmp_path / "pdb"), "test", graphs[9:], label_fmt="%.2f")
        argv = common + ["--data_root", str(tmp_path / "pdb"), "--batch_size", "4"]
    else:
        driver, kind = main_rna_puzzles, "rna"
        structs = synthetic_rna_dataset(6, seed=5, n_atoms=50)
        write_tu_split(str(tmp_path / "rna"), "train", structs[:4])
        write_tu_split(str(tmp_path / "rna"), "val", structs[4:])
        argv = common + ["--data_root", str(tmp_path / "rna"), "--batch_size", "2"]
    args = driver.build_parser().parse_args(argv)
    if which == "qm9":
        mols, n_train, n_val = driver.load_molecules(args)
        splits = [mols[:n_train], mols[n_train:n_train + n_val], mols[n_train + n_val:]]
    else:  # the drivers' (train, val[, test]) molecules
        splits = (driver.load_complexes if which == "pdbbind" else driver.load_structures)(args)
    driver.main(argv)
    names = _chunks(cache)
    assert names
    _no_build(monkeypatch, tsc, "build_structures")
    driver.main(argv)  # warm: every loader served
    assert _chunks(cache) == names
    _no_build(monkeypatch, jsc, "_build_structs")
    cut = dict(cutoff_l=args.cutoff_l, cutoff_g=args.cutoff_g, cache_dir=cache)
    for i, split in enumerate(splits):
        JaxLoader(split, kind, batch_size=args.batch_size,
                  wire_geometry="derive" if i == 0 else "host", **cut)
    assert _chunks(cache) == names
