"""Native collation through a ``CollatePlan`` (``pamnet_tpu_torch/data/
batch.py`` over ``csrc/graphbuild.cc``'s ``concat_offset_i32`` /
``concat_rows_f32``) against the numpy ``collate_structures``: every tensor
of every batch bit for bit (the perms, CSR offsets, ``longest`` and
``valid`` included) on QM9, RNA and PDBbind structures, host and derive
geometry, with and without the backward's arrays, and PAMNet_s; a stale
structure, a pad overflow, the loader's batches, and the two C helpers
against the JAX package's on the same arrays.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import dataclasses

import numpy as np
import pytest

import torch

from pamnet_tpu.data import native as jnative
from pamnet_tpu_torch.config import atom_type_count
from pamnet_tpu_torch.data import native
from pamnet_tpu_torch.data.batch import CollatePlan, PadSizes, collate_structures
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule, synthetic_pdbbind_dataset,
                                             synthetic_qm9_dataset, synthetic_rna_dataset)

CUTOFFS = {"qm9": (5.0, 5.0), "rna": (2.6, 20.0), "pdbbind": (2.0, 6.0)}


def _mols(kind: str):
    if kind == "qm9":
        return synthetic_qm9_dataset(9, seed=3)
    if kind == "rna":
        return synthetic_rna_dataset(5, seed=3, n_atoms=70)
    return [pdbbind_molecule(g) for g in synthetic_pdbbind_dataset(6, seed=3)]


def assert_same_batch(got, want):
    """Every field of two ``GraphBatch``es equal, tensors bit for bit in
    value, type and shape."""
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), f.name
        elif f.name == "perms":
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
        else:
            assert g == w, f.name


@pytest.mark.parametrize("kind,geometry,perms,variant", [
    (k, geo, p, "full") for k in ("qm9", "rna", "pdbbind") for geo in ("host", "derive")
    for p in (False, True)] + [("qm9", "host", True, "s")])
def test_plan_matches_numpy_collation(kind, geometry, perms, variant):
    cut_l, cut_g = CUTOFFS[kind]
    loader = GraphLoader(_mols(kind), kind, cut_l, cut_g, batch_size=3, variant=variant,
                         wire_geometry=geometry)
    structs = loader.structs
    assert all("dist_g" in s for s in structs)
    assert all(("sbf_radial" in s) == (geometry == "host") for s in structs)
    plan = CollatePlan(structs)
    types = atom_type_count(kind) if kind != "pdbbind" else None
    order = np.random.default_rng(1).permutation(len(structs)).tolist()
    for idxs, pads in ((order[:3], loader.pads), (order[3:], None), ([2], loader.pads),
                       (list(range(len(structs))), None)):
        kw = dict(build_perms=perms, num_atom_types=types, variant=variant,
                  wire_geometry=geometry)
        got = collate_structures(None, pads, plan=plan, idxs=idxs, **kw)
        want = collate_structures([structs[i] for i in idxs], pads, **kw)
        assert_same_batch(got, want)
        assert (got.dist_g is None) == (geometry == "derive")
        assert bool(got.perms) == perms


def test_stale_structure_is_detected():
    loader = GraphLoader(_mols("qm9"), "qm9", 5.0, 5.0, batch_size=3)
    plan = CollatePlan(loader.structs)
    before = collate_structures(None, loader.pads, plan=plan, idxs=[1, 2])
    loader.structs[1]["t1"]["idx_ji"] = loader.structs[1]["t1"]["idx_ji"].copy()
    with pytest.raises(RuntimeError, match="stale: field 't1_ji' of structure 1"):
        collate_structures(None, loader.pads, plan=plan, idxs=[1, 2])
    # The plan holds the arrays it addresses: a batch whose first structure
    # is current reads a replaced array's old values, not freed memory.
    old = loader.structs[2]["pos"]
    loader.structs[2]["pos"] = old + 1.0
    again = collate_structures(None, loader.pads, plan=plan, idxs=[0, 2])
    n0 = loader.structs[0]["pos"].shape[0]
    assert torch.equal(again.pos[n0:n0 + old.shape[0]], torch.from_numpy(old))
    n = before.valid["n"]
    assert torch.equal(again.pos[n0:n0 + old.shape[0]], before.pos[n - old.shape[0]:n])
    with pytest.raises(RuntimeError, match="field 'pos' of structure 2"):
        plan.verify(2)


def test_fields_of_another_layout_are_read_from_copies():
    """A Fortran-ordered ``pos`` and an int64 ``z``: the plan reads
    contiguous copies it holds, bit for bit the numpy collation, and the
    structures still verify."""
    loader = GraphLoader(_mols("qm9"), "qm9", 5.0, 5.0, batch_size=3)
    structs = loader.structs
    structs[0]["pos"] = np.asfortranarray(structs[0]["pos"])
    structs[1]["z"] = structs[1]["z"].astype(np.int64)
    assert not structs[0]["pos"].flags.c_contiguous
    plan = CollatePlan(structs)
    for i in range(len(structs)):
        plan.verify(i)
    assert_same_batch(collate_structures(None, loader.pads, plan=plan, idxs=[1, 0, 2]),
                      collate_structures([structs[i] for i in (1, 0, 2)], loader.pads))


def test_pad_overflow_raises_as_numpy():
    loader = GraphLoader(_mols("qm9"), "qm9", 5.0, 5.0, batch_size=3)
    small = PadSizes(n=16, eg=1024, el=1024, t2=1024, t1=1024, g=8)
    plan = CollatePlan(loader.structs)
    with pytest.raises(ValueError, match=r"padding overflow: have \d+ rows, bucket holds 16"):
        collate_structures(loader.structs[:3], small)
    with pytest.raises(ValueError, match=r"padding overflow: have \d+ rows, bucket holds 16"):
        collate_structures(None, small, plan=plan, idxs=[0, 1, 2])


def test_loader_batches_come_from_the_plan(monkeypatch):
    calls = {"i32": 0, "f32": 0}
    real_i32, real_f32 = native.concat_offset_i32, native.concat_rows_f32

    def count_i32(*a):
        calls["i32"] += 1
        return real_i32(*a)

    def count_f32(*a):
        calls["f32"] += 1
        return real_f32(*a)

    monkeypatch.setattr(native, "concat_offset_i32", count_i32)
    monkeypatch.setattr(native, "concat_rows_f32", count_f32)
    mols = _mols("qm9")
    loader = GraphLoader(mols, "qm9", 5.0, 5.0, batch_size=4, shuffle=True, seed=2,
                         build_perms=True)
    batches = list(loader)
    assert len(batches) == 3 and calls["i32"] == 15 * 3
    assert calls["f32"] == 7 * 3  # pos, feat, two distances, three basis tables
    # The loader's batches are the numpy collation of the same molecules.
    plain = GraphLoader(mols, "qm9", 5.0, 5.0, batch_size=4, shuffle=True, seed=2,
                        build_perms=True)
    for idxs, got in zip(plain.batches(), batches):
        assert_same_batch(got, collate_structures(
            [plain.structs[i] for i in idxs], plain.pads, build_perms=True,
            num_atom_types=atom_type_count("qm9")))
    [loader.collate(idxs, build_perms=False) for idxs in loader.batches()]
    assert calls["i32"] == 15 * 6


def test_loader_raises_where_the_library_cannot_build(monkeypatch):
    loader = GraphLoader(_mols("qm9"), "qm9", 5.0, 5.0, batch_size=4)

    def no_library():
        raise RuntimeError("g++ not found: the native graph builders cannot be built")

    monkeypatch.setattr(native, "library", no_library)
    with pytest.raises(RuntimeError, match="cannot be built"):
        next(iter(loader))


def test_c_helpers_match_jax_native():
    """The same arrays through the JAX package's library and the port's."""
    assert jnative.has_collate()
    rng = np.random.default_rng(4)
    ints = [rng.integers(-50, 1000, int(n)).astype(np.int32) for n in (5, 0, 17, 3)]
    offs = np.array([0, 7, 40, 1_000_000], np.int32)
    want, m = jnative.concat_offset_i32(ints, offs, 64)
    assert m == 25
    got = native.concat_offset_i32(*native.addresses(ints), offs, 64)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    rows = [rng.standard_normal((int(n), 6)).astype(np.float32) for n in (4, 0, 9)]
    want, _ = jnative.concat_rows_f32(rows, 20)
    got = native.concat_rows_f32(*native.addresses(rows), (6,), 20)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    flat = [r[:, 0].copy() for r in rows]
    want, _ = jnative.concat_rows_f32(flat, 16)
    got = native.concat_rows_f32(*native.addresses(flat), (), 16)
    assert got.shape == want.shape == (16,) and np.array_equal(got, want)
    # int32 wraparound, as numpy's addition.
    big = [np.array([2**31 - 2, 5], np.int32)]
    got = native.concat_offset_i32(*native.addresses(big), np.array([3], np.int32), 4)
    assert np.array_equal(got, np.concatenate([big[0] + np.int32(3), [0, 0]]).astype(np.int32))
    with pytest.raises(ValueError, match="padding overflow: have 25 rows, bucket holds 24"):
        native.concat_offset_i32(*native.addresses(ints), offs, 24)


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    """A library built from another version of the source is never loaded:
    the name carries the source's hash."""
    current = native.library_path()
    old = tmp_path / "graphbuild.cc"
    old.write_text(native.SOURCE.read_text().split("// Collation:")[0])
    monkeypatch.setattr(native, "SOURCE", old)
    assert native.library_path() != current
    assert native.library_path().parent == current.parent
