"""A batch's CSR arrays from the native library (``native.csr_perm``, a
stable counting sort, and ``native.csr_offsets``, over
``pamnet_tpu_torch/csrc/graphbuild.cc``) against their numpy reference
(``data/batch.py::build_perm_np``, ``_offsets``), bit for bit: on hand-made
id arrays, on every batch of a training loader's epoch over RNA, QM9 and
PDBbind structures, and the span ``collate.csr`` inside ``loader.collate``.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

from collections import defaultdict

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from pamnet_tpu_torch import profiling
from pamnet_tpu_torch.data import batch as tbatch
from pamnet_tpu_torch.data import native
from pamnet_tpu_torch.data.loader import GraphLoader
from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule, synthetic_pdbbind_dataset,
                                             synthetic_qm9_dataset, synthetic_rna_dataset)


def _random(seed, rows=5000, valid=4100, groups=900):
    """Random ids over every group but a tenth (empty groups), zeros in the
    padded rows as collation pads them."""
    rng = np.random.default_rng(seed)
    used = rng.choice(groups, size=groups - groups // 10, replace=False)
    ids = np.zeros(rows, np.int32)
    ids[:valid] = rng.choice(used, size=valid)
    return ids, valid, groups, rows


def _ladder():
    """Ladder pads: rows and groups past the valid ones, the padded rows
    holding ids out of range that must be left alone."""
    ids = np.full(384, 7000, np.int32)
    ids[:200] = np.random.default_rng(5).integers(0, 130, size=200)
    return ids, 200, 256, 384


def _unsorted():
    ids = np.sort(np.random.default_rng(6).integers(0, 40, size=300)).astype(np.int32)
    ids[150], ids[151] = 30, 2
    return ids, 300, 40, 300


def _out_of_range(bad):
    ids = np.random.default_rng(7).integers(0, 50, size=256).astype(np.int32)
    ids[100] = bad
    return ids, 256, 50, 256


# name: (ids, num_valid, num_groups, total_rows), what numpy gives.
CASES = {
    "random_empty_groups": (lambda: _random(0), "sorts"),
    "random_many_rows_few_groups": (lambda: _random(1, 20000, 19000, 3), "sorts"),
    "single_group": (lambda: (np.zeros(700, np.int32), 650, 1, 700), "sorts"),
    "no_valid_rows": (lambda: (np.full(128, 3, np.int32), 0, 16, 128), "sorts"),
    "every_row_valid": (lambda: _random(2, 4096, 4096, 333), "sorts"),
    "ladder_padded": (_ladder, "sorts"),
    "unsorted": (_unsorted, "unsorted"),
    "id_too_large": (lambda: _out_of_range(50), "out of range"),
    "id_negative": (lambda: _out_of_range(-1), "out of range"),
}


def _same(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_csr_arrays_are_numpys_bit_for_bit(case):
    make, expect = CASES[case]
    ids, valid, groups, rows = make()
    kept = ids.copy()
    if expect == "out of range":
        with pytest.raises(ValueError, match="group id out of range"):
            tbatch.build_perm_np(ids, valid, groups, rows)
        with pytest.raises(ValueError, match="group id out of range"):
            native.csr_perm(ids, valid, groups, rows)
    else:
        for got, want in zip(native.csr_perm(ids, valid, groups, rows),
                             tbatch.build_perm_np(ids, valid, groups, rows)):
            _same(got, want)
    # Offsets of the rows as they come, and of the valid rows sorted (ids out
    # of range included: counted as numpy's searchsorted counts them).
    by_id = np.concatenate([np.sort(ids[:valid]), ids[valid:]])
    for x in (ids, by_id):
        _same(native.csr_offsets(x, valid, groups), tbatch._offsets(x, valid, groups))
    if expect == "unsorted":
        assert native.csr_offsets(ids, valid, groups) is None
    assert native.csr_offsets(by_id, valid, groups) is not None
    assert np.array_equal(ids, kept)  # the input is left as it was


def test_rows_past_the_ids_are_refused():
    ids = np.zeros(10, np.int32)
    with pytest.raises(ValueError):
        native.csr_perm(ids, 11, 4, 11)
    with pytest.raises(ValueError):
        native.csr_perm(ids, 10, 4, 9)
    with pytest.raises(ValueError):
        native.csr_offsets(ids, 11, 4)


def _loader(kind):
    if kind == "rna":  # 60-atom chains
        mols, cut = synthetic_rna_dataset(7, seed=4, n_atoms=60), (2.6, 20.0)
    elif kind == "qm9":
        mols, cut = synthetic_qm9_dataset(11, seed=4), (5.0, 5.0)
    else:
        mols = [pdbbind_molecule(g) for g in synthetic_pdbbind_dataset(7, seed=4)]
        cut = (2.0, 6.0)
    return GraphLoader(mols, kind, *cut, batch_size=3, ladder_pads=True, shuffle=True,
                       seed=2, build_perms=True)


@pytest.mark.parametrize("kind", ["rna", "qm9", "pdbbind"])
def test_a_training_epoch_collates_as_the_numpy_route(kind, monkeypatch):
    loader = _loader(kind)
    order = loader.batches()
    calls = defaultdict(int)

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(native, "csr_perm", counted("perm", native.csr_perm))
    monkeypatch.setattr(native, "csr_offsets", counted("offsets", native.csr_offsets))
    got = [loader.collate(idxs) for idxs in order]
    assert calls["perm"] >= 3 * len(order) and calls["offsets"] >= 3 * len(order)
    monkeypatch.setattr(native, "csr_perm", tbatch.build_perm_np)
    monkeypatch.setattr(native, "csr_offsets", tbatch._offsets)
    for g, idxs in zip(got, order):
        w = tbatch.collate_structures([loader.structs[i] for i in idxs],
                                      loader._batch_pads(idxs), build_perms=True,
                                      num_atom_types=loader._num_atom_types)
        assert g.perms.keys() == w.perms.keys() and g.perms
        for k in w.perms:
            assert g.perms[k].dtype == w.perms[k].dtype and g.perms[k].equal(w.perms[k]), k
        for key in ("eg_src", "eg_dst", "el_dst", "t2_ji", "t1_ji"):
            a, b = getattr(g, key + "_off"), getattr(w, key + "_off")
            assert (a is None) == (b is None), key
            assert a is None or (a.dtype == b.dtype and a.equal(b)), key
        assert g.longest == w.longest and g.valid == w.valid
    assert ("z_perm" in got[0].perms) == (kind != "pdbbind")


def test_the_csr_span_is_inside_each_collation():
    loader = _loader("rna")
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            n = len(list(loader.prefetch()))
        recs = profiling.spans()
    finally:
        profiling.clear()
    collations = {r.id: r for r in recs if r.name == "loader.collate"}
    csr = [r for r in recs if r.name == "collate.csr"]
    assert len(collations) == len(csr) == n > 1
    assert sorted(r.ref for r in csr) == list(range(n))
    for r in csr:
        outer = collations[r.parent]
        assert (r.thread, r.ref) == (outer.thread, outer.ref) == ("pamnet-prefetch", r.ref)
        assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
