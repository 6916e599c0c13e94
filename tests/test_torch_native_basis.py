"""The host spherical basis of the native library (``batch.attach_basis``
over ``native.sbf_radial`` / ``native.cbf``) against its numpy reference
``batch.attach_basis_np``, value for value as int32 bit patterns.

One table is held to 1 float32 ulp, not to its bits: the ``sbf_radial``
of the QM9 cases.  numpy sums j_l's closed form ``powers @ S[l]`` through
BLAS's gemv, which adds the products in lanes with fused multiply-adds, in
an order that also depends on the row's place in the array; the library
adds them left to right.  At QM9's short bonds under its 5 A cutoff the
arguments of j_5 and j_6 are small, the closed form's terms cancel, and the
two sums' last f64 bits differ by enough to move a float32 rounding now and
then: 2 of the 200 molecules' 299,544 radial values here, by one ulp each.
Every other table of every case, the QM9 cases' ``cbf2`` and ``cbf1``
included, is equal bit for bit.
"""

from torch_threads import limit_intra_op_threads

limit_intra_op_threads()

import threading

import numpy as np
import pytest

from pamnet_tpu_torch.data import native
from pamnet_tpu_torch.data.batch import attach_basis, attach_basis_np, precompute_structure
from pamnet_tpu_torch.data.synthetic import (pdbbind_molecule, rna_like_structure,
                                             synthetic_pdbbind_complex_dataset,
                                             synthetic_qm9_dataset)
from pamnet_tpu_torch.ops.bessel import bessel_basis_tables

TABLES = ("sbf_radial", "cbf2", "cbf1")


def _bonded(pos, bonds) -> dict:
    """A QM9-kind molecule with the given positions and (undirected) bonds."""
    b = np.array(bonds, np.int64).reshape(-1, 2).T
    return dict(pos=np.array(pos, np.float32), z=np.zeros(len(pos), np.int32), y=0.0,
                edge_index=np.concatenate([b, b[::-1]], axis=1))


def _rna():
    mol = rna_like_structure(np.random.default_rng(2100), 2100)
    return [precompute_structure(mol, "rna", 2.6, 20.0)], 2.6


def _qm9(variant="full"):
    return [precompute_structure(m, "qm9", 5.0, 5.0, variant)
            for m in synthetic_qm9_dataset(200, seed=3)], 5.0


def _pdbbind():
    g = synthetic_pdbbind_complex_dataset(1, seed=805)[0]
    return [precompute_structure(pdbbind_molecule(g), "pdbbind", 2.0, 6.0)], 2.0


def _no_local_edges():
    # Atoms 3 A apart: global edges within 6 A, no local edge within 2 A.
    mol = dict(pos=np.array([[0, 0, 0], [3, 0, 0], [0, 3, 0]], np.float32),
               feat=np.zeros((3, 18), np.float32), y=0.0)
    return [precompute_structure(mol, "pdbbind", 2.0, 6.0)], 2.0


def _coincident():
    # Atoms 0 and 1 at one place: x = 0, every argument of j_l clamped to
    # 1e-12, the envelope 1e12.
    mol = _bonded([[0, 0, 0], [0, 0, 0], [1.1, 0, 0], [0, 1.3, 0]], [(0, 1), (0, 2), (1, 3)])
    return [precompute_structure(mol, "qm9", 5.0, 5.0)], 5.0


def _at_cutoff():
    # Bond 0-1 exactly 2.5 A long at cutoff_l 2.5: x = 1, the envelope 0.
    mol = _bonded([[0, 0, 0], [2.5, 0, 0], [0, 1.5, 0], [2.5, 1.0, 0]],
                  [(0, 1), (0, 2), (1, 3)])
    return [precompute_structure(mol, "qm9", 2.5, 2.5)], 2.5


CASES = {
    "rna": _rna,
    "qm9": _qm9,
    "qm9_pamnet_s": lambda: _qm9("s"),
    "pdbbind": _pdbbind,
    "no_local_edges": _no_local_edges,
    "coincident_atoms": _coincident,
    "edge_at_cutoff": _at_cutoff,
}
# (case, table) pairs held to 1 float32 ulp (module docstring).
ONE_ULP = {("qm9", "sbf_radial"), ("qm9_pamnet_s", "sbf_radial")}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32).astype(np.int64)


@pytest.mark.parametrize("case", list(CASES))
def test_native_basis_matches_numpy(case):
    structs, cutoff_l = CASES[case]()
    for s in structs:
        want = attach_basis_np(dict(s), cutoff_l)
        got = attach_basis(dict(s), cutoff_l)
        for key in TABLES:
            assert got[key].dtype == np.float32 and got[key].shape == want[key].shape, key
            if (case, key) in ONE_ULP:
                assert np.abs(_bits(got[key]) - _bits(want[key])).max(initial=0) <= 1, key
            else:
                np.testing.assert_array_equal(got[key].view(np.int32), want[key].view(np.int32),
                                              err_msg=key)
    if case == "no_local_edges":
        assert got["sbf_radial"].shape == (0, 42) and got["cbf1"].shape == (0, 7)
        assert got["cbf2"].shape == (0, 7)
    if case == "qm9_pamnet_s":
        assert all(s["t2"]["idx_ji"].size == 0 for s in structs)
    if case == "coincident_atoms":
        assert got["sbf_radial"][0, 0] > 1e12  # the clamp's envelope
    if case == "edge_at_cutoff":
        assert not got["sbf_radial"][0].any()  # edge 1 -> 0 ends at x = 1


def test_native_basis_threads_give_the_single_threaded_tables():
    """Four threads at once on one structure, as the scoring service's
    handlers build: each gets the tables of one call alone."""
    (s,), cutoff_l = _rna()
    want = attach_basis(dict(s), cutoff_l)
    got, errors = [None] * 4, []

    def run(k):
        try:
            got[k] = attach_basis(dict(s), cutoff_l)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    for g in got:
        for key in TABLES:
            np.testing.assert_array_equal(g[key].view(np.int32), want[key].view(np.int32))


def test_native_basis_refuses_bad_input():
    """Indices outside the positions, index arrays of unequal lengths and a
    negative envelope exponent raise before the library reads memory."""
    (s,), cutoff_l = _coincident()
    pos, tables = s["pos"].astype(np.float64), bessel_basis_tables(7, 6)
    ia, ib, ic = (s["t1"][k] for k in ("idx_i", "idx_j1", "idx_j2"))
    with pytest.raises(IndexError):
        native.sbf_radial(pos[:2], s["el"], cutoff_l, 5, tables)
    with pytest.raises(IndexError):
        native.cbf(pos[:2], ia, ib, ic, tables["sph_pref"])
    with pytest.raises(ValueError):
        native.cbf(pos, ia, ib, ic[:-1], tables["sph_pref"])
    with pytest.raises(ValueError):
        native.sbf_radial(pos, s["el"], cutoff_l, -1, tables)
