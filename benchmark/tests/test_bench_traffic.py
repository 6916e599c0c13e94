"""The traffic generators: the fast copy of the RNA-like generator gives the
program's structures bit for bit, every request body of a seed differs,
and the PDB text reads back as the positions it wrote, rounded."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.gen import qm9 as gen_qm9
from benchmark.gen import rna as gen_rna


@pytest.mark.parametrize("n_atoms,seed", [(60, 1), (400, 2), (900, 2147483651)])
def test_the_fast_rna_generator_is_the_programs_bit_for_bit(n_atoms, seed):
    from pamnet_tpu_torch.data.synthetic import rna_like_structure

    want = rna_like_structure(np.random.default_rng(seed), n_atoms)
    got = gen_rna.rna_like_structure(np.random.default_rng(seed), n_atoms)
    assert np.array_equal(got["pos"], want["pos"]) and np.array_equal(got["z"], want["z"])


def test_the_qm9_copy_is_the_programs_bit_for_bit():
    from pamnet_tpu_torch.data.synthetic import synthetic_qm9_dataset

    seed = 2147483652 % (1 << 63)
    for a, b in zip(gen_qm9.synthetic_qm9_dataset(20, seed), synthetic_qm9_dataset(20, seed)):
        assert np.array_equal(a["pos"], b["pos"]) and np.array_equal(a["z"], b["z"])
        assert np.array_equal(a["edge_index"], b["edge_index"]) and a["y"] == b["y"]


def test_request_bodies_of_a_seed_are_all_distinct_and_keep_the_shape():
    seed = 3000000001
    bases = gen_rna.bases(seed, 3, 120)
    bodies = [gen_rna.pdb_text(gen_rna.derived(bases, seed, k, stream=0)) for k in range(40)]
    warm = [gen_rna.pdb_text(gen_rna.derived(bases, seed, k, stream=1)) for k in range(8)]
    assert len(set(bodies + warm)) == len(bodies + warm)
    for k in (0, 1, 5):
        mol, base = gen_rna.derived(bases, seed, k, stream=0), bases[(k + seed) % 3]
        assert np.array_equal(mol["z"], base["z"])
        # A rigid move and a 0.02 A jitter: pair distances kept to ~0.1 A.
        d = lambda p: np.linalg.norm(p[:, None] - p[None], axis=-1)  # noqa: E731
        assert np.abs(d(mol["pos"]) - d(base["pos"])).max() < 0.2
    again = gen_rna.pdb_text(gen_rna.derived(gen_rna.bases(seed, 3, 120), seed, 7, stream=0))
    assert again == bodies[7]


def test_pdb_text_reads_back_rounded_and_as_the_service_reads_it():
    from pamnet_tpu_torch.serve import pdb_text_to_molecule

    mol = gen_rna.derived(gen_rna.bases(5, 1, 80), 5, 0, stream=0)
    text = gen_rna.pdb_text(mol)
    got = gen_rna.parse_pdb(text)
    assert np.array_equal(got["z"], mol["z"])
    assert np.abs(got["pos"] - mol["pos"]).max() <= 0.0005 + 1e-6
    served = pdb_text_to_molecule(text)
    assert np.array_equal(served["z"], got["z"]) and np.array_equal(served["pos"], got["pos"])


def test_qm9_splits_hold_the_tables_sizes_for_every_seed():
    from benchmark import run

    traffic = run.cell_file("qm9_train")["traffic"]
    one = [len(m["z"]) for m in gen_qm9.molecules(traffic, 1, 400, 10)]
    other = [len(m["z"]) for m in gen_qm9.molecules(traffic, 2147483659, 400, 10)]
    assert sorted(one) == sorted(other) and one != other
    assert abs(np.mean(one) - 18.03) < 0.05 and min(one) >= 6 and max(one) <= 29
