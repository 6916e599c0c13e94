"""Offline PDBbind preprocessing on the port (JAX counterpart: the
repository's ``preprocess_pdbbind.py``; reference: preprocess_pdbbind.py):
ligand/pocket mol2 pairs -> TU-format three-subgraph complexes, byte for
byte the files the JAX preprocessor writes.

    python -m pamnet_tpu_torch.preprocess_pdbbind [--data_dir ./data/PDBbind]

Reads ``<data_dir>/refined-set/<id>/<id>_{ligand,pocket}.mol2``, the same
under ``core-set/``, and the -logKd/Ki labels of
``refined-set/index/INDEX_refined_data.2016``; writes the core set as the
``test`` split and the refined set minus the core set as ``train_val``
under ``<data_dir>`` (``python -m pamnet_tpu_torch.main_pdbbind --data_root``
reads them).  Per complex (reference line refs in parens):
  1. parse and featurize the ligand and pocket mol2 (``data/mol2.py``,
     ``data/featurizer.py``: 18 features a heavy atom; :86-90),
  2. truncate the pocket at the first water substructure, as the
     reference's mol2 heavy-atom count does (:20-31,92-94),
  3. keep the pocket atoms within 6 A of any ligand atom (:14-18,102-111),
  4. drop one of each pair of pocket atoms closer than 0.5 A (:116-124),
  5. lay out [complex | pocket +100 A in x | ligand +200 A in x], so one
     forward evaluates E(complex) - E(pocket) - E(ligand) through the
     model's x > 40 sign mask (:33-43,126-139),
  6. write the TU files, graph labels to two decimals (:141-158,161-188).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pamnet_tpu_torch.data.featurizer import featurize_mol2
from pamnet_tpu_torch.data.mol2 import parse_mol2
from pamnet_tpu_torch.data.tu import write_tu_split


def pocket_heavy_atom_count(mol) -> int:
    """Heavy atoms before the first water substructure (the reference
    counts non-H atoms until a 'HOH' residue appears, :20-31)."""
    n = 0
    for z, subst in zip(mol.atomic_num, mol.subst):
        if subst.startswith("HOH"):
            break
        n += int(z != 1)
    return n


def build_complex(ligand_path: str, pocket_path: str, cutoff: float = 6.0):
    """(positions (N, 3) float32, features (N, 18) float32) of one complex
    in the three-subgraph layout."""
    ligand = parse_mol2(ligand_path)
    pocket = parse_mol2(pocket_path)

    ligand_pos, ligand_feat = featurize_mol2(ligand)
    pocket_pos, pocket_feat = featurize_mol2(pocket)

    node_num = pocket_heavy_atom_count(pocket)
    pocket_pos = pocket_pos[:node_num]
    pocket_feat = pocket_feat[:node_num]

    assert (ligand_feat[:, 12] != 0).any(), "ligand charges all zero"
    assert (ligand_feat[:, :9].sum(1) != 0).all(), "unencoded ligand atom type"

    # Interaction filter: pocket atoms within cutoff of any ligand atom.
    d = np.linalg.norm(pocket_pos[:, None, :] - ligand_pos[None, :, :], axis=-1)
    keep = np.unique(np.nonzero(d < cutoff)[0])
    pocket_pos, pocket_feat = pocket_pos[keep], pocket_feat[keep]

    # Near-duplicate removal: of each pair closer than 0.5 A the first goes
    # (the reference deletes the first half of the symmetric radius pairs).
    if len(pocket_pos):
        dd = np.linalg.norm(pocket_pos[:, None, :] - pocket_pos[None, :, :], axis=-1)
        a, b = np.nonzero((dd <= 0.5) & ~np.eye(len(pocket_pos), dtype=bool))
        drop = set(a[a < b].tolist())
        if drop:
            keep2 = [i for i in range(len(pocket_pos)) if i not in drop]
            pocket_pos, pocket_feat = pocket_pos[keep2], pocket_feat[keep2]

    complex_pos = np.concatenate([pocket_pos, ligand_pos])
    complex_feat = np.concatenate([pocket_feat, ligand_feat])
    shift = np.float32([complex_pos[:, 0].mean(), 0.0, 0.0])
    final_pos = np.concatenate([
        complex_pos - shift,
        pocket_pos - shift + np.float32([100.0, 0, 0]),
        ligand_pos - shift + np.float32([200.0, 0, 0]),
    ])
    final_feat = np.concatenate([complex_feat, pocket_feat, ligand_feat])
    return final_pos, final_feat


def read_index_labels(index_file: str) -> dict[str, float]:
    """-logKd/Ki labels from INDEX_refined_data.2016 (reference: :163-181)."""
    labels = {}
    with open(index_file) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            labels[parts[0]] = float(parts[3])
    return labels


def construct_graphs(data_dir, save_dir, data_name, save_name, label_dict,
                     cutoff=6.0, exclude_data_name=None) -> list[dict]:
    """Preprocess the complexes of ``<data_dir>/<data_name>`` that have a
    label (less those of ``exclude_data_name``), in sorted order, and write
    them as split ``save_name`` under ``save_dir``.  Returns their molecule
    dicts (``pos``, ``feat``, ``y``)."""
    print("Preprocessing", data_name)
    exclude = set()
    if exclude_data_name:
        exclude = {d for d in os.listdir(os.path.join(data_dir, exclude_data_name))
                   if d not in ("index", "readme")}
    data_dir_full = os.path.join(data_dir, data_name)
    names = [d for d in sorted(os.listdir(data_dir_full))
             if d not in ("index", "readme") and d not in exclude]
    mols = []
    for name in names:
        if name not in label_dict:
            continue
        pos, feat = build_complex(
            os.path.join(data_dir_full, name, f"{name}_ligand.mol2"),
            os.path.join(data_dir_full, name, f"{name}_pocket.mol2"),
            cutoff,
        )
        mols.append(dict(pos=pos, feat=feat, y=label_dict[name]))
    write_tu_split(save_dir, save_name, mols, label_fmt="%.2f")
    print(f"wrote {len(mols)} graphs to {save_dir}/{save_name}/raw")
    return mols


def main(argv=None) -> dict[str, list[dict]]:
    """Preprocess ``--data_dir``; returns the molecules of each split."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_dir", default=os.path.join(".", "data", "PDBbind"))
    args = parser.parse_args(argv)
    data_dir = args.data_dir
    label_dict = read_index_labels(
        os.path.join(data_dir, "refined-set", "index", "INDEX_refined_data.2016"))
    return {
        "test": construct_graphs(data_dir, data_dir, "core-set", "test", label_dict, 6.0),
        "train_val": construct_graphs(data_dir, data_dir, "refined-set", "train_val",
                                      label_dict, 6.0, exclude_data_name="core-set"),
    }


if __name__ == "__main__":
    main()
