"""Offline RNA-Puzzles preprocessing on the port (JAX counterpart: the
repository's ``preprocess_rna_puzzles.py``; reference:
preprocess_rna_puzzles.py): candidate-structure PDB files -> TU-format
graph files, byte for byte the files the JAX preprocessor writes.

    python -m pamnet_tpu_torch.preprocess_rna_puzzles \\
        [--data_dir ./data/RNA-Puzzles/classics_train_val] [--save_dir ./data/RNA-Puzzles]

Per structure of ``<data_dir>/example_train`` and ``example_val``, in
sorted order: the atoms (``data/pdb.py``), of which C/N/O are kept as
labels 0/1/2 (reference :72-82), and the RMSD label of the ``rms`` line
after the first TER record (:33-42); written as the splits ``train`` and
``val`` under ``<save_dir>`` with the file names in ``graph_names``
(``python -m pamnet_tpu_torch.main_rna_puzzles --data_root`` reads them).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pamnet_tpu_torch.data.pdb import parse_pdb_atoms, parse_rms_label
from pamnet_tpu_torch.data.tu import write_tu_split

TYPES = {"C": 0, "N": 1, "O": 2}


def construct_graphs(data_dir: str, save_dir: str, data_name: str,
                     save_name: str) -> list[dict]:
    """Preprocess every file of ``<data_dir>/<data_name>`` and write split
    ``save_name`` under ``save_dir``.  Returns the molecule dicts (``pos``,
    ``z``, ``y``, ``name``)."""
    print("Preprocessing", data_name)
    data_dir_full = os.path.join(data_dir, data_name)
    mols = []
    for name in sorted(os.listdir(data_dir_full)):
        path = os.path.join(data_dir_full, name)
        elems, coords = parse_pdb_atoms(path)
        label = parse_rms_label(path)
        keep = [i for i, e in enumerate(elems) if e in TYPES]
        mols.append(dict(pos=coords[keep].astype(np.float32),
                         z=np.array([TYPES[elems[i]] for i in keep], dtype=np.int64),
                         y=label, name=name))
    write_tu_split(save_dir, save_name, mols)
    print(f"wrote {len(mols)} graphs to {save_dir}/{save_name}/raw")
    return mols


def main(argv=None) -> dict[str, list[dict]]:
    """Preprocess both splits; returns the molecules of each."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_dir",
                        default=os.path.join(".", "data", "RNA-Puzzles", "classics_train_val"))
    parser.add_argument("--save_dir", default=os.path.join(".", "data", "RNA-Puzzles"))
    args = parser.parse_args(argv)
    return {"train": construct_graphs(args.data_dir, args.save_dir, "example_train", "train"),
            "val": construct_graphs(args.data_dir, args.save_dir, "example_val", "val")}


if __name__ == "__main__":
    main()
