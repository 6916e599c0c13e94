"""Reader and writer for the flat-text TU graph format of the RNA-Puzzles
pipeline (reference: datasets/tu_dataset.py:104-163; the port's copy of
``pamnet_tpu/data/tu.py`` and ``pamnet_tpu/data/tu_writer.py``, numpy only).

Files per dataset ``<root>/<name>/raw/<name>_*.txt``:
  * ``graph_indicator``: 1-based graph id per node,
  * ``node_attributes``: float columns (positions [+ features]),
  * ``node_labels``: int per node (RNA) or float feature rows (PDBbind),
  * ``graph_labels``: float per graph,
  * ``graph_names``: (RNA only) source file name per graph.

Like the reference loader, ``x = concat([node_attributes, node_labels])`` so
positions occupy x[:, :3] (tu_dataset.py:111-115); that is split into the
explicit ``pos``/``feat``/``z`` fields the models consume.
"""

from __future__ import annotations

import os

import numpy as np


def _path(root: str, name: str, suffix: str) -> str:
    return os.path.join(root, name, "raw", f"{name}_{suffix}.txt")


def has_tu_split(root: str, name: str) -> bool:
    """Whether ``root`` holds the TU files of split ``name``."""
    return os.path.isfile(_path(root, name, "graph_indicator"))


class TUDataset:
    """List-of-molecule-dicts view of a TU-format dataset.

    Each element is a dict with keys ``pos`` (n,3), ``y`` (scalar), and
    ``z`` (n,) int node labels and/or ``feat`` (n,F) extra float columns.
    """

    def __init__(self, root: str, name: str):
        self.root = root
        self.name = name

        def path(suffix):
            return _path(root, name, suffix)

        indicator = np.loadtxt(path("graph_indicator"), dtype=np.int64, delimiter=",")
        indicator -= 1
        self.num_graphs = int(indicator.max()) + 1

        attrs = None
        if os.path.exists(path("node_attributes")):
            attrs = np.loadtxt(path("node_attributes"), dtype=np.float32, delimiter=",")
            if attrs.ndim == 1:
                attrs = attrs[:, None]
        labels = None
        if os.path.exists(path("node_labels")):
            labels = np.loadtxt(path("node_labels"), dtype=np.float32, delimiter=",")
            if labels.ndim == 1:
                labels = labels[:, None]
        y = np.loadtxt(path("graph_labels"), dtype=np.float32, delimiter=",").reshape(-1)

        self.names = None
        if os.path.exists(path("graph_names")):
            with open(path("graph_names")) as f:
                self.names = [line.strip() for line in f if line.strip()]

        # x = [attributes | labels]; pos = x[:, :3] (reference: models.py:120,141)
        x = np.concatenate([c for c in (attrs, labels) if c is not None], axis=1)
        self._splits = np.searchsorted(
            indicator, np.arange(1, self.num_graphs), side="left"
        )
        self._x = x
        self._y = y

    def __len__(self) -> int:
        return self.num_graphs

    def __getitem__(self, i: int) -> dict:
        xs = np.split(self._x, self._splits)[i]
        mol = {
            "pos": xs[:, :3].astype(np.float32),
            # Last column is the node label / atom type (reference: models.py:140
            # indexes embeddings with x[:, -1]).
            "z": xs[:, -1].astype(np.int32),
            "y": float(self._y[i]),
        }
        if xs.shape[1] > 4:
            # PDBbind layout: [pos(3) | 18 features]; the featurizer's last
            # column doubles as the "node label" the loader concatenated.
            mol["feat"] = xs[:, 3:].astype(np.float32)
        return mol

    def molecules(self) -> list[dict]:
        return [self[i] for i in range(len(self))]


def write_tu_split(root: str, name: str, mols: list[dict],
                   label_fmt: str = "%.3f") -> str:
    """Write molecule dicts (``pos`` (n,3), ``y``, and ``z`` (n,) int or, for
    PDBbind, ``feat`` (n,F) float; an optional ``name``, the structure's
    source file) as the TU files of split ``name``, byte for byte as the JAX
    package's ``tu_writer.write_tu_dataset`` writes them: coordinates to
    three decimals (preprocess_rna_puzzles.py:87-107), feature rows as the
    node labels to four (preprocess_pdbbind.py:141-158), so the reader gives
    ``feat`` = [pos | features][:, 3:] back; graph labels in ``label_fmt``
    (the PDBbind preprocessor's ``%.2f``, else three decimals); the names,
    where every molecule has one, a line each in ``graph_names``.  Returns
    the raw directory."""
    os.makedirs(os.path.join(root, name, "raw"), exist_ok=True)
    sizes = [len(m["pos"]) for m in mols]
    indicator = np.concatenate([np.full(k, i + 1) for i, k in enumerate(sizes)])
    np.savetxt(_path(root, name, "graph_indicator"), indicator, fmt="%d")
    np.savetxt(_path(root, name, "node_attributes"),
               np.concatenate([np.asarray(m["pos"], np.float64) for m in mols]),
               fmt="%.3f", delimiter=", ")
    if all("feat" in m for m in mols):
        np.savetxt(_path(root, name, "node_labels"),
                   np.concatenate([np.asarray(m["feat"], np.float64) for m in mols]),
                   fmt="%.4f", delimiter=", ")
    else:
        np.savetxt(_path(root, name, "node_labels"),
                   np.concatenate([np.asarray(m["z"]) for m in mols]), fmt="%d")
    np.savetxt(_path(root, name, "graph_labels"),
               np.asarray([float(m["y"]) for m in mols]), fmt=label_fmt)
    if mols and all("name" in m for m in mols):
        with open(_path(root, name, "graph_names"), "w") as f:
            f.write("".join(f"{m['name']}\n" for m in mols))
    return os.path.join(root, name, "raw")
