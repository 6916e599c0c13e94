"""Synthetic QM9-like molecules, for training runs without the QM9 raw files
(the port's copy of ``pamnet_tpu/data/synthetic.py``).  The same
``np.random.Generator`` draws in the same order, so one seed gives the same
molecules bit for bit in both packages: bonded trees with 1.1-1.54 A bonds,
9-29 atoms, a QM9-like H/C/N/O/F mix and a label loosely tied to the
composition."""

from __future__ import annotations

import numpy as np


def synthetic_qm9_molecule(rng: np.random.Generator, n_atoms: int | None = None) -> dict:
    """One molecule dict with ``z``, ``pos``, bond ``edge_index`` (both
    directions) and a float ``y``."""
    if n_atoms is None:
        n_atoms = int(rng.integers(9, 30))
    # Grow a random tree: each new atom bonds to a random earlier atom at
    # 1.1-1.54 A in a random direction, rejecting overlaps (20 tries).
    pos = np.zeros((n_atoms, 3), dtype=np.float32)
    parent = np.zeros(n_atoms, dtype=np.int64)
    for i in range(1, n_atoms):
        p = int(rng.integers(0, i))
        for _ in range(20):
            d = rng.standard_normal(3)
            d /= np.linalg.norm(d) + 1e-12
            cand = pos[p] + d * rng.uniform(1.1, 1.54)
            if np.min(np.linalg.norm(pos[:i] - cand, axis=1)) > 0.95:
                break
        pos[i] = cand
        parent[i] = p
    src = np.concatenate([np.arange(1, n_atoms), parent[1:]])
    dst = np.concatenate([parent[1:], np.arange(1, n_atoms)])
    z = rng.choice(5, size=n_atoms, p=[0.51, 0.35, 0.06, 0.07, 0.01])
    y = float((z == 1).sum() * -10.0 + (z == 2).sum() * -15.0 + rng.normal(0, 0.1))
    return dict(
        z=z.astype(np.int32),
        pos=pos,
        edge_index=np.stack([src, dst]).astype(np.int64),
        y=y,
    )


def synthetic_qm9_dataset(n_molecules: int, seed: int = 480) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [synthetic_qm9_molecule(rng) for _ in range(n_molecules)]
