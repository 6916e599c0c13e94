"""Synthetic data for runs without the datasets' files.

QM9-like molecules (the port's copy of ``pamnet_tpu/data/synthetic.py``): the
same ``np.random.Generator`` draws in the same order, so one seed gives the
same molecules bit for bit in both packages: bonded trees with 1.1-1.54 A
bonds, 9-29 atoms, a QM9-like H/C/N/O/F mix and a label loosely tied to the
composition.

RNA-like structures: compact folded chains of C/N/O atoms at heavy-atom
density, at any size up to that of RNA-Puzzles candidates (about 2,100
atoms), with a label loosely tied to the composition.
"""

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


def rna_like_structure(rng: np.random.Generator, n_atoms: int) -> dict:
    """A compact folded chain of C/N/O atoms: 1.5 A steps at a 115 degree
    bond angle with random torsions, kept inside a sphere at heavy-atom
    density (0.05 per A^3), no atom closer than 2.1 A to any but its two
    chain predecessors.  ``y`` is 0; ``synthetic_rna_dataset`` labels."""
    radius = (3.0 * n_atoms / (4.0 * np.pi * 0.05)) ** (1.0 / 3.0)
    step, cos_a = 1.5, np.cos(np.deg2rad(180.0 - 115.0))
    pos = np.zeros((n_atoms, 3))
    pos[1] = pos[0] + [step, 0.0, 0.0]
    for i in range(2, n_atoms):
        u = pos[i - 1] - pos[i - 2]
        u /= np.linalg.norm(u)
        # Candidate directions at the bond angle to the previous bond.
        ref = np.array([0.0, 0.0, 1.0]) if abs(u[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        v = np.cross(u, ref)
        v /= np.linalg.norm(v)
        w = np.cross(u, v)
        tors = rng.uniform(0.0, 2.0 * np.pi, 16)
        sin_a = np.sqrt(1.0 - cos_a**2)
        dirs = (cos_a * u[None] + sin_a * (np.cos(tors)[:, None] * v[None]
                                           + np.sin(tors)[:, None] * w[None]))
        cand = pos[i - 1] + step * dirs
        r = np.linalg.norm(cand, axis=1)
        if i > 2:
            d = np.sqrt(((cand[:, None] - pos[None, : i - 2]) ** 2).sum(-1).min(1))
        else:
            d = np.full(len(cand), np.inf)
        free = d >= 2.1
        if (free & (r <= radius)).any():
            pick = np.argmax(free & (r <= radius))
        elif free.any():  # outside the sphere: step back towards the centre
            pick = np.argmin(np.where(free, r, np.inf))
        else:  # crowded: the least crowded candidate
            pick = np.argmax(d)
        pos[i] = cand[pick]
    z = rng.choice(3, size=n_atoms, p=[0.45, 0.35, 0.20]).astype(np.int32)
    return dict(z=z, pos=pos.astype(np.float32), y=0.0)


def synthetic_rna_dataset(n_structures: int, seed: int = 40,
                          n_atoms: int = 2100) -> list[dict]:
    """``n_structures`` RNA-like structures of ``n_atoms`` atoms with an
    RMSD-like label ``y = 20 * (share of N atoms) + |N(0, 1)|``.  The labels
    are drawn after every structure, so the structures are those of
    ``rna_like_structure`` called ``n_structures`` times on
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    mols = [rna_like_structure(rng, n_atoms) for _ in range(n_structures)]
    noise = np.abs(rng.standard_normal(n_structures))
    for m, e in zip(mols, noise):
        m["y"] = float(20.0 * np.mean(m["z"] == 1) + e)
    return mols
