"""Synthetic data for runs without the datasets' files.

QM9-like molecules (the port's copy of ``pamnet_tpu/data/synthetic.py``): the
same ``np.random.Generator`` draws in the same order, so one seed gives the
same molecules bit for bit in both packages: bonded trees with 1.1-1.54 A
bonds, 9-29 atoms, a QM9-like H/C/N/O/F mix and a label loosely tied to the
composition.

PDBbind-like protein-ligand complexes (the port's copy of the same
module's ``synthetic_pdbbind_*``, same draws in the same order): the
reference's three-subgraph layout [complex | pocket + 100 A | ligand +
200 A] with 18 float features per atom, small (12-22 pocket atoms, for
tests) or at realistic scale (150-300 pocket atoms, 20-50 ligand atoms).

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


def synthetic_pdbbind_graph(rng: np.random.Generator) -> dict:
    """One small protein-ligand graph in TU-writer form (``attrs`` (N, 3)
    positions, ``labels`` (N, 18) features, ``y``), the complex then the
    pocket shifted by 100 A and the ligand by 200 A in x
    (preprocess_pdbbind.py:33-43), labelled by the pocket-ligand contact
    term ``sum exp(-d_pl) + N(0, 0.1)``, which the signed pool isolates."""
    n_p = int(rng.integers(12, 22))
    n_l = int(rng.integers(5, 10))
    pocket = (rng.random((n_p, 3)) * 6.0).astype(np.float32)
    ligand = (pocket[:n_l] + rng.normal(0, 1.5, (n_l, 3))).astype(np.float32)
    d = np.linalg.norm(pocket[:, None, :] - ligand[None, :, :], axis=-1)
    y = float(np.exp(-d).sum() + rng.normal(0, 0.1))
    complex_pos = np.concatenate([pocket, ligand])
    pos = np.concatenate([
        complex_pos,
        pocket + np.float32([100.0, 0, 0]),
        ligand + np.float32([200.0, 0, 0]),
    ]).astype(np.float32)
    feats_c = rng.random((n_p + n_l, 18)).astype(np.float32)
    feats = np.concatenate([feats_c, feats_c[:n_p], feats_c[n_p:]])
    return dict(attrs=pos, labels=feats, y=y)


def synthetic_pdbbind_dataset(n_graphs: int, seed: int = 805) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [synthetic_pdbbind_graph(rng) for _ in range(n_graphs)]


def synthetic_pdbbind_complex(rng: np.random.Generator,
                              n_pocket: tuple[int, int] = (150, 300),
                              n_ligand: tuple[int, int] = (20, 50)) -> dict:
    """One complex at the scale of preprocessed PDBbind graphs: a 20-50
    atom ligand (a self-avoiding walk of 1.3-1.6 A steps) and up to 150-300
    pocket atoms on a jittered 2.6 A lattice in the 2-6 A shell around it
    (heavy-atom packing, 40-80 neighbours within 6 A; the shell's lattice
    points cap the pocket), in the three-subgraph layout of
    ``synthetic_pdbbind_graph``: 260-420 atoms in all at seed 805.  The label
    is the contact term over the pocket size plus N(0, 0.1), O(1-10) like
    -log Kd."""
    npk = int(rng.integers(*n_pocket))
    nlg = int(rng.integers(*n_ligand))
    lig = np.zeros((nlg, 3), dtype=np.float32)
    for i in range(1, nlg):
        p = int(rng.integers(0, i))
        for _ in range(20):
            d = rng.standard_normal(3)
            d /= np.linalg.norm(d) + 1e-12
            cand = lig[p] + d * rng.uniform(1.3, 1.6)
            if np.min(np.linalg.norm(lig[:i] - cand, axis=1)) > 1.1:
                break
        lig[i] = cand
    lo = lig.min(0) - 6.0
    hi = lig.max(0) + 6.0
    axes = [np.arange(lo[d], hi[d], 2.6) for d in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    cand = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    cand = cand + rng.uniform(-0.5, 0.5, cand.shape)
    d2lig = np.linalg.norm(cand[:, None, :] - lig[None, :, :], axis=-1).min(1)
    cand = cand[(d2lig > 2.0) & (d2lig < 6.0)].astype(np.float32)
    rng.shuffle(cand, axis=0)
    pocket = cand[:npk]
    npk = pocket.shape[0]
    d = np.linalg.norm(pocket[:, None, :] - lig[None, :, :], axis=-1)
    y = float(np.exp(-d).sum() / max(npk, 1) + rng.normal(0, 0.1))
    complex_pos = np.concatenate([pocket, lig])
    pos = np.concatenate([
        complex_pos,
        pocket + np.float32([100.0, 0, 0]),
        lig + np.float32([200.0, 0, 0]),
    ]).astype(np.float32)
    feats_c = rng.random((npk + nlg, 18)).astype(np.float32)
    feats = np.concatenate([feats_c, feats_c[:npk], feats_c[npk:]])
    return dict(attrs=pos, labels=feats, y=y)


def synthetic_pdbbind_complex_dataset(n_graphs: int, seed: int = 805) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [synthetic_pdbbind_complex(rng) for _ in range(n_graphs)]


def pdbbind_molecule(graph: dict) -> dict:
    """A TU-writer-form graph as the molecule dict the loaders read: ``pos``,
    ``feat`` and ``y``."""
    return dict(pos=np.asarray(graph["attrs"], np.float32),
                feat=np.asarray(graph["labels"], np.float32), y=float(graph["y"]))


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
