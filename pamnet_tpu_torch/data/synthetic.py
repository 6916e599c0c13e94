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

Raw dataset trees, fixtures for runs without the datasets' files (only the
tests and ``chip_smoke.py`` call them): ``write_raw_pdbbind`` writes
PDBbind's layout of ligand and pocket mol2 files and its index of labels,
``write_raw_rna_puzzles`` RNA-Puzzles candidate PDB files, each for the
port's preprocessors to read as they read the real files.
"""

from __future__ import annotations

import os

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


# ---- raw-file fixtures: PDBbind mol2 trees and RNA-Puzzles PDB files ----

# SYBYL types of the fixtures' heavy atoms: (type, element, valence, whether
# it takes further heavy neighbours).  Ligand chains draw from a drug-like
# mix of them, pocket side chains from a protein-like one.
_SYBYL = {
    "C.3": ("C", 4, True), "C.2": ("C", 3, True), "C.ar": ("C", 3, True),
    "N.am": ("N", 3, True), "N.ar": ("N", 2, True), "N.3": ("N", 3, True),
    "N.4": ("N", 4, False), "O.2": ("O", 2, False), "O.3": ("O", 2, True),
    "O.co2": ("O", 1, False), "S.3": ("S", 2, True), "F": ("F", 1, False),
    "Cl": ("Cl", 1, False),
}
_LIGAND_MIX = (("C.3", 0.34), ("C.2", 0.14), ("N.am", 0.08), ("N.3", 0.06),
               ("N.4", 0.02), ("O.2", 0.11), ("O.3", 0.10), ("O.co2", 0.04),
               ("S.3", 0.03), ("F", 0.04), ("Cl", 0.04))
_POCKET_MIX = (("C.3", 0.46), ("C.2", 0.12), ("N.am", 0.10), ("N.3", 0.03),
               ("N.4", 0.03), ("O.2", 0.12), ("O.3", 0.07), ("O.co2", 0.05),
               ("S.3", 0.02))
_RESIDUES = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
             "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL")
_BOND_ORDER_VALUE = {"1": 1.0, "2": 2.0, "ar": 1.5, "am": 1.0}


class _Mol2Builder:
    """Atoms (name, position, SYBYL type, residue, charge) and bonds of one
    mol2 file, placed so that no two atoms but bonded ones come closer than
    ``clash`` A (ring closures excepted)."""

    def __init__(self, rng: np.random.Generator, clash: float = 2.2):
        self.rng, self.clash = rng, clash
        self.pos: list[np.ndarray] = []
        self.types: list[str] = []
        self.subst: list[str] = []
        self.charge: list[float] = []
        self.bonds: list[tuple[int, int, str]] = []
        self.nbrs: list[list[int]] = []

    def free(self, p: np.ndarray, ignore=(), also=None) -> bool:
        pts = [q for k, q in enumerate(self.pos) if k not in ignore]
        if also is not None:
            pts += list(also)
        return not pts or np.min(np.linalg.norm(np.asarray(pts) - p, axis=1)) >= self.clash

    def add(self, p, sybyl: str, subst: str, charge: float) -> int:
        self.pos.append(np.asarray(p, np.float64))
        self.types.append(sybyl)
        self.subst.append(subst)
        self.charge.append(charge)
        self.nbrs.append([])
        return len(self.pos) - 1

    def bond(self, a: int, b: int, order: str) -> None:
        self.bonds.append((a, b, order))
        self.nbrs[a].append(b)
        self.nbrs[b].append(a)

    def grow(self, parent: int, sybyl: str, subst: str, charge: float,
             step: float = 1.5, avoid=None, tries: int = 24) -> int | None:
        """A new atom bonded to ``parent`` at ``step`` A in a free direction,
        or None where none of ``tries`` directions is free."""
        for _ in range(tries):
            d = self.rng.standard_normal(3)
            cand = self.pos[parent] + step * d / (np.linalg.norm(d) + 1e-12)
            if self.free(cand, ignore=(parent,), also=avoid):
                return self.add(cand, sybyl, subst, charge)
        return None

    def ring(self, anchor: int, subst: str, charges, avoid=None, n_aza: int = 0):
        """A planar aromatic six-ring bonded to ``anchor`` (``n_aza`` of its
        atoms N.ar), or None where it does not fit."""
        for _ in range(12):
            u = self.rng.standard_normal(3)
            u /= np.linalg.norm(u)
            v = np.cross(u, self.rng.standard_normal(3))
            v /= np.linalg.norm(v)
            centre = self.pos[anchor] + u * (1.5 + 1.39)
            w = np.cross(u, v)
            pts = [centre - 1.39 * (np.cos(a) * u + np.sin(a) * w)
                   for a in np.arange(6) * np.pi / 3]
            if all(self.free(p, ignore=(anchor,), also=avoid) for p in pts):
                kinds = ["C.ar"] * 6
                for k in self.rng.choice(np.arange(2, 6), size=n_aza, replace=False):
                    kinds[int(k)] = "N.ar"
                idx = [self.add(p, kinds[k], subst, float(charges[k]))
                       for k, p in enumerate(pts)]
                self.bond(anchor, idx[0], "1")
                for k in range(6):
                    self.bond(idx[k], idx[(k + 1) % 6], "ar")
                return idx
        return None

    def hydrogens(self, heavy: list[int]) -> None:
        """Explicit hydrogens filling each heavy atom's valence, at 1.0 A."""
        for a in heavy:
            _, valence, _ = _SYBYL[self.types[a]]
            bosum = sum(_BOND_ORDER_VALUE[o] for x, y, o in self.bonds if a in (x, y))
            for _ in range(max(0, int(round(valence - bosum)))):
                d = self.rng.standard_normal(3)
                h = self.add(self.pos[a] + d / (np.linalg.norm(d) + 1e-12), "H",
                             self.subst[a], 0.05)
                self.bond(a, h, "1")

    def write(self, path: str, name: str, kind: str) -> None:
        lines = ["@<TRIPOS>MOLECULE", name,
                 f"{len(self.pos)} {len(self.bonds)} 1 0 0", kind, "USER_CHARGES", "",
                 "@<TRIPOS>ATOM"]
        counts: dict[str, int] = {}
        res_id: dict[str, int] = {}
        for k, (p, t, sub, q) in enumerate(zip(self.pos, self.types, self.subst,
                                               self.charge)):
            elem = t.split(".")[0]
            counts[elem] = counts.get(elem, 0) + 1
            rid = res_id.setdefault(sub, len(res_id) + 1)
            lines.append(f"{k + 1:7d} {elem}{counts[elem]:<6d} {p[0]:10.4f}{p[1]:10.4f}"
                         f"{p[2]:10.4f} {t:<6s}{rid:5d} {sub:<8s}{q:10.4f}")
        lines.append("@<TRIPOS>BOND")
        lines += [f"{k + 1:6d}{a + 1:6d}{b + 1:6d} {o}" for k, (a, b, o) in enumerate(self.bonds)]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


def _draw_type(rng: np.random.Generator, mix) -> str:
    names, p = zip(*mix)
    return names[int(rng.choice(len(names), p=np.asarray(p) / np.sum(p)))]


def _bonded_type(parent_type: str, child_type: str) -> tuple[str, str]:
    """(the child's type, the bond's order): a carbonyl O.2 only on a C.2
    (else an O.3 by a single bond), an amide bond from a C.2 to an N.am."""
    if child_type == "O.2":
        return ("O.2", "2") if parent_type == "C.2" else ("O.3", "1")
    if child_type == "N.am" and parent_type == "C.2":
        return "N.am", "am"
    return child_type, "1"


def _raw_ligand(rng: np.random.Generator) -> _Mol2Builder:
    """A drug-like ligand of 20-50 heavy atoms: an aromatic six-ring (a
    pyridine one time in three) and chains grown from it, with hydrogens
    and non-zero partial charges."""
    lig = _Mol2Builder(rng, clash=2.0)
    n_heavy = int(rng.integers(20, 51))
    charges = np.round(rng.normal(0.0, 0.15, 6), 4)
    anchor = lig.add(np.zeros(3), "C.3", "LIG", float(np.round(rng.normal(0, 0.1), 4)))
    ring = lig.ring(anchor, "LIG", charges, n_aza=int(rng.random() < 1 / 3))
    heavy = [anchor, *ring]
    open_ = [anchor, *ring[1:]]
    while len(heavy) < n_heavy and open_:
        parent = open_[int(rng.integers(len(open_)))]
        ptype = lig.types[parent]
        used = sum(_BOND_ORDER_VALUE[o] for a, b, o in lig.bonds if parent in (a, b))
        child_type, order = _bonded_type(ptype, _draw_type(rng, _LIGAND_MIX))
        if used + _BOND_ORDER_VALUE[order] > _SYBYL[ptype][1]:
            open_.remove(parent)
            continue
        child = lig.grow(parent, child_type, "LIG", float(np.round(rng.normal(0, 0.25), 4)))
        if child is None:
            open_.remove(parent)
            continue
        lig.bond(parent, child, order)
        heavy.append(child)
        if _SYBYL[child_type][2]:
            open_.append(child)
    lig.hydrogens(heavy)
    return lig


def _raw_pocket(rng: np.random.Generator, ligand: _Mol2Builder, n_heavy: int,
                n_waters: int) -> _Mol2Builder:
    """Residue-named protein fragments around the ligand (``n_heavy`` heavy
    atoms: chains of 4-9 atoms started 3.5-7.5 A from the ligand, a sixth of
    them ending in an aromatic ring), their hydrogens, then ``n_waters``
    waters (``HOH``), which the preprocessor's pocket truncation cuts."""
    lig_heavy = np.asarray([p for p, t in zip(ligand.pos, ligand.types) if t != "H"])
    pocket = _Mol2Builder(rng, clash=2.2)
    lo, hi = lig_heavy.min(0) - 7.5, lig_heavy.max(0) + 7.5
    heavy: list[int] = []
    seq = 0
    for _ in range(20 * n_heavy):
        if len(heavy) >= n_heavy:
            break
        start = rng.uniform(lo, hi)
        d = np.linalg.norm(lig_heavy - start, axis=1).min()
        if not 3.5 <= d <= 7.5 or not pocket.free(start, also=lig_heavy):
            continue
        seq += 1
        res = f"{_RESIDUES[int(rng.integers(len(_RESIDUES)))]}{seq}"
        chain = [pocket.add(start, "N.am", res, float(np.round(rng.normal(-0.3, 0.1), 4)))]
        heavy.append(chain[0])
        for k in range(int(rng.integers(3, 9))):
            ptype = pocket.types[chain[-1]]
            child_type, order = _bonded_type(
                ptype, "C.3" if k == 0 else _draw_type(rng, _POCKET_MIX))
            if not _SYBYL[ptype][2]:
                break
            child = pocket.grow(chain[-1], child_type, res,
                                float(np.round(rng.normal(0, 0.2), 4)), avoid=lig_heavy)
            if child is None:
                break
            pocket.bond(chain[-1], child, order)
            chain.append(child)
            heavy.append(child)
        if rng.random() < 1 / 6 and _SYBYL[pocket.types[chain[-1]]][2]:
            ring = pocket.ring(chain[-1], res, np.round(rng.normal(0, 0.1, 6), 4),
                               avoid=lig_heavy)
            if ring is not None:
                heavy += ring
    pocket.hydrogens(heavy)
    for w in range(n_waters):
        for _ in range(50):
            p = rng.uniform(lo, hi)
            if pocket.free(p, also=lig_heavy):
                o = pocket.add(p, "O.3", f"HOH{w + 1}", -0.834)
                for _ in range(2):
                    d = rng.standard_normal(3)
                    pocket.bond(o, pocket.add(p + 0.96 * d / np.linalg.norm(d), "H",
                                              f"HOH{w + 1}", 0.417), "1")
                break
    return pocket


def write_raw_pdbbind(root: str, n_refined: int, n_core: int, seed: int = 805,
                      pocket_heavy: tuple[int, int] = (200, 340)) -> list[str]:
    """A PDBbind tree under ``root`` for ``preprocess_pdbbind``:
    ``refined-set/<id>/<id>_{ligand,pocket}.mol2`` for ``n_refined``
    complexes, ``core-set/<id>/`` holding the last ``n_core`` of them again
    (the core ids are also refined ids, as in PDBbind), and
    ``refined-set/index/INDEX_refined_data.2016`` with a -logKd label each.
    Ligands: 20-50 heavy atoms and their hydrogens, an aromatic ring, SYBYL
    types from C.3, C.2, C.ar, N.am, N.ar, N.3, N.4, O.2, O.3, O.co2, S.3,
    F, Cl, bonds of orders 1/2/ar/am, non-zero partial charges.  Pockets:
    residue-named fragments of ``pocket_heavy`` heavy atoms (500-900 atoms
    with hydrogens) in the 3.5-7.5 A shell around the ligand, then a few
    waters, so that the 6 A cut leaves complexes of a few hundred atoms in
    the three-subgraph layout.  Returns the complex ids."""
    rng = np.random.default_rng(seed)
    ids = [f"{1 + i // 900}{chr(97 + (i // 30) % 26)}{i % 30:02d}" for i in range(n_refined)]
    lines = ["# ==== synthetic PDBbind index: PDB code, resolution, release year, "
             "-logKd/Ki, Kd/Ki, reference ===="]
    for pid in ids:
        ligand = _raw_ligand(rng)
        pocket = _raw_pocket(rng, ligand, int(rng.integers(*pocket_heavy)),
                             int(rng.integers(3, 9)))
        label = float(rng.uniform(2.0, 11.5))
        lines.append(f"{pid}  {rng.uniform(1.2, 2.5):.2f}  2016  {label:5.2f}  "
                     f"Kd={10 ** (9 - label):.2f}nM  // {pid}.pdf")
        for split in ("refined-set", "core-set") if pid in ids[len(ids) - n_core:] \
                else ("refined-set",):
            d = os.path.join(root, split, pid)
            os.makedirs(d, exist_ok=True)
            ligand.write(os.path.join(d, f"{pid}_ligand.mol2"), pid, "SMALL")
            pocket.write(os.path.join(d, f"{pid}_pocket.mol2"), pid, "PROTEIN")
    os.makedirs(os.path.join(root, "refined-set", "index"), exist_ok=True)
    with open(os.path.join(root, "refined-set", "index", "INDEX_refined_data.2016"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return ids


_PDB_ELEMENTS = ("C", "N", "O")


def _pdb_atom(serial: int, name: str, res: str, seq: int, p, elem: str) -> str:
    return (f"ATOM  {serial:5d} {name:<4s} {res:>3s} A{seq:4d}    {p[0]:8.3f}{p[1]:8.3f}"
            f"{p[2]:8.3f}{1.0:6.2f}{0.0:6.2f}          {elem:>2s}\n")


def write_rna_candidate(path: str, mol: dict, rng: np.random.Generator) -> None:
    """One RNA-Puzzles candidate PDB of ``mol`` (``z`` in 0/1/2 for C/N/O,
    ``pos``, ``y``): its atoms in order, a phosphorus before every 20th atom
    and a hydrogen after every 3rd (which the preprocessor drops), a TER
    record, then the ``rms`` line with ``y``."""
    out, serial = [], 0
    for k, (z, p) in enumerate(zip(mol["z"], np.asarray(mol["pos"], np.float64))):
        seq = 1 + k // 20
        if k % 20 == 0:
            serial += 1
            out.append(_pdb_atom(serial, "P", "G", seq, p + [0.0, 1.6, 0.0], "P"))
        serial += 1
        elem = _PDB_ELEMENTS[int(z)]
        out.append(_pdb_atom(serial, f"{elem}{k % 9 + 1}'", "G", seq, p, elem))
        if k % 3 == 0:
            d = rng.standard_normal(3)
            serial += 1
            out.append(_pdb_atom(serial, "H", "G", seq, p + d / np.linalg.norm(d), "H"))
    out += ["TER\n", f"rms {float(mol['y']):.3f}\n", "END\n"]
    with open(path, "w") as f:
        f.write("".join(out))


def write_raw_rna_puzzles(root: str, n_train: int, n_val: int, seed: int = 40,
                          n_atoms: int = 2100, structures: list[dict] | None = None) -> None:
    """RNA-Puzzles candidates under ``root`` for ``preprocess_rna_puzzles``:
    ``example_train/cand_NNN.pdb`` and ``example_val/cand_NNN.pdb``, the
    geometry of ``synthetic_rna_dataset(n_train + n_val, seed, n_atoms)``
    (RNA-Puzzles' size at the default) or of the given ``structures``."""
    if structures is None:
        structures = synthetic_rna_dataset(n_train + n_val, seed=seed, n_atoms=n_atoms)
    rng = np.random.default_rng(seed)
    for split, mols in (("example_train", structures[:n_train]),
                        ("example_val", structures[n_train:n_train + n_val])):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i, mol in enumerate(mols):
            write_rna_candidate(os.path.join(root, split, f"cand_{i:03d}.pdb"), mol, rng)
