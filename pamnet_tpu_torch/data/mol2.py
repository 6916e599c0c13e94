"""Minimal TRIPOS mol2 parser (the port's copy of ``pamnet_tpu/data/mol2.py``;
host-side, replaces the OpenBabel/pybel
dependency of the reference's PDBbind pipeline — reference:
preprocess_pdbbind.py:4,86-89).

Extracts exactly what the featurizer needs: element, coordinates, SYBYL atom
type, partial charge (mol2 column 9), substructure name, and the bond graph
with orders.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ELEMENTS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Cr": 24, "Mn": 25,
    "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29, "Zn": 30, "Ga": 31, "As": 33,
    "Se": 34, "Br": 35, "Rb": 37, "Sr": 38, "Mo": 42, "Ru": 44, "Rh": 45,
    "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50, "Sb": 51, "Te": 52,
    "I": 53, "Cs": 55, "Ba": 56, "W": 74, "Re": 75, "Os": 76, "Ir": 77,
    "Pt": 78, "Au": 79, "Hg": 80, "Tl": 81, "Pb": 82, "Bi": 83, "U": 92,
    "Du": 0, "LP": 0,
}


@dataclasses.dataclass
class Mol2:
    atomic_num: np.ndarray  # (N,) int
    pos: np.ndarray  # (N, 3) float32
    charge: np.ndarray  # (N,) float32 partial charges
    sybyl: list[str]  # SYBYL atom types, e.g. "C.3", "N.ar"
    subst: list[str]  # substructure names (e.g. residue, "HOH")
    bonds: list[tuple[int, int, str]]  # 0-based (a, b, order) order in
    #   {"1","2","3","am","ar","du","un","nc"}

    def __len__(self):
        return len(self.atomic_num)


def _element_of(sybyl_type: str, atom_name: str) -> int:
    sym = sybyl_type.split(".")[0]
    if sym in ELEMENTS:
        return ELEMENTS[sym]
    # Fall back to the atom name's leading letters.
    stem = "".join(c for c in atom_name if c.isalpha())[:2].capitalize()
    return ELEMENTS.get(stem, ELEMENTS.get(stem[:1], 0))


def parse_mol2(path: str) -> Mol2:
    atoms, bonds = [], []
    section = None
    with open(path) as f:
        for line in f:
            if line.startswith("@<TRIPOS>"):
                section = line.strip()[9:]
                continue
            if not line.strip():
                continue
            if section == "ATOM":
                p = line.split()
                # id name x y z type [subst_id [subst_name [charge]]]
                atoms.append(
                    (
                        p[1],
                        float(p[2]), float(p[3]), float(p[4]),
                        p[5],
                        p[7] if len(p) > 7 else "",
                        float(p[8]) if len(p) > 8 else 0.0,
                    )
                )
            elif section == "BOND":
                p = line.split()
                # Order string lowercased: SYBYL writers emit case variants
                # ("ar"/"Ar"/"AR", "am"/"Am") and all downstream lookups
                # (_ORDER_VALENCE, aromatic-bond perception) expect lowercase.
                bonds.append((int(p[1]) - 1, int(p[2]) - 1, p[3].lower()))
            elif section == "MOLECULE":
                pass
    return Mol2(
        atomic_num=np.array(
            [_element_of(a[4], a[0]) for a in atoms], dtype=np.int64
        ),
        pos=np.array([[a[1], a[2], a[3]] for a in atoms], dtype=np.float32),
        charge=np.array([a[6] for a in atoms], dtype=np.float32),
        sybyl=[a[4] for a in atoms],
        subst=[a[5] for a in atoms],
        bonds=bonds,
    )
