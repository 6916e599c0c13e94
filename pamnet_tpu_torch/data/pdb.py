"""Minimal PDB parser: element symbols and coordinates of ATOM/HETATM
records in file order (the port's copy of ``pamnet_tpu/data/pdb.py``)."""

from __future__ import annotations

import numpy as np

_TWO_LETTER = {"CL", "BR", "NA", "MG", "ZN", "FE", "MN", "SE"}


def _element(line: str) -> str:
    elem = line[76:78].strip().upper() if len(line) >= 78 else ""
    if elem:
        return elem.capitalize()
    name = line[12:16].strip()
    stem = "".join(c for c in name if c.isalpha()).upper()
    if stem[:2] in _TWO_LETTER:
        return stem[:2].capitalize()
    return stem[:1].capitalize()


def parse_pdb_atoms(lines) -> tuple[list[str], np.ndarray]:
    """(elements, (N, 3) float64 coords) of the ATOM/HETATM records among
    ``lines`` (an open PDB file, or ``text.splitlines()``), in file order."""
    elems, coords = [], []
    for line in lines:
        if line.startswith(("ATOM", "HETATM")):
            elems.append(_element(line))
            coords.append(
                (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            )
    return elems, np.asarray(coords, dtype=np.float64).reshape(-1, 3)
