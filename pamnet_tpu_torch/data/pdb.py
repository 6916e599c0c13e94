"""Minimal PDB parser for the RNA-Puzzles pipeline (the port's copy of
``pamnet_tpu/data/pdb.py``): element symbols and coordinates of ATOM/HETATM
records in file order, and the ``rms`` score line that RNA-Puzzles candidate
files carry after the first TER record (reference:
preprocess_rna_puzzles.py:33-42)."""

from __future__ import annotations

import os

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


def parse_pdb_atoms(source) -> tuple[list[str], np.ndarray]:
    """(elements, (N, 3) float64 coords) of the ATOM/HETATM records, in file
    order, of ``source``: a path (as the JAX package's ``parse_pdb_atoms``
    takes), or lines (an open PDB file, or ``text.splitlines()``)."""
    if isinstance(source, (str, os.PathLike)):
        with open(source) as f:
            return parse_pdb_atoms(f)
    elems, coords = [], []
    for line in source:
        if line.startswith(("ATOM", "HETATM")):
            elems.append(_element(line))
            coords.append(
                (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            )
    return elems, np.asarray(coords, dtype=np.float64).reshape(-1, 3)


def parse_rms_label(path: str) -> float:
    """RMSD label from the ``rms`` line after the first TER record
    (reference: preprocess_rna_puzzles.py:33-42)."""
    with open(path) as f:
        for line in f:
            if "TER" in line:
                break
        cont = None
        for line in f:
            cont = line.split()
            if cont and cont[0] == "rms":
                break
    if not cont or cont[0] != "rms":
        raise ValueError(f"no rms record found in {path}")
    return float(cont[-1])
