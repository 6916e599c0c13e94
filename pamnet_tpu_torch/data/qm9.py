"""QM9 dataset files (the port's copy of ``pamnet_tpu/data/qm9.py``;
reference: datasets/qm9_dataset.py).

An SDF parser of its own: the model needs atom elements, 3D coordinates and
the bond list, all in the gdb9 SDF text.  As in the reference:
  * the target matrix is reordered ``cat([y[:, 3:], y[:, :3]])``, moving the
    rotational constants A, B, C to the end (qm9_dataset.py:192), then
    converted Hartree -> eV and kcal/mol -> eV (qm9_dataset.py:21-27);
  * the uncharacterized molecules are skipped (qm9_dataset.py:195-196);
  * ``ATOMREFS`` keeps the per-atom reference energies (qm9_dataset.py:29-48);
  * the reference's main_qm9.py remaps targets 7/8/9/10 to +5 (:61-67).

The raw files (``gdb9.sdf``, ``gdb9.sdf.csv``, ``uncharacterized.txt``) are
read from ``<root>/raw``; nothing is fetched.  Parsed molecules are cached to
an ``.npz`` under ``<root>/processed``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

HAR2EV = 27.2113825435
KCALMOL2EV = 0.04336414

# Applied after reordering (reference: qm9_dataset.py:24-27,192-193).
CONVERSION = np.array(
    [1.0, 1.0, HAR2EV, HAR2EV, HAR2EV, 1.0, HAR2EV, HAR2EV, HAR2EV, HAR2EV,
     HAR2EV, 1.0, KCALMOL2EV, KCALMOL2EV, KCALMOL2EV, KCALMOL2EV, 1.0, 1.0, 1.0],
    dtype=np.float64,
)

ATOM_TYPES = {"H": 0, "C": 1, "N": 2, "O": 3, "F": 4}

# Per-atom reference energies by reordered target id (reference:
# qm9_dataset.py:29-48).  Like the reference's scripts, training never reads
# them (targets 12-15 of the CSV are atomization energies already).
ATOMREFS = {
    6: [0.0, 0.0, 0.0, 0.0, 0.0],
    7: [-13.61312172, -1029.86312267, -1485.30251237, -2042.61123593, -2713.48485589],
    8: [-13.5745904, -1029.82456413, -1485.26398105, -2042.5727046, -2713.44632457],
    9: [-13.54887564, -1029.79887659, -1485.2382935, -2042.54701705, -2713.42063702],
    10: [-13.90303183, -1030.25891228, -1485.71166277, -2043.01812778, -2713.88796536],
    11: [0.0, 0.0, 0.0, 0.0, 0.0],
}

RAW_FILES = ("gdb9.sdf", "gdb9.sdf.csv", "uncharacterized.txt")


def remap_target(target: int) -> int:
    """Target remap 7/8/9/10 -> 12/13/14/15 (U0_ATOM etc.; reference:
    main_qm9.py:61-67)."""
    return target + 5 if target in (7, 8, 9, 10) else target


def parse_sdf_molecules(sdf_path: str):
    """Yield (elements, pos, bonds) per ``$$$$``-delimited V2000 block.

    Exactly one item per block, ``None`` when the block is unparseable or
    holds an atom outside ``ATOM_TYPES``, so that ``enumerate`` over the
    generator tracks the raw block index and stays aligned with the CSV rows
    and the skip list (the reference enumerates its SDF reader the same way,
    qm9_dataset.py:203-205).  Whitespace after the last ``$$$$`` is not a
    block."""
    with open(sdf_path) as f:
        text = f.read()
    for block in text.split("$$$$\n"):
        lines = block.splitlines()
        if not any(ln.strip() for ln in lines):
            continue
        if len(lines) < 4:
            yield None
            continue
        counts = lines[3]
        try:
            na, nb = int(counts[0:3]), int(counts[3:6])
        except ValueError:
            yield None
            continue
        elems, pos = [], []
        ok = True
        for line in lines[4:4 + na]:
            try:
                x, y, z = float(line[0:10]), float(line[10:20]), float(line[20:30])
            except (ValueError, IndexError):
                ok = False
                break
            sym = line[31:34].strip()
            if sym not in ATOM_TYPES:
                ok = False
                break
            elems.append(ATOM_TYPES[sym])
            pos.append((x, y, z))
        if not ok:
            yield None
            continue
        bonds = []
        for line in lines[4 + na:4 + na + nb]:
            a, b = int(line[0:3]) - 1, int(line[3:6]) - 1
            bonds.append((a, b))
            bonds.append((b, a))
        yield (
            np.asarray(elems, np.int32),
            np.asarray(pos, np.float32),
            np.asarray(bonds, np.int64).reshape(-1, 2).T
            if bonds else np.zeros((2, 0), np.int64),
        )


def load_targets(csv_path: str) -> np.ndarray:
    """The 19-target matrix, reordered and unit-converted as the reference."""
    rows = []
    with open(csv_path) as f:
        next(f)  # header
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split(",")[1:20]])
    y = np.asarray(rows, dtype=np.float64)
    y = np.concatenate([y[:, 3:], y[:, :3]], axis=1)  # A, B, C to the end
    return y * CONVERSION


def load_skip_list(path: str) -> set[int]:
    """0-based indices of the uncharacterized molecules (reference:
    qm9_dataset.py:195-196): 9 header lines, 2 footer lines."""
    with open(path) as f:
        lines = f.read().split("\n")[9:-2]
    return {int(x.split()[0]) - 1 for x in lines}


def load_qm9(root: str, cache: bool = True) -> list[dict]:
    """QM9 as molecule dicts {z, pos, edge_index, y (19,)}, from the npz
    cache or the raw files under ``<root>/raw``.  Raises FileNotFoundError
    with staging instructions when the raw files are missing."""
    raw = os.path.join(root, "raw")
    cache_path = os.path.join(root, "processed", "qm9_pamnet_tpu_torch.npz")
    if cache and os.path.exists(cache_path):
        return _load_cache(cache_path)
    sdf, csv, unc = (os.path.join(raw, name) for name in RAW_FILES)
    missing = [p for p in (sdf, csv, unc) if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"QM9 raw files missing: {', '.join(missing)}. Stage gdb9.sdf, "
            f"gdb9.sdf.csv and uncharacterized.txt (the reference's qm9.zip "
            f"and its uncharacterized list, qm9_dataset.py:116-120) under {raw}."
        )
    targets = load_targets(csv)
    skip = load_skip_list(unc)
    mols = []
    dropped = 0
    for i, parsed in enumerate(parse_sdf_molecules(sdf)):
        if parsed is None:
            dropped += 1
            continue
        if i in skip:
            continue
        z, pos, bonds = parsed
        mols.append(dict(z=z, pos=pos, edge_index=bonds, y=targets[i]))
    if dropped:
        warnings.warn(
            f"load_qm9: {dropped} SDF blocks were unparseable or held atoms "
            "outside H/C/N/O/F and were dropped (labels stay aligned by block "
            "index)."
        )
    if cache:
        _save_cache(cache_path, mols)
    return mols


def _save_cache(path: str, mols: list[dict]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path,
        z=np.concatenate([m["z"] for m in mols]),
        pos=np.concatenate([m["pos"] for m in mols]),
        e=np.concatenate([m["edge_index"] for m in mols], axis=1),
        y=np.stack([m["y"] for m in mols]),
        nz=np.array([len(m["z"]) for m in mols]),
        ne=np.array([m["edge_index"].shape[1] for m in mols]),
    )


def _load_cache(path: str) -> list[dict]:
    f = np.load(path)
    zs = np.split(f["z"], np.cumsum(f["nz"])[:-1])
    ps = np.split(f["pos"], np.cumsum(f["nz"])[:-1])
    es = np.split(f["e"], np.cumsum(f["ne"])[:-1], axis=1)
    return [dict(z=z, pos=p, edge_index=e, y=y)
            for z, p, e, y in zip(zs, ps, es, f["y"])]


def select_target(mols: list[dict], target: int) -> list[dict]:
    """The reference's MyTransform: y = y[remap(target)] (reference:
    main_qm9.py:61-67)."""
    t = remap_target(target)
    return [dict(m, y=float(m["y"][t])) for m in mols]
