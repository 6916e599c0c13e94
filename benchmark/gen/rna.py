"""RNA-like structures from a seed, their rigid copies, and their PDB text.

``rna_like_structure`` is a copy of ``pamnet_tpu_torch/data/synthetic.py::
rna_like_structure`` at commit 3e9441f with the same draws in the same
order and the same positions bit for bit, made faster: each step looks for
clashes among the atoms of the 5 x 5 x 5 cells of 2.1 A around the chain's
last atom instead of among all earlier atoms.  A candidate lies 1.5 A from
that atom, and only an atom within 2.1 A of a candidate decides whether it
is free (or, where none is, how crowded it is), so every such atom lies
within 3.6 A of the last atom, inside those cells (at least 4.2 A of them
on each side); the distances compared are the same numbers.  The chain:
1.5 A steps at a 115 degree bond angle with random torsions, inside a
sphere at heavy-atom density (0.05 per A^3), no atom closer than 2.1 A to
any but its two chain predecessors (where a step finds no such place it
takes the least crowded one, as the original does).

``bases`` come from a seed of the traffic's own, the same for every run,
so every run's requests hold the same graph sizes (the sizes of one seed's
bases differ from another's by several percent, which would change the
work from run to run); ``derived`` gives each request or training
structure its own rigid rotation and translation of a base, drawn from the
run's seed, and a jitter of 0.02 A (far under the 2.1 A spacing), so no two
are equal while every one keeps its base's shape and atom count.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

_CELL = 2.1
_REACH = 2  # cells on each side of the last atom's cell
_SLOTS = 16
_JITTER_A = 0.02
_TYPES = "CNO"
CACHE = Path(__file__).resolve().parents[2] / "build" / "bench_cache" / "data"


def rna_like_structure(rng: np.random.Generator, n_atoms: int) -> dict:
    """One compact folded chain of C/N/O atoms (module docstring); ``y`` is 0."""
    radius = (3.0 * n_atoms / (4.0 * np.pi * 0.05)) ** (1.0 / 3.0)
    step, cos_a = 1.5, np.cos(np.deg2rad(180.0 - 115.0))
    sin_a = np.sqrt(1.0 - cos_a**2)
    pos = np.zeros((n_atoms, 3))
    pos[1] = pos[0] + [step, 0.0, 0.0]
    # Cell table over the sphere and a margin; an atom outside it, or in a
    # full cell, goes to ``spill``, which every step searches whole.
    origin = -(radius + 4 * _CELL)
    size = int(np.ceil(2 * (radius + 4 * _CELL) / _CELL)) + 1
    cells = np.full((size, size, size, _SLOTS), -1, dtype=np.int64)
    fill = np.zeros((size, size, size), dtype=np.int64)
    spill: list[int] = []

    def cell_of(p):
        return np.floor((p - origin) / _CELL).astype(np.int64)

    def insert(k: int) -> None:
        c = cell_of(pos[k])
        if (c >= _REACH).all() and (c < size - _REACH).all() and fill[tuple(c)] < _SLOTS:
            cells[c[0], c[1], c[2], fill[tuple(c)]] = k
            fill[tuple(c)] += 1
        else:
            spill.append(k)

    for i in range(2, n_atoms):
        u = pos[i - 1] - pos[i - 2]
        u /= np.linalg.norm(u)
        ref = np.array([0.0, 0.0, 1.0]) if abs(u[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
        v = np.cross(u, ref)
        v /= np.linalg.norm(v)
        w = np.cross(u, v)
        tors = rng.uniform(0.0, 2.0 * np.pi, 16)
        dirs = (cos_a * u[None] + sin_a * (np.cos(tors)[:, None] * v[None]
                                           + np.sin(tors)[:, None] * w[None]))
        cand = pos[i - 1] + step * dirs
        r = np.linalg.norm(cand, axis=1)
        if i > 2:
            insert(i - 3)  # atoms before the two predecessors are searched
            c = cell_of(pos[i - 1])
            if (c >= _REACH).all() and (c < size - _REACH).all():
                near = cells[c[0] - _REACH:c[0] + _REACH + 1, c[1] - _REACH:c[1] + _REACH + 1,
                             c[2] - _REACH:c[2] + _REACH + 1].reshape(-1)
                near = near[near >= 0]
                if spill:
                    near = np.concatenate([near, spill])
            else:
                near = np.arange(i - 2)
            if near.size:
                d = np.sqrt(((cand[:, None] - pos[None, near]) ** 2).sum(-1).min(1))
            else:
                d = np.full(len(cand), np.inf)
        else:
            d = np.full(len(cand), np.inf)
        free = d >= 2.1
        if (free & (r <= radius)).any():
            pick = np.argmax(free & (r <= radius))
        elif free.any():
            pick = np.argmin(np.where(free, r, np.inf))
        else:
            pick = np.argmax(d)
        pos[i] = cand[pick]
    z = rng.choice(3, size=n_atoms, p=[0.45, 0.35, 0.20]).astype(np.int32)
    return dict(z=z, pos=pos.astype(np.float32), y=0.0)


def bases(seed: int, count: int, n_atoms: int) -> list[dict]:
    """``count`` base structures of ``n_atoms`` atoms from ``seed`` (the
    traffic's ``base_seed``), each labelled with ``20 * (share of N
    atoms)``, the composition term of the program's
    ``synthetic_rna_dataset`` label.  Kept in ``CACHE`` inside the checkout
    under a name made of the arguments and this module's source, so a
    checkout's later runs read what its first run made."""
    key = hashlib.sha256(Path(__file__).read_bytes()).hexdigest()[:12]
    path = CACHE / f"rna_bases_{seed}_{count}_{n_atoms}_{key}.npz"
    if path.is_file():
        with np.load(path) as f:
            return [dict(z=f[f"z{k}"], pos=f[f"pos{k}"], y=float(f["y"][k]))
                    for k in range(count)]
    rng = np.random.default_rng([seed, 1])
    out = [rna_like_structure(rng, n_atoms) for _ in range(count)]
    for m in out:
        m["y"] = float(20.0 * np.mean(m["z"] == 1))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, y=np.array([m["y"] for m in out]),
             **{f"z{k}": m["z"] for k, m in enumerate(out)},
             **{f"pos{k}": m["pos"] for k, m in enumerate(out)})
    os.replace(tmp, path)
    return out


def _rotation(rng: np.random.Generator) -> np.ndarray:
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def derived(base_list: list[dict], seed: int, index: int, stream: int) -> dict:
    """Structure ``index`` of stream ``stream`` (requests, training, ...)
    of the run's ``seed``: a rigid rotation and a translation of up to 10 A
    of base ``(index + seed) % len(base_list)``, with a 0.02 A jitter, drawn
    from ``(seed, stream, index)``; its label is the base's plus |N(0, 1)|,
    as the program's ``synthetic_rna_dataset`` adds."""
    rng = np.random.default_rng([seed, 2 + stream, index])
    base = base_list[(index + seed) % len(base_list)]
    pos = base["pos"].astype(np.float64)
    centre = pos.mean(0)
    pos = (pos - centre) @ _rotation(rng).T + centre + rng.uniform(-10.0, 10.0, 3)
    pos = pos + rng.normal(0.0, _JITTER_A, pos.shape)
    return dict(z=base["z"].copy(), pos=pos.astype(np.float32),
                y=float(base["y"] + abs(rng.standard_normal())))


def pdb_text(mol: dict) -> str:
    """The structure as PDB ATOM records (element in columns 77-78,
    coordinates at 3 decimals), one residue per 20 atoms."""
    lines = []
    for k, (t, (x, y, z)) in enumerate(zip(mol["z"], mol["pos"])):
        el = _TYPES[int(t)]
        lines.append(f"ATOM  {k + 1:5d}  {el:<3s} {'A':>3s} A{k // 20 + 1:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {el:>2s}")
    lines.append("END")
    return "\n".join(lines) + "\n"


def parse_pdb(text: str) -> dict:
    """``z`` (0=C 1=N 2=O) and float32 ``pos`` of the C/N/O ATOM records of
    ``text``, as the PDB text wrote them (the benchmark's own reader)."""
    z, pos = [], []
    for line in text.splitlines():
        if line.startswith(("ATOM", "HETATM")):
            el = line[76:78].strip().upper()
            if el in ("C", "N", "O"):
                z.append(_TYPES.index(el))
                pos.append((float(line[30:38]), float(line[38:46]), float(line[46:54])))
    return dict(z=np.asarray(z, np.int32), pos=np.asarray(pos, np.float32))


def molecules(traffic: dict, seed: int, count: int, stream: int) -> list[dict]:
    """``count`` structures of a split (``stream`` tells the splits apart):
    seeded copies of the traffic's ``bases`` of ``n_atoms`` atoms from its
    ``base_seed``."""
    base_list = bases(traffic["base_seed"], traffic["bases"], traffic["n_atoms"])
    return [derived(base_list, seed, k, stream) for k in range(count)]
