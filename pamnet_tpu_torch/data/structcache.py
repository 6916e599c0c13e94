"""On-disk cache of built graph structures (the port's copy of
``pamnet_tpu/data/structcache.py``, in its format: a cache directory written
by either package is served by the other without a rebuild, its structures
equal bit for bit).

A structure is what ``data/batch.py::precompute_structure`` builds for one
molecule (the graphs, triplet and pair tables, f64-exact distances), with
the host spherical basis of ``attach_basis`` where the spec asks for it.
The reference materializes its preprocessing once into
``processed/data*.pt`` (reference: datasets/qm9_dataset.py:170-265); this
cache does the same for the structures.

* **Chunked column packs.** Molecules are grouped into chunks (default
  512); each chunk is one ``.npz`` holding every field concatenated across
  the chunk plus per-molecule counts.
* **Content-addressed.** A chunk's file name hashes the format version,
  the build spec and every molecule's content fingerprint, so a changed
  cutoff, basis order, variant or molecule never serves a stale chunk.
* **Resumable.** Chunks are written atomically (a temporary file, then a
  rename) as they are built; a killed run resumes at the missing chunks.
* **Parallel.** ``num_workers > 1`` builds the missing chunks in a
  ``spawn`` process pool.  The native graph library is built in the parent
  first, so the workers never compile it at once; workers build on the host
  only and never touch CUDA.

A chunk that is there but cannot be read raises; it is never rebuilt
behind the caller's back.  ``load_or_build.built`` holds the number of
chunks the last call built (0 on a warm cache).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile

import numpy as np

_FORMAT_VERSION = 1
_T2_KEYS = ("idx_i", "idx_j", "idx_k", "idx_kj", "idx_ji")
_T1_KEYS = ("idx_i", "idx_j1", "idx_j2", "idx_jj", "idx_ji")


@dataclasses.dataclass(frozen=True)
class BuildSpec:
    """Everything that determines a structure's content besides the
    molecule.  Fields are held as plain Python values (a numpy scalar
    cutoff becomes a float), since the key hashes their ``repr``: under
    numpy 2 ``np.float64(5.0)`` and ``5.0`` print differently, and the
    JAX package's drivers hand it Python values."""

    dataset_kind: str
    cutoff_l: float
    cutoff_g: float
    variant: str = "full"
    precompute_basis: bool = True
    num_spherical: int = 7
    num_radial: int = 6
    envelope_exponent: int = 5

    def __post_init__(self):
        for f, kind in (("dataset_kind", str), ("cutoff_l", float), ("cutoff_g", float),
                        ("variant", str), ("precompute_basis", bool),
                        ("num_spherical", int), ("num_radial", int),
                        ("envelope_exponent", int)):
            object.__setattr__(self, f, kind(getattr(self, f)))

    def key(self) -> str:
        h = hashlib.sha1()
        h.update(repr((_FORMAT_VERSION, dataclasses.astuple(self))).encode())
        return h.hexdigest()[:16]


def mol_fingerprint(mol: dict) -> bytes:
    """Content hash of one input molecule (positions, types, features,
    bonds, label), whatever dtypes the reader gave them."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(mol["pos"], np.float32).tobytes())
    if "z" in mol:
        h.update(np.ascontiguousarray(mol["z"], np.int32).tobytes())
    if "feat" in mol:
        h.update(np.ascontiguousarray(mol["feat"], np.float32).tobytes())
    if "edge_index" in mol:
        h.update(np.ascontiguousarray(mol["edge_index"], np.int64).tobytes())
    h.update(np.float32(mol["y"]).tobytes())
    return h.digest()


def _chunk_path(cache_dir: str, spec_key: str, start: int, fps: list[bytes]) -> str:
    h = hashlib.sha1()
    h.update(spec_key.encode())
    for fp in fps:
        h.update(fp)
    return os.path.join(cache_dir, f"pamnet-{spec_key}-{start:08d}-{h.hexdigest()[:16]}.npz")


def build_structures(mols: list[dict], spec: BuildSpec) -> list[dict]:
    """The structures of ``mols`` as the loader builds them without a
    cache."""
    from pamnet_tpu_torch.data.batch import attach_basis, precompute_structure

    structs = [precompute_structure(m, spec.dataset_kind, spec.cutoff_l, spec.cutoff_g,
                                    spec.variant) for m in mols]
    if spec.precompute_basis:
        for s in structs:
            attach_basis(s, spec.cutoff_l, spec.num_spherical, spec.num_radial,
                         spec.envelope_exponent)
    return structs


def pack_chunk(structs: list[dict]) -> dict:
    """Column-pack a list of structures into flat arrays + counts."""
    out: dict = {
        "counts_n": np.array([s["pos"].shape[0] for s in structs], np.int64),
        "counts_eg": np.array([s["eg"].shape[1] for s in structs], np.int64),
        "counts_el": np.array([s["el"].shape[1] for s in structs], np.int64),
        "counts_t2": np.array([s["t2"]["idx_ji"].shape[0] for s in structs], np.int64),
        "counts_t1": np.array([s["t1"]["idx_ji"].shape[0] for s in structs], np.int64),
        "y": np.array([s["y"] for s in structs], np.float32),
    }
    for f in ("pos", "z", "feat"):
        out[f] = np.concatenate([s[f] for s in structs])
    for f in ("eg", "el"):
        out[f] = np.concatenate([s[f] for s in structs], axis=1)
    for f in ("dist_g", "dist_l"):
        out[f] = np.concatenate([s[f] for s in structs])
    for k in _T2_KEYS:
        out[f"t2_{k}"] = np.concatenate([s["t2"][k] for s in structs])
    for k in _T1_KEYS:
        out[f"t1_{k}"] = np.concatenate([s["t1"][k] for s in structs])
    if "sbf_radial" in structs[0]:
        for f in ("sbf_radial", "cbf2", "cbf1"):
            out[f] = np.concatenate([s[f] for s in structs])
    return out


def unpack_chunk(data: dict) -> list[dict]:
    """Inverse of :func:`pack_chunk`.  Row fields are views of the chunk's
    arrays; each structure's ``eg``/``el`` is a C-contiguous (2, E) copy,
    as ``precompute_structure`` gives them (a slice along axis 1 would be
    a strided view, which no raw-address reader may see)."""
    splits = {k: np.cumsum(data[f"counts_{k}"])[:-1] for k in ("n", "eg", "el", "t2", "t1")}

    def sp(arr, key, axis=0):
        return np.split(arr, splits[key], axis=axis)

    rows = {f: sp(data[f], "n") for f in ("pos", "z", "feat")}
    rows["eg"] = [np.ascontiguousarray(a) for a in sp(data["eg"], "eg", axis=1)]
    rows["el"] = [np.ascontiguousarray(a) for a in sp(data["el"], "el", axis=1)]
    rows["dist_g"], rows["dist_l"] = sp(data["dist_g"], "eg"), sp(data["dist_l"], "el")
    if "sbf_radial" in data:
        rows["sbf_radial"] = sp(data["sbf_radial"], "el")
        rows["cbf2"], rows["cbf1"] = sp(data["cbf2"], "t2"), sp(data["cbf1"], "t1")
    t2 = {k: sp(data[f"t2_{k}"], "t2") for k in _T2_KEYS}
    t1 = {k: sp(data[f"t1_{k}"], "t1") for k in _T1_KEYS}
    return [{**{f: v[i] for f, v in rows.items()}, "y": np.float32(data["y"][i]),
             "t2": {k: t2[k][i] for k in _T2_KEYS}, "t1": {k: t1[k][i] for k in _T1_KEYS}}
            for i in range(len(data["counts_n"]))]


def _atomic_savez(path: str, payload: dict) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _build_and_save(job) -> str:
    mols, spec, path = job
    _atomic_savez(path, pack_chunk(build_structures(mols, spec)))
    return path


def load_or_build(mols: list[dict], spec: BuildSpec, cache_dir: str, chunk_size: int = 512,
                  num_workers: int = 0, progress: bool = False) -> list[dict]:
    """The structures of ``mols``: chunks found in ``cache_dir`` are read,
    the missing ones built (in ``num_workers`` spawned processes where it
    is above 1), written atomically and read back.  Sets
    ``load_or_build.built`` to the number of chunks built."""
    os.makedirs(cache_dir, exist_ok=True)
    spec_key = spec.key()
    paths = [_chunk_path(cache_dir, spec_key, start,
                         [mol_fingerprint(m) for m in mols[start:start + chunk_size]])
             for start in range(0, len(mols), chunk_size)]
    missing = [(mols[i * chunk_size:(i + 1) * chunk_size], spec, path)
               for i, path in enumerate(paths) if not os.path.exists(path)]
    load_or_build.built = 0
    if missing:
        from pamnet_tpu_torch.data import native

        native.build()
        if num_workers > 1:
            import multiprocessing as mp

            with mp.get_context("spawn").Pool(num_workers) as pool:
                done = pool.imap_unordered(_build_and_save, missing)
                for i, _ in enumerate(done):
                    load_or_build.built = i + 1
                    if progress:
                        print(f"structcache: built {i + 1}/{len(missing)} chunks", flush=True)
        else:
            for i, job in enumerate(missing):
                _build_and_save(job)
                load_or_build.built = i + 1
                if progress:
                    print(f"structcache: built {i + 1}/{len(missing)} chunks", flush=True)
    structs: list[dict] = []
    for path in paths:
        with np.load(path) as data:
            structs.extend(unpack_chunk(dict(data)))
    return structs


load_or_build.built = 0
