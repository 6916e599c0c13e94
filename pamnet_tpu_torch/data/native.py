"""The port's native host graph builders (``csrc/graphbuild.cc``) through
``ctypes``: the counterpart of ``pamnet_tpu/data/native.py``'s radius, knn,
triplet and pair builders, each bit for bit the numpy builder of
``data/graphbuild.py`` on the same input, and of its collation helpers
(``concat_offset_i32``, ``concat_rows_f32``: a padded concatenation read
from arrays of source addresses, bit for bit the numpy collation of
``data/batch.py``), of a batch's CSR arrays (``csr_perm``,
``csr_offsets``: bit for bit ``batch.build_perm_np`` and ``batch._offsets``)
and of a structure's host spherical basis (``sbf_radial``, ``cbf``: bit for
bit ``batch.attach_basis_np``, but for a rare float32 ulp of the radial
table where numpy's BLAS adds j_l's closed form in another order:
``tests/test_torch_native_basis.py``).

``ctypes.CDLL`` releases the GIL for the length of each call, so threads
that build structures at once (the scoring service's handlers) run these
routines in parallel.

The library is compiled by ``g++`` at first use into ``build/torch_ext/`` at
the repository root, named by a hash of the source and the flags, so an
edited source is rebuilt.  When it cannot be built or loaded, every call
raises: nothing carries on in numpy behind the caller's back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

# Above these sizes data/graphbuild.py hands a build to the library (the JAX
# package's thresholds).
NATIVE_MIN_NODES = 512
NATIVE_MIN_EDGES = 8192

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "graphbuild.cc"
BUILD_DIR = _PKG.parent / "build" / "torch_ext"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgraphbuild_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library exists; raises on failure."""
    out = library_path()
    if out.is_file():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native graph builders cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        staged = Path(tmp) / out.name
        res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(staged)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{res.stdout}")
        os.replace(staged, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built at first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
            u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
            i64, f32, f64 = ctypes.c_int64, ctypes.c_float, ctypes.c_double
            lib.radius_graph.argtypes = [f32p, i64p, i64, f32, f32, i64, i32p, i64]
            lib.knn_graph.argtypes = [f32p, i64p, i64, i64, i32p, i64]
            lib.expand_incoming.argtypes = [i32p, i32p, i64, i64, i32p, i64]
            lib.concat_offset_i32.argtypes = [u64p, i64p, i32p, i64, i32p, i64]
            lib.concat_rows_f32.argtypes = [u64p, i64p, i64, i64, f32p, i64]
            lib.csr_perm.argtypes = [i32p, i64, i64, i64, i32p, i32p]
            lib.csr_offsets.argtypes = [i32p, i64, i64, i32p]
            lib.sbf_radial.argtypes = [f64p, i64, i32p, i32p, i64, f64, i64, i64, i64,
                                       f64p, f64p, f64p, f64p, f32p]
            lib.cbf.argtypes = [f64p, i64, i32p, i32p, i32p, i64, i64, f64p, f32p]
            for fn in (lib.radius_graph, lib.knn_graph, lib.expand_incoming,
                       lib.concat_offset_i32, lib.concat_rows_f32, lib.csr_perm,
                       lib.csr_offsets, lib.sbf_radial, lib.cbf):
                fn.restype = i64
            _lib = lib
    return _lib


def _grow(call, cap: int) -> np.ndarray:
    """Run ``call(out, cap)`` with a doubling buffer until its rows fit:
    the (2, m) int32 result."""
    while True:
        out = np.empty(2 * cap, dtype=np.int32)
        m = call(out, cap)
        if m >= 0:
            return np.stack([out[:m], out[cap:cap + m]])
        cap *= 2


def _inputs(pos, batch):
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    n = pos.shape[0]
    batch = (np.zeros(n, np.int64) if batch is None
             else np.ascontiguousarray(batch, dtype=np.int64))
    if n and np.any(np.diff(batch) < 0):
        raise ValueError("the batch vector must be sorted (graphs contiguous)")
    return pos, batch, n


def radius_graph(pos, r: float, batch=None, max_num_neighbors: int = 1000) -> np.ndarray:
    """``graphbuild.radius_graph_np`` in C++: (2, E) int32, row 0 the query."""
    pos, batch, n = _inputs(pos, batch)
    lib = library()
    # numpy compares the float32 squared distance with float32(r * r).
    r2, cell = np.float32(r * r), np.float32(r) * np.float32(1.0 + 1e-5)
    return _grow(lambda out, cap: lib.radius_graph(pos, batch, n, cell, r2,
                                                   max_num_neighbors, out, cap),
                 max(n * 32, 1024))


def knn_graph(pos, k: int, batch=None) -> np.ndarray:
    """``graphbuild.knn_graph_np`` in C++: (2, E) int32, row 0 the query."""
    pos, batch, n = _inputs(pos, batch)
    lib = library()
    return _grow(lambda out, cap: lib.knn_graph(pos, batch, n, k, out, cap),
                 max(n * k, 1))


def _expand(edge_index: np.ndarray, num_nodes: int, anchor_row: int):
    """(outer, inner) int64: every edge e' with dst[e'] == anchor[e], for
    each edge e in order."""
    lib = library()
    dst = np.ascontiguousarray(edge_index[1], dtype=np.int32)
    anchor = np.ascontiguousarray(edge_index[anchor_row], dtype=np.int32)
    e = dst.shape[0]
    pair = _grow(lambda out, cap: lib.expand_incoming(dst, anchor, e, num_nodes, out, cap),
                 max(e * 8, 1 << 16))
    return pair[0].astype(np.int64), pair[1].astype(np.int64)


def triplets(edge_index: np.ndarray, num_nodes: int) -> dict:
    """``graphbuild.triplets_np`` with the expansion in C++."""
    outer, inner = _expand(edge_index, num_nodes, 0)
    src, dst = edge_index.astype(np.int64)
    idx_i, idx_j, idx_k = dst[outer], src[outer], src[inner]
    keep = idx_i != idx_k
    return {
        "idx_i": idx_i[keep].astype(np.int32),
        "idx_j": idx_j[keep].astype(np.int32),
        "idx_k": idx_k[keep].astype(np.int32),
        "idx_kj": inner[keep].astype(np.int32),
        "idx_ji": outer[keep].astype(np.int32),
    }


def pairs(edge_index: np.ndarray, num_nodes: int) -> dict:
    """``graphbuild.pairs_np`` with the expansion in C++."""
    outer, inner = _expand(edge_index, num_nodes, 1)
    src, dst = edge_index.astype(np.int64)
    idx_i, idx_j1, idx_j2 = src[outer], dst[outer], src[inner]
    keep = idx_j1 != idx_j2
    return {
        "idx_i": idx_i[keep].astype(np.int32),
        "idx_j1": idx_j1[keep].astype(np.int32),
        "idx_j2": idx_j2[keep].astype(np.int32),
        "idx_jj": inner[keep].astype(np.int32),
        "idx_ji": outer[keep].astype(np.int32),
    }


def addresses(arrays) -> tuple[np.ndarray, np.ndarray]:
    """(uint64 data addresses, int64 lengths along the first axis) of
    ``arrays``, for ``concat_offset_i32`` / ``concat_rows_f32``.  The caller
    keeps the arrays alive while the addresses are used."""
    addrs = np.empty(len(arrays), np.uint64)
    lens = np.empty(len(arrays), np.int64)
    for k, a in enumerate(arrays):
        ai = a.__array_interface__
        addrs[k], lens[k] = ai["data"][0], a.shape[0]
    return addrs, lens


def _overflow(lens: np.ndarray, size: int) -> ValueError:
    return ValueError(f"padding overflow: have {int(lens.sum())} rows, bucket holds {size}")


def concat_offset_i32(addrs: np.ndarray, lens: np.ndarray, offs: np.ndarray,
                      out_len: int) -> np.ndarray:
    """(out_len,) int32: the C-contiguous int32 arrays at ``addrs`` (``lens``
    values each) one after another, array a's values plus ``offs[a]``, zeros
    after them; ``_pad1(np.concatenate([x + o ...]), out_len)`` bit for bit.
    Raises ValueError("padding overflow: ...") when they pass ``out_len``."""
    out = np.empty(out_len, np.int32)
    offs = np.ascontiguousarray(offs, np.int32)
    if library().concat_offset_i32(addrs, lens, offs, len(addrs), out, out_len) < 0:
        raise _overflow(lens, out_len)
    return out


def concat_rows_f32(addrs: np.ndarray, lens: np.ndarray, trailing: tuple,
                    out_rows: int) -> np.ndarray:
    """(out_rows, *trailing) float32: the C-contiguous float32 arrays at
    ``addrs`` (``lens`` rows of shape ``trailing`` each) one after another,
    zero rows after them.  Raises as ``concat_offset_i32``."""
    out = np.empty((out_rows, *trailing), np.float32)
    row_w = int(np.prod(trailing, dtype=np.int64))
    if library().concat_rows_f32(addrs, lens, row_w, len(addrs), out, out_rows) < 0:
        raise _overflow(lens, out_rows)
    return out


def _ids(ids: np.ndarray, num_valid: int) -> np.ndarray:
    ids = np.ascontiguousarray(ids, np.int32)
    if not 0 <= num_valid <= ids.shape[0]:
        raise ValueError(f"{num_valid} valid rows of {ids.shape[0]}")
    return ids


def csr_perm(ids: np.ndarray, num_valid: int, num_groups: int,
             total_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """``batch.build_perm_np`` in C++, a stable counting sort: (perm
    (total_rows,), poff (num_groups+1,)) int32.  Raises ValueError("group id
    out of range") as it does."""
    ids = _ids(ids, num_valid)
    if total_rows < num_valid:
        raise ValueError(f"{num_valid} valid rows of {total_rows}")
    perm, poff = np.empty(total_rows, np.int32), np.empty(num_groups + 1, np.int32)
    if library().csr_perm(ids, num_valid, num_groups, total_rows, perm, poff) < 0:
        raise ValueError("group id out of range")
    return perm, poff


def csr_offsets(ids: np.ndarray, num_valid: int, num_groups: int) -> np.ndarray | None:
    """``batch._offsets`` in C++: the (num_groups+1,) int32 CSR offsets of
    the first ``num_valid`` rows, sorted by ``ids``, or None where they are
    not sorted."""
    ids = _ids(ids, num_valid)
    off = np.empty(num_groups + 1, np.int32)
    if library().csr_offsets(ids, num_valid, num_groups, off) < 0:
        return None
    return off


def _positions(pos: np.ndarray) -> np.ndarray:
    pos = np.ascontiguousarray(pos, np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"positions of shape {pos.shape}, want (n, 3)")
    return pos


def sbf_radial(pos: np.ndarray, edge_index: np.ndarray, cutoff_l: float,
               envelope_exponent: int, tables: dict) -> np.ndarray:
    """(E, ns*nr) float32: the radial part of the spherical basis of the
    local edges ``edge_index`` (2, E) over the float64 positions ``pos``,
    with the constants ``tables`` of ``ops.bessel.bessel_basis_tables(ns,
    nr)``; ``batch.attach_basis_np``'s ``sbf_radial``.  Raises IndexError on
    an index outside the positions."""
    if envelope_exponent < 0:
        raise ValueError(f"envelope exponent {envelope_exponent} < 0")
    pos = _positions(pos)
    zeros, norm = (np.ascontiguousarray(tables[k], np.float64) for k in ("zeros", "norm"))
    S, C = (np.ascontiguousarray(tables[k], np.float64) for k in ("S", "C"))
    ns, nr = zeros.shape
    if norm.shape != (ns, nr) or S.shape != (ns, ns + 1) or C.shape != S.shape:
        raise ValueError("basis tables of mismatched shapes")
    src, dst = (np.ascontiguousarray(r, np.int32) for r in edge_index)
    out = np.empty((src.shape[0], ns * nr), np.float32)
    if library().sbf_radial(pos, pos.shape[0], src, dst, src.shape[0], float(cutoff_l),
                            int(envelope_exponent), ns, nr, zeros, norm, S, C, out) < 0:
        raise IndexError("edge index out of range")
    return out


def cbf(pos: np.ndarray, ia: np.ndarray, ib: np.ndarray, ic: np.ndarray,
        sph_pref: np.ndarray) -> np.ndarray:
    """(T, ns) float32: the angular part of the spherical basis of the
    triplets or pairs (ia, ib, ic) over the float64 positions ``pos``, the
    angle between pos[ib] - pos[ia] and pos[ic] - pos[ib]; ``ns =
    len(sph_pref)``; ``batch.attach_basis_np``'s ``cbf2`` / ``cbf1``.
    Raises IndexError on an index outside the positions."""
    pos = _positions(pos)
    pref = np.ascontiguousarray(sph_pref, np.float64)
    ia, ib, ic = (np.ascontiguousarray(a, np.int32) for a in (ia, ib, ic))
    if not ia.ndim == 1 or not ia.shape == ib.shape == ic.shape:
        raise ValueError("index arrays of mismatched shapes")
    out = np.empty((ia.shape[0], pref.shape[0]), np.float32)
    if library().cbf(pos, pos.shape[0], ia, ib, ic, ia.shape[0], pref.shape[0], pref, out) < 0:
        raise IndexError("triplet index out of range")
    return out
