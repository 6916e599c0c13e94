"""Host (numpy) graph construction: the port's copy of the numpy builders of
``pamnet_tpu/data/graphbuild.py``, with the same index conventions and tie
order.  An edge list is a (2, E) int array with ``src = edge_index[0]`` and
``dst = edge_index[1]``; neighbour searches emit (query, source) pairs in
query-major order, query in row 0 (reference: models.py:110-111).

Above ``native.NATIVE_MIN_NODES`` nodes (neighbour searches) or
``native.NATIVE_MIN_EDGES`` edges (triplets, pairs) the public builders hand
the work to the native library (``data/native.py``), which gives the same
arrays bit for bit; the ``*_np`` functions below are the plain versions that
the tests hold it against.  A batch vector must be sorted (graphs
contiguous)."""

from __future__ import annotations

import numpy as np

from pamnet_tpu_torch.data import native


def radius_graph(pos, r: float, batch=None, max_num_neighbors: int = 1000) -> np.ndarray:
    """``radius_graph_np``, natively above ``NATIVE_MIN_NODES`` nodes."""
    if np.shape(pos)[0] > native.NATIVE_MIN_NODES:
        return native.radius_graph(pos, r, batch, max_num_neighbors)
    return radius_graph_np(pos, r, batch, max_num_neighbors)


def knn_graph(pos, k: int, batch=None) -> np.ndarray:
    """``knn_graph_np``, natively above ``NATIVE_MIN_NODES`` nodes."""
    if np.shape(pos)[0] > native.NATIVE_MIN_NODES:
        return native.knn_graph(pos, k, batch)
    return knn_graph_np(pos, k, batch)


def triplets(edge_index: np.ndarray, num_nodes: int) -> dict:
    """``triplets_np``, natively above ``NATIVE_MIN_EDGES`` edges."""
    if edge_index.shape[1] > native.NATIVE_MIN_EDGES:
        return native.triplets(edge_index, num_nodes)
    return triplets_np(edge_index, num_nodes)


def pairs(edge_index: np.ndarray, num_nodes: int) -> dict:
    """``pairs_np``, natively above ``NATIVE_MIN_EDGES`` edges."""
    if edge_index.shape[1] > native.NATIVE_MIN_EDGES:
        return native.pairs(edge_index, num_nodes)
    return pairs_np(edge_index, num_nodes)


def radius_graph_np(
    pos: np.ndarray, r: float, batch: np.ndarray | None = None,
    max_num_neighbors: int = 1000,
) -> np.ndarray:
    """All (query, source) pairs within distance ``r`` in the same graph,
    self-pairs included (like ``torch_cluster.radius``).  (2, E) int32."""
    pos = np.asarray(pos, dtype=np.float32)
    if batch is None:
        batch = np.zeros(pos.shape[0], dtype=np.int64)
    queries, sources = [], []
    for g in np.unique(batch):
        idx = np.nonzero(batch == g)[0]
        p = pos[idx]
        d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        within = d2 <= r * r
        for qi in range(len(idx)):
            nbr = np.nonzero(within[qi])[0][:max_num_neighbors]
            queries.append(np.full(len(nbr), idx[qi], dtype=np.int64))
            sources.append(idx[nbr])
    if not queries:
        return np.zeros((2, 0), dtype=np.int32)
    return np.stack(
        [np.concatenate(queries), np.concatenate(sources)], axis=0
    ).astype(np.int32)


def knn_graph_np(
    pos: np.ndarray, k: int, batch: np.ndarray | None = None
) -> np.ndarray:
    """For each query its k nearest sources in the same graph, self included,
    distance ties broken by index (``torch_cluster.knn``, reference:
    models.py:143), float64 distances.  (2, E) int32, row 0 = query.  (The
    JAX package's numpy builder selects by ``argpartition``, which may take
    another of the sources tied at the k-th distance.)"""
    pos = np.asarray(pos, dtype=np.float32)
    if batch is None:
        batch = np.zeros(pos.shape[0], dtype=np.int64)
    queries, sources = [], []
    for g in np.unique(batch):
        idx = np.nonzero(batch == g)[0]
        p = pos[idx].astype(np.float64)
        m = len(idx)
        kk = min(k, m)
        d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        nbrs = np.argsort(d2, axis=1, kind="stable")[:, :kk]
        queries.append(np.repeat(idx, kk))
        sources.append(idx[nbrs.reshape(-1)])
    if not queries:
        return np.zeros((2, 0), dtype=np.int32)
    return np.stack(
        [np.concatenate(queries), np.concatenate(sources)], axis=0
    ).astype(np.int32)


def remove_self_loops_np(edge_index: np.ndarray) -> np.ndarray:
    """Drop src == dst edges (reference: models.py:63)."""
    return edge_index[:, edge_index[0] != edge_index[1]]


def edge_distances_np(edge_index: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """||pos[dst] - pos[src]|| per edge, float32."""
    src, dst = edge_index
    return np.sqrt(((pos[dst] - pos[src]) ** 2).sum(-1)).astype(np.float32)


def _expand_incoming(edge_index: np.ndarray, num_nodes: int, anchor: np.ndarray):
    """For each edge e, every edge id e' with dst[e'] == anchor[e]:
    (outer, inner) flat arrays, outer repeating e once per such e'."""
    dst = edge_index[1]
    sorted_eids = np.argsort(dst, kind="stable").astype(np.int64)
    counts_in = np.bincount(dst, minlength=num_nodes)
    offsets = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts_in, out=offsets[1:])
    counts = (offsets[anchor + 1] - offsets[anchor]).astype(np.int64)
    outer = np.repeat(np.arange(edge_index.shape[1], dtype=np.int64), counts)
    starts = np.repeat(offsets[anchor], counts)
    total = int(counts.sum())
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    return outer, sorted_eids[starts + within]


def triplets_np(edge_index: np.ndarray, num_nodes: int) -> dict:
    """Two-hop triplets: for each edge e = (j -> i), every edge (k -> j) with
    k != i (reference: models.py:74-84).  Rows stay grouped by the center
    edge (``idx_ji`` non-decreasing), which the CSR offsets rely on."""
    src, dst = edge_index.astype(np.int64)
    outer, inner = _expand_incoming(edge_index, num_nodes, src)
    idx_i, idx_j, idx_k = dst[outer], src[outer], src[inner]
    keep = idx_i != idx_k
    return {
        "idx_i": idx_i[keep].astype(np.int32),
        "idx_j": idx_j[keep].astype(np.int32),
        "idx_k": idx_k[keep].astype(np.int32),
        "idx_kj": inner[keep].astype(np.int32),
        "idx_ji": outer[keep].astype(np.int32),
    }


def pairs_np(edge_index: np.ndarray, num_nodes: int) -> dict:
    """One-hop pairs: for each edge e = (i -> j1), every edge (j2 -> j1) with
    j2 != j1, e itself included (reference: models.py:85-97)."""
    src, dst = edge_index.astype(np.int64)
    outer, inner = _expand_incoming(edge_index, num_nodes, dst)
    idx_i, idx_j1, idx_j2 = src[outer], dst[outer], src[inner]
    keep = idx_j1 != idx_j2
    return {
        "idx_i": idx_i[keep].astype(np.int32),
        "idx_j1": idx_j1[keep].astype(np.int32),
        "idx_j2": idx_j2[keep].astype(np.int32),
        "idx_jj": inner[keep].astype(np.int32),
        "idx_ji": outer[keep].astype(np.int32),
    }
