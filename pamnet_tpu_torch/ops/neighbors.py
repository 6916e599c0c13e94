"""Graph construction on the device with static shapes
(``pamnet_tpu/ops/neighbors.py``): radius and knn edges over a padded node
set, and the triplet and pair tables of a padded local edge list.

Semantics are the host builders' and the JAX package's: self-pairs dropped
by the radius search (kept by knn, as ``torch_cluster.knn``), a per-query
neighbour cap, knn ties broken by index, padded entries at 0 and the rows
past each pad dropped.  Nothing here reads a value back to the
host or sizes a tensor by one: a selection is compacted into its pad by a
cumulative sum and a scatter of each kept row to its rank (``compact``),
where JAX calls ``jnp.nonzero(size=)``, and no float is accumulated
atomically.  Every function also returns the exact count of rows it found,
a device scalar, which may exceed the pad: the caller audits it.

The neighbour searches build (N, N) candidate matrices, as JAX's do
(QM9-scale batches; a few hundred MB at N ~ 12k).  The triplet and pair
tables do not: they expand each edge's incoming edges from a stable sort of
the edges by destination, O(E log E + T), where JAX masks an (E, E) matrix.
"""

from __future__ import annotations

import torch


def compact(sel: torch.Tensor, pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions (pad,) int64 of the first ``pad`` True entries of the 1-D
    ``sel`` in order, 0 past them; the count of True entries, a device
    scalar).  Each kept entry is written once, to its rank; the rest go to
    a discarded slot."""
    rank = torch.cumsum(sel, 0) - 1
    slot = torch.where(sel & (rank < pad), rank, pad)
    out = torch.zeros(pad + 1, dtype=torch.int64, device=sel.device)
    out.scatter_(0, slot, torch.arange(sel.numel(), device=sel.device))
    return out[:pad], rank[-1] + 1


def row_mask(count: torch.Tensor, pad: int, device) -> torch.Tensor:
    """(pad,) float 0/1: 1 on the first ``count`` rows."""
    return (torch.arange(pad, device=device) < count).to(torch.float32)


def pair_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances of the rows of (..., 3) ``a`` and ``b``, summed as
    ((dx*dx + dy*dy) + dz*dz), the host builders' f32 order."""
    d = a - b
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _pair_candidates(pos, node_graph, node_mask) -> tuple[torch.Tensor, torch.Tensor]:
    """(squared distances (N, N), same-graph pairs of valid nodes (N, N))."""
    d2 = pair_sq_dist(pos[:, None, :], pos[None, :, :])
    valid = node_mask > 0
    cand = valid[:, None] & valid[None, :] & (node_graph[:, None] == node_graph[None, :])
    return d2, cand


def threshold(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``like``'s dtype and device: a comparison
    with it runs in that dtype, as numpy compares a float32 array with a
    Python float."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def radius_edges(pos, node_graph, node_mask, cutoff: float, e_pad: int,
                 max_num_neighbors: int = 1000, include_self: bool = False):
    """Radius graph over a padded node set: (src = query, dst = source,
    mask, count), the index arrays (e_pad,) int32, source-major (by (dst,
    src): the host batches' order of the QM9 and PDBbind global edges; JAX
    lists the same edges query-major).  The cap keeps each query's first
    ``max_num_neighbors`` sources by index."""
    n = pos.shape[0]
    d2, cand = _pair_candidates(pos, node_graph, node_mask)
    cand &= d2 <= threshold(cutoff * cutoff, d2)
    if not include_self:
        cand &= ~torch.eye(n, dtype=torch.bool, device=pos.device)
    if max_num_neighbors < n:
        cand &= torch.cumsum(cand, dim=1) <= max_num_neighbors
    pick, count = compact(cand.t().contiguous().reshape(-1), e_pad)
    src, dst = (pick % n).to(torch.int32), (pick // n).to(torch.int32)
    return src, dst, row_mask(count, e_pad, pos.device), count


def knn_edges(pos, node_graph, node_mask, k: int):
    """k-nearest-neighbour graph, self included, ties by index: (src =
    query, dst = neighbour, mask, count), each of N*min(k, N) rows, query-major,
    each query's neighbours by distance (JAX ``knn_edges``)."""
    n = pos.shape[0]
    d2, cand = _pair_candidates(pos, node_graph, node_mask)
    keyed = torch.where(cand, d2, torch.inf)
    sorted_d, sorted_idx = torch.sort(keyed, dim=1, stable=True)
    kk = min(k, n)
    q = torch.arange(n, device=pos.device, dtype=torch.int32).repeat_interleave(kk)
    s = sorted_idx[:, :kk].reshape(-1).to(torch.int32)
    keep = torch.isfinite(sorted_d[:, :kk]).reshape(-1) & (node_mask[q.long()] > 0)
    return q, s, keep.to(torch.float32), keep.sum()


def _expand(el_src, el_dst, el_mask, anchor, exclude, t_pad: int):
    """Every (e, e') with e and e' valid local edges, dst[e'] == anchor[e]
    and src[e'] != exclude[e], e-major and e' in index order (the order of
    JAX's ``jnp.nonzero`` over its (E, E) mask), compacted into ``t_pad``
    rows: (outer e, inner e', mask, count).  The incoming edges of each
    node are a range of the edges stably sorted by dst; each e lists its
    anchor's range, ``t_pad + E`` candidates at most before the exclusion
    (each e excludes at most one e' of a graph without repeated edges)."""
    e = el_dst.shape[0]
    dev = el_dst.device
    valid = el_mask > 0
    key = torch.where(valid, el_dst.long(), torch.iinfo(torch.int64).max)
    key_sorted, in_edges = torch.sort(key, stable=True)
    anchor = anchor.long()
    lo = torch.searchsorted(key_sorted, anchor)
    cnt = torch.where(valid, torch.searchsorted(key_sorted, anchor, right=True) - lo, 0)
    ends = torch.cumsum(cnt, 0)
    c_pad = t_pad + e
    p = torch.arange(c_pad, device=dev)
    outer = torch.searchsorted(ends, p, right=True).clamp_max(e - 1)
    inner = in_edges[(lo[outer] + p - (ends[outer] - cnt[outer])).clamp(0, e - 1)]
    cand = (p < ends[-1]) & (el_src[inner] != exclude[outer])
    pick, count = compact(cand, t_pad)
    real = torch.arange(t_pad, device=dev) < count
    ji = torch.where(real, outer[pick], 0).to(torch.int32)
    other = torch.where(real, inner[pick], 0).to(torch.int32)
    # Past its candidates' pad the count is a lower bound: report the pad
    # passed whenever the candidates did not fit.
    count = torch.where(ends[-1] > c_pad, torch.maximum(count, ends[-1] - e), count)
    return ji, other, real.to(torch.float32), count


def _rows(ids, idx, mask):
    """``ids[idx]`` on the valid rows, 0 on the padded ones (the host
    batches' padding; JAX's tables read ``ids[0]`` there)."""
    return torch.where(mask > 0, ids[idx.long()], 0)


def device_triplets(el_src, el_dst, el_mask, t_pad: int) -> dict:
    """Two-hop triplets of a padded local edge list: for each edge e = (j -> i),
    every edge e' = (k -> j) with k != i (reference: models.py:74-84), e-major,
    (t_pad,) each, and ``count``."""
    ji, kj, mask, count = _expand(el_src, el_dst, el_mask, el_src, el_dst, t_pad)
    return {"idx_i": _rows(el_dst, ji, mask), "idx_j": _rows(el_src, ji, mask),
            "idx_k": _rows(el_src, kj, mask), "idx_kj": kj, "idx_ji": ji, "mask": mask,
            "count": count}


def device_pairs(el_src, el_dst, el_mask, t_pad: int) -> dict:
    """One-hop pairs: for each edge e = (i -> j1), every edge e'' = (j2 -> j1)
    with j2 != j1, e itself included (reference: models.py:85-97), and
    ``count``."""
    ji, jj, mask, count = _expand(el_src, el_dst, el_mask, el_dst, el_dst, t_pad)
    return {"idx_i": _rows(el_src, ji, mask), "idx_j1": _rows(el_dst, ji, mask),
            "idx_j2": _rows(el_src, jj, mask), "idx_jj": jj, "idx_ji": ji, "mask": mask,
            "count": count}
