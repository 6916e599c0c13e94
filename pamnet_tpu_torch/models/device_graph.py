"""The graph rebuilt from the positions on the device
(``pamnet_tpu/models/device_graph.py``): ``PAMNetConfig.device_graph=True``
routes every forward through ``rebuild_structure``, which replaces a batch's
edges and triplet tables with those of its current positions (the
reference's per-forward construction, models.py:104-162) and drops the
float geometry, which ``models/pamnet.py::derive_geometry`` then computes.

Per dataset, as ``data/batch.py::precompute_structure``:
  * qm9: global = radius(cutoff_g, at most 1,000 neighbours; 500 for
    PAMNet_s); the local edges and their triplets are bond data and stay;
  * pdbbind: global = radius(cutoff_g, 1,000); local = the global edges
    within cutoff_l; triplets and pairs rebuilt from the local edges;
  * rna: knn(50) without self-loops; global and local = its edges within
    cutoff_g / cutoff_l; triplets and pairs rebuilt.
The rebuilt edges keep the host batches' order, so every CSR route of the
kernels stays: global edges dst-major on QM9 and PDBbind, src-major on RNA,
local edges dst-major; the triplet and pair rows by center edge.  The CSR
offsets, and where the batch carried them the backward's permutations,
come from sorts and searches on the device (equal to ``build_perm_np`` of
the same arrays).  The pads are the incoming batch's.

The kernels' wrappers take the batch's valid row counts and longest groups
as host ints (``GraphBatch.valid``, ``longest``): the rebuild reads them,
with the exact counts found, in one device-to-host copy, the step's one
sync, and raises when a count passed its pad (JAX truncates silently).
"""

from __future__ import annotations

import dataclasses

import torch

from pamnet_tpu_torch.data.batch import GraphBatch
from pamnet_tpu_torch.ops import neighbors

KNN_K = 50  # the RNA branch's knn superset (reference: models.py:143)


def csr_offsets(ids: torch.Tensor, count, num_groups: int) -> torch.Tensor:
    """(num_groups+1,) int32 offsets of rows sorted by ``ids`` whose first
    ``count`` rows are valid (``data/batch.py::_offsets``)."""
    rows = torch.arange(ids.shape[0], device=ids.device)
    keyed = torch.where(rows < count, ids.long(), num_groups)
    bounds = torch.arange(num_groups + 1, device=ids.device)
    return torch.searchsorted(keyed, bounds).to(torch.int32)


def csr_perm(ids: torch.Tensor, count, num_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, poff) int32: ``perm`` stable-sorts the first ``count`` rows by
    ``ids`` with the padded rows after them in order, ``poff`` each group's
    range in that order (``data/batch.py::build_perm_np`` on the card)."""
    rows = torch.arange(ids.shape[0], device=ids.device)
    keyed = torch.where(rows < count, ids.long(), num_groups)
    key_sorted, perm = torch.sort(keyed, stable=True)
    bounds = torch.arange(num_groups + 1, device=ids.device)
    return perm.to(torch.int32), torch.searchsorted(key_sorted, bounds).to(torch.int32)


def _longest(off: torch.Tensor) -> torch.Tensor:
    return (off[1:] - off[:-1]).max()


def _sorted_edges(key_major, key_minor, sel, n: int, pad: int):
    """The selected (major, minor) node pairs sorted by (major, minor) into
    ``pad`` rows: (major, minor, mask, count); padded rows point at 0."""
    big = torch.iinfo(torch.int64).max
    key = torch.where(sel, key_major.long() * n + key_minor.long(), big)
    key = torch.sort(key).values[:pad]
    count = sel.sum()
    real = torch.arange(key.shape[0], device=key.device) < count
    key = torch.where(real, key, 0)
    if key.shape[0] < pad:
        key = torch.cat([key, key.new_zeros(pad - key.shape[0])])
    return ((key // n).to(torch.int32), (key % n).to(torch.int32),
            neighbors.row_mask(count, pad, key.device), count)


def _edge_dist_within(pos, src, dst, cutoff: float) -> torch.Tensor:
    """||pos[dst] - pos[src]|| <= cutoff per edge, in f32 as the host
    builders compare (``graphbuild.edge_distances_np``)."""
    d = torch.sqrt(neighbors.pair_sq_dist(torch.index_select(pos, 0, dst),
                                          torch.index_select(pos, 0, src)))
    return d <= neighbors.threshold(cutoff, d)


def rebuild_structure(g: GraphBatch, cfg) -> GraphBatch:
    """``g`` with its graph rebuilt on the device from ``g.pos`` (module
    docstring), at ``g``'s pads, without float geometry."""
    kind = cfg.dataset_kind
    pos, graph, mask = g.pos, g.node_graph, g.node_mask
    n, eg_pad, el_pad = pos.shape[0], g.eg_src.shape[0], g.el_src.shape[0]
    dev = pos.device
    rep: dict = dict(dist_g=None, dist_l=None, sbf_radial=None, cbf2=None, cbf1=None)
    counts: dict = {}  # exact counts found, audited against the pads
    if kind in ("qm9", "pdbbind"):
        max_nb = 500 if cfg.variant == "s" else 1000
        src, dst, eg_mask, counts["eg"] = neighbors.radius_edges(
            pos, graph, mask, cfg.cutoff_g, eg_pad, max_nb)
    elif kind == "rna":
        kq, ks, kmask, _ = neighbors.knn_edges(pos, graph, mask, KNN_K)
        keep = (kmask > 0) & (kq != ks)
        dist = torch.sqrt(neighbors.pair_sq_dist(torch.index_select(pos, 0, ks),
                                                 torch.index_select(pos, 0, kq)))
        src, dst, eg_mask, counts["eg"] = _sorted_edges(
            kq, ks, keep & (dist <= neighbors.threshold(cfg.cutoff_g, dist)), n, eg_pad)
        # Local edges dst-major: sort by (dst, src), then swap back.
        el_dst, el_src, el_mask, counts["el"] = _sorted_edges(
            ks, kq, keep & (dist <= neighbors.threshold(cfg.cutoff_l, dist)), n, el_pad)
    else:
        raise ValueError(f"unknown dataset kind: {kind}")
    rep.update(eg_src=src, eg_dst=dst, eg_mask=eg_mask)
    if kind == "pdbbind":
        # The dst-major global edges filtered keep their order.
        sel = (eg_mask > 0) & _edge_dist_within(pos, src, dst, cfg.cutoff_l)
        pick, counts["el"] = neighbors.compact(sel, el_pad)
        el_mask = neighbors.row_mask(counts["el"], el_pad, dev)
        el_src = torch.where(el_mask > 0, src[pick], 0)
        el_dst = torch.where(el_mask > 0, dst[pick], 0)
    if kind != "qm9":
        rep.update(el_src=el_src, el_dst=el_dst, el_mask=el_mask)
        t1 = neighbors.device_pairs(el_src, el_dst, el_mask, g.t1_ji.shape[0])
        counts["t1"] = t1["count"]
        rep.update(t1_i=t1["idx_i"], t1_j1=t1["idx_j1"], t1_j2=t1["idx_j2"],
                   t1_jj=t1["idx_jj"], t1_ji=t1["idx_ji"], t1_mask=t1["mask"])
        if cfg.variant == "full":
            t2 = neighbors.device_triplets(el_src, el_dst, el_mask, g.t2_ji.shape[0])
            counts["t2"] = t2["count"]
            rep.update(t2_i=t2["idx_i"], t2_j=t2["idx_j"], t2_k=t2["idx_k"],
                       t2_kj=t2["idx_kj"], t2_ji=t2["idx_ji"], t2_mask=t2["mask"])
    return _with_csrs(dataclasses.replace(g, **rep), counts, kind)


def _with_csrs(g: GraphBatch, counts: dict, kind: str) -> GraphBatch:
    """Rebuild the CSRs of the rebuilt rows (``counts`` names them), read
    the counts and longest groups to the host in one copy and audit them."""
    n = g.pos.shape[0]
    sorted_key = "eg_src" if kind == "rna" else "eg_dst"
    other_key = "eg_dst" if kind == "rna" else "eg_src"
    # (key, rows' dim, groups) of every CSR over rebuilt rows.
    offs = {sorted_key: ("eg", n)}
    perms = {other_key: ("eg", n)}
    if "el" in counts:
        el_pad = g.el_src.shape[0]
        offs.update(el_dst=("el", n), t1_ji=("t1", el_pad))
        perms.update(el_src=("el", n), t1_jj=("t1", el_pad))
        if "t2" in counts:
            offs["t2_ji"] = ("t2", el_pad)
            perms["t2_kj"] = ("t2", el_pad)
    new_off = {k: csr_offsets(getattr(g, k), counts[dim], groups)
               for k, (dim, groups) in offs.items()}
    new_perms = dict(g.perms)
    for k, (dim, groups) in perms.items():
        if k + "_perm" in g.perms:
            new_perms[k + "_perm"], new_perms[k + "_poff"] = csr_perm(
                getattr(g, k), counts[dim], groups)
    if "t2_kj_perm" in g.perms and "t2" in counts:
        new_perms["t2_ji_by_kj"] = g.t2_ji[new_perms["t2_kj_perm"].long()]
    if "t1_jj_perm" in g.perms and "t1" in counts:
        new_perms["t1_ji_by_jj"] = g.t1_ji[new_perms["t1_jj_perm"].long()]
    longest_of = {k: _longest(v) for k, v in new_off.items()}
    longest_of.update({k: _longest(new_perms[k + "_poff"]) for k in perms
                       if k + "_perm" in g.perms})
    names = list(counts) + list(longest_of)
    host = torch.stack([v.long() for v in (*counts.values(), *longest_of.values())]).tolist()  # the one sync
    read = dict(zip(names, host))
    pads = {"eg": g.eg_src.shape[0], "el": g.el_src.shape[0], "t2": g.t2_ji.shape[0],
            "t1": g.t1_ji.shape[0]}
    over = {d: (read[d], pads[d]) for d in counts if read[d] > pads[d]}
    if over:
        raise ValueError(f"the rebuilt graph outgrew the batch's pads (count, pad): {over}")
    return dataclasses.replace(
        g, **{k + "_off": v for k, v in new_off.items()},
        **({"eg_dst_off": None} if kind == "rna" else {"eg_src_off": None}),
        perms=new_perms,
        valid={**g.valid, **{d: read[d] for d in counts}},
        longest={**g.longest, **{k: read[k] for k in longest_of}})


def structure_counts_device(g: GraphBatch, cfg) -> dict:
    """Structure counts of the current positions (``pamnet_tpu/models/
    device_graph.py:115``), device scalars: ``eg``, and ``el`` (QM9: the
    batch's bond edges).  On RNA the counts take the 50 nearest other
    nodes and every node tied with the 50th: a bound on the knn(50)
    superset, as JAX's."""
    kind = cfg.dataset_kind
    pos = g.pos
    n = pos.shape[0]
    d2, cand = neighbors._pair_candidates(pos, g.node_graph, g.node_mask)
    cand &= ~torch.eye(n, dtype=torch.bool, device=pos.device)
    within = lambda c: d2 <= neighbors.threshold(c * c, d2)  # noqa: E731
    if kind == "rna":
        keyed = torch.where(cand, d2, torch.inf)
        kth = torch.sort(keyed, dim=1).values[:, KNN_K - 1:KNN_K]
        cand &= keyed <= kth
    counts = {"eg": (cand & within(cfg.cutoff_g)).sum()}
    counts["el"] = ((g.el_mask > 0).sum() if kind == "qm9"
                    else (cand & within(cfg.cutoff_l)).sum())
    return counts
