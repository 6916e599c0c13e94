"""The reference's graphs and geometry, rebuilt from the positions in plain
PyTorch (reference: models.py:63-162 and layers/basic.py:79-116 of the
published PAMNet code, as the JAX package documents them):

* QM9: local edges = the molecule's bonds (both directions, self-loops
  dropped); global edges = every pair of atoms of one molecule within
  ``cutoff_g``.
* RNA: each atom's 50 nearest atoms (itself included, distance ties broken
  by index, float64 distances) as (query, neighbour) edges, self-loops
  dropped; global = those within ``cutoff_g``, local = those within
  ``cutoff_l``.
* An edge is (src, dst); a two-hop triplet of edge e = (j -> i) is every
  edge (k -> j) with k != i (``kj``, ``ji``); a one-hop pair of edge
  e = (i -> j1) is every edge (j2 -> j1), e itself included (``jj``,
  ``ji``).
* The cutoffs compare float32 distances from float32 positions with the
  cutoff in float32, as a float32 program reads them; the geometry that the
  model reads (distances, the radial table, the angular terms) is computed
  in float64 and rounded once to float32.

Rows are in no particular order: every sum of the model is an
``index_add_``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.bessel import basis_tables, sph_jn_t

KNN = 50


def _f32_dist(pos: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    d = pos[dst] - pos[src]
    return torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])


def _within(pos32: torch.Tensor, src, dst, cutoff: float) -> torch.Tensor:
    return _f32_dist(pos32, src, dst) <= torch.tensor(cutoff, dtype=torch.float32)


def _radius_pairs(pos32: torch.Tensor, cutoff: float) -> tuple[torch.Tensor, torch.Tensor]:
    n = pos32.shape[0]
    q, s = torch.meshgrid(torch.arange(n, device=pos32.device),
                          torch.arange(n, device=pos32.device), indexing="ij")
    q, s = q.reshape(-1), s.reshape(-1)
    d = pos32[q] - pos32[s]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    keep = (d2 <= torch.tensor(cutoff * cutoff, dtype=torch.float32)) & (q != s)
    return q[keep], s[keep]


def _knn_pairs(pos32: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    p = pos32.double()
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    kk = min(k, p.shape[0])
    nbrs = torch.sort(d2, dim=1, stable=True).indices[:, :kk]
    q = torch.arange(p.shape[0], device=p.device).repeat_interleave(kk)
    s = nbrs.reshape(-1)
    keep = q != s
    return q[keep], s[keep]


def _incoming(src: torch.Tensor, dst: torch.Tensor, num_nodes: int, anchor: torch.Tensor):
    """(outer, inner): for each edge e, every edge e' with dst[e'] == anchor[e]."""
    order = torch.argsort(dst, stable=True)
    counts_in = torch.bincount(dst, minlength=num_nodes)
    offsets = torch.zeros(num_nodes + 1, dtype=torch.long, device=dst.device)
    offsets[1:] = torch.cumsum(counts_in, 0)
    counts = counts_in[anchor]
    outer = torch.arange(src.shape[0], device=src.device).repeat_interleave(counts)
    starts = offsets[anchor].repeat_interleave(counts)
    within = torch.arange(outer.shape[0], device=src.device) - (
        torch.cumsum(counts, 0) - counts).repeat_interleave(counts)
    return outer, order[starts + within]


def _angle(pos: torch.Tensor, a, b, c) -> torch.Tensor:
    v1 = pos[b] - pos[a]
    v2 = pos[c] - pos[b]
    return torch.atan2(torch.linalg.cross(v1, v2, dim=-1).norm(dim=-1), (v1 * v2).sum(-1))


def _legendre(angle: torch.Tensor, ns: int, pref: torch.Tensor) -> torch.Tensor:
    c = torch.cos(angle)
    polys = [torch.ones_like(c), c]
    for l in range(2, ns):
        polys.append(((2 * l - 1) * c * polys[l - 1] - (l - 1) * polys[l - 2]) / l)
    return torch.stack(polys[:ns], -1) * pref


def _envelope(x: torch.Tensor, p: int) -> torch.Tensor:
    a, b, c = -(p + 1) * (p + 2) / 2.0, p * (p + 2), -p * (p + 1) / 2.0
    return torch.where(x < 1.0, 1.0 / x + a * x**p + b * x ** (p + 1) + c * x ** (p + 2),
                       torch.zeros_like(x))


def build(mols: list[dict], cfg: dict, device) -> dict:
    """The batch of ``mols`` (dicts of ``z``, ``pos``, ``y`` and, for QM9,
    the bond ``edge_index``) as the reference reads it: node and edge index
    tensors, the triplets and pairs, the float32 geometry, ``y`` and the
    graph of each node."""
    kind = cfg["kind"]
    ns, nr = cfg["num_spherical"], cfg["num_radial"]
    pos_l, z_l, graph_l, eg_l, el_l = [], [], [], [], []
    base = 0
    for g, m in enumerate(mols):
        pos32 = torch.as_tensor(np.asarray(m["pos"], np.float32), device=device)
        n = pos32.shape[0]
        if kind == "qm9":
            q, s = _radius_pairs(pos32, cfg["cutoff_g"])
            eg = torch.stack([q, s])
            bonds = torch.as_tensor(np.asarray(m["edge_index"]), device=device).long()
            el = bonds[:, bonds[0] != bonds[1]]
        elif kind == "rna":
            q, s = _knn_pairs(pos32, KNN)
            eg = torch.stack([q, s])[:, _within(pos32, q, s, cfg["cutoff_g"])]
            el = torch.stack([q, s])[:, _within(pos32, q, s, cfg["cutoff_l"])]
        else:
            raise ValueError(f"no reference graph for kind {kind!r}")
        pos_l.append(pos32)
        z_l.append(torch.as_tensor(np.asarray(m["z"]), device=device).long())
        graph_l.append(torch.full((n,), g, dtype=torch.long, device=device))
        eg_l.append(eg + base)
        el_l.append(el + base)
        base += n
    pos32 = torch.cat(pos_l)
    pos = pos32.double()
    n = pos.shape[0]
    eg, el = torch.cat(eg_l, 1), torch.cat(el_l, 1)
    src, dst = el[0], el[1]
    outer, inner = _incoming(src, dst, n, src)
    keep = dst[outer] != src[inner]
    t2 = dict(i=dst[outer][keep], j=src[outer][keep], k=src[inner][keep],
              kj=inner[keep], ji=outer[keep])
    outer, inner = _incoming(src, dst, n, dst)
    t1 = dict(i=src[outer], j1=dst[outer], j2=src[inner], jj=inner, ji=outer)

    tables = basis_tables(ns, nr)
    zeros = torch.as_tensor(tables["zeros"], device=device)
    norm = torch.as_tensor(tables["norm"], device=device)
    pref = torch.as_tensor(tables["sph_pref"], device=device)
    dist_l = (pos[dst] - pos[src]).norm(dim=-1)
    x = dist_l / cfg["cutoff_l"]
    radial = torch.stack([norm[l, k] * sph_jn_t(l, zeros[l, k] * x)
                          for l in range(ns) for k in range(nr)], -1)
    radial = radial * _envelope(x, cfg["envelope_exponent"])[:, None]
    return dict(
        z=torch.cat(z_l), node_graph=torch.cat(graph_l), num_graphs=len(mols),
        eg_src=eg[0], eg_dst=eg[1], el_src=src, el_dst=dst, t2=t2, t1=t1,
        dist_g=(pos[eg[1]] - pos[eg[0]]).norm(dim=-1).float(), dist_l=dist_l.float(),
        sbf_radial=radial.float(),
        cbf2=_legendre(_angle(pos, t2["i"], t2["j"], t2["k"]), ns, pref).float(),
        cbf1=_legendre(_angle(pos, t1["i"], t1["j1"], t1["j2"]), ns, pref).float(),
        y=torch.tensor([float(m.get("y", 0.0)) for m in mols], dtype=torch.float32, device=device),
        counts=dict(n=n, eg=eg.shape[1], el=el.shape[1], t2=t2["ji"].shape[0],
                    t1=t1["ji"].shape[0], g=len(mols)),
    )
