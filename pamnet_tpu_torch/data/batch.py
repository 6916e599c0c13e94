"""Padded graph batches for the port.

Builds the same batches as ``pamnet_tpu.data.batch.collate_structures(...,
build_tables=False)`` on its numpy path: per-structure graph structure and
host float64 geometry, concatenated with node/edge offsets and padded to a
bucket.  Every aggregation of the model reads the CSR offsets carried here
(``eg_src_off``/``eg_dst_off``, ``el_dst_off``, ``t2_ji_off``,
``t1_ji_off``), so rows must stay sorted by their aggregation key.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pamnet_tpu_torch.data import graphbuild
from pamnet_tpu_torch.ops.bessel import bessel_basis_tables, sph_jn


@dataclasses.dataclass
class GraphBatch:
    """A padded multi-graph batch of tensors.  Masks are float 0/1; padded
    index entries point at slot 0.  ``*_off`` fields are (groups+1,) int32
    CSR offsets over rows sorted by that key, or None when the rows are not
    sorted by it.  ``num_graphs`` counts the real (unpadded) graphs and
    ``valid`` the real rows of each padded dimension ("n", "eg", "el", "t2",
    "t1"), host ints that the kernels' wrappers check against."""

    z: torch.Tensor
    pos: torch.Tensor
    node_mask: torch.Tensor
    node_graph: torch.Tensor
    eg_src: torch.Tensor
    eg_dst: torch.Tensor
    eg_mask: torch.Tensor
    el_src: torch.Tensor
    el_dst: torch.Tensor
    el_mask: torch.Tensor
    t2_i: torch.Tensor
    t2_j: torch.Tensor
    t2_k: torch.Tensor
    t2_kj: torch.Tensor
    t2_ji: torch.Tensor
    t2_mask: torch.Tensor
    t1_i: torch.Tensor
    t1_j1: torch.Tensor
    t1_j2: torch.Tensor
    t1_jj: torch.Tensor
    t1_ji: torch.Tensor
    t1_mask: torch.Tensor
    y: torch.Tensor
    graph_mask: torch.Tensor
    dist_g: torch.Tensor
    dist_l: torch.Tensor
    sbf_radial: torch.Tensor
    cbf2: torch.Tensor
    cbf1: torch.Tensor
    eg_src_off: torch.Tensor | None
    eg_dst_off: torch.Tensor | None
    el_dst_off: torch.Tensor | None
    t2_ji_off: torch.Tensor | None
    t1_ji_off: torch.Tensor | None
    num_graphs: int
    valid: dict[str, int]

    def to(self, device) -> "GraphBatch":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


@dataclasses.dataclass(frozen=True)
class PadSizes:
    """Padded row counts of one batch bucket."""

    n: int
    eg: int
    el: int
    t2: int
    t1: int
    g: int

    @staticmethod
    def round_up(x: int, align: int = 128) -> int:
        return max(align, int(math.ceil(x / align)) * align)

    @classmethod
    def for_counts(cls, n, eg, el, t2, t1, g, align: int = 128) -> "PadSizes":
        r = cls.round_up
        return cls(r(n, align), r(eg, align), r(el, align), r(t2, align),
                   r(t1, align), max(8, g))

    @classmethod
    def bucketed(cls, n, eg, el, t2, t1, g, align: int = 128,
                 growth: float = 1.5) -> "PadSizes":
        """Geometric ladder: each dimension padded up to align * growth^k, so
        the set of batch shapes stays O(log sizes)."""

        def bucket(x):
            size = align
            while size < x:
                size = int(math.ceil(size * growth / align)) * align
            return size

        return cls(bucket(n), bucket(eg), bucket(el), bucket(t2), bucket(t1),
                   max(8, g))


def precompute_structure(mol: dict, dataset_kind: str, cutoff_l: float,
                         cutoff_g: float) -> dict:
    """One RNA structure's graph (reference: models.py:138-162): knn(50)
    superset, global edges within ``cutoff_g``, local edges within
    ``cutoff_l``, two-hop triplets and one-hop pairs on the local edges.
    Global edges are sorted src-major (the RNA global layer aggregates at
    src), local edges dst-major."""
    if dataset_kind != "rna":
        raise NotImplementedError(
            f"dataset kind {dataset_kind!r}: the port builds RNA graphs only"
        )
    pos = np.asarray(mol["pos"], np.float32)
    n = pos.shape[0]
    eknn = graphbuild.remove_self_loops_np(graphbuild.knn_graph_np(pos, 50))
    dist_knn = graphbuild.edge_distances_np(eknn, pos)
    eg = eknn[:, dist_knn <= cutoff_g]
    el = eknn[:, dist_knn <= cutoff_l]
    eg = eg[:, np.lexsort((eg[1], eg[0]))]
    el = el[:, np.lexsort((el[0], el[1]))]
    p64 = pos.astype(np.float64)
    return {
        "pos": pos,
        "z": np.asarray(mol["z"], np.int32),
        "y": np.float32(mol["y"]),
        "eg": np.ascontiguousarray(eg, np.int32),
        "el": np.ascontiguousarray(el, np.int32),
        "t2": graphbuild.triplets_np(el, n),
        "t1": graphbuild.pairs_np(el, n),
        "dist_g": np.sqrt(((p64[eg[1]] - p64[eg[0]]) ** 2).sum(-1)).astype(np.float32),
        "dist_l": np.sqrt(((p64[el[1]] - p64[el[0]]) ** 2).sum(-1)).astype(np.float32),
    }


def attach_basis(s: dict, cutoff_l: float, num_spherical: int = 7,
                 num_radial: int = 6, envelope_exponent: int = 5) -> dict:
    """Host float64 spherical basis of one structure: ``sbf_radial``
    (el, ns*nr), ``cbf2`` (t2, ns), ``cbf1`` (t1, ns) (reference math:
    layers/basic.py:79-116).  Geometry only, no trainable parameter."""
    t = bessel_basis_tables(num_spherical, num_radial)
    pos = s["pos"].astype(np.float64)
    src, dst = s["el"]
    dist = np.sqrt(((pos[dst] - pos[src]) ** 2).sum(-1))
    x = dist / cutoff_l
    p = envelope_exponent
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    env = np.where(x < 1.0, 1.0 / np.maximum(x, 1e-12) + a * x**p
                   + b * x ** (p + 1) + c * x ** (p + 2), 0.0)
    rad = np.zeros((len(dist), num_spherical, num_radial))
    for l in range(num_spherical):
        for n in range(num_radial):
            rad[:, l, n] = t["norm"][l, n] * sph_jn(
                l, np.maximum(t["zeros"][l, n] * x, 1e-12)
            )
    rad *= env[:, None, None]
    s["sbf_radial"] = rad.reshape(
        len(dist), num_spherical * num_radial
    ).astype(np.float32)

    def cbf(tbl, a_idx, b_idx, c_idx):
        v1 = pos[tbl[b_idx]] - pos[tbl[a_idx]]
        v2 = pos[tbl[c_idx]] - pos[tbl[b_idx]]
        dot = (v1 * v2).sum(-1)
        cr = np.linalg.norm(np.cross(v1, v2), axis=-1)
        cth = np.cos(np.arctan2(cr, dot))
        polys = [np.ones_like(cth)]
        if num_spherical > 1:
            polys.append(cth)
        for l in range(2, num_spherical):
            polys.append(((2 * l - 1) * cth * polys[l - 1] - (l - 1) * polys[l - 2]) / l)
        return (np.stack(polys, -1) * t["sph_pref"]).astype(np.float32)

    s["cbf2"] = (
        cbf(s["t2"], "idx_i", "idx_j", "idx_k")
        if s["t2"]["idx_ji"].size
        else np.zeros((0, num_spherical), np.float32)
    )
    s["cbf1"] = cbf(s["t1"], "idx_i", "idx_j1", "idx_j2")
    return s


def structure_counts(s: dict) -> tuple[int, int, int, int, int]:
    """(nodes, global edges, local edges, triplets, pairs) of one structure."""
    return (s["pos"].shape[0], s["eg"].shape[1], s["el"].shape[1],
            s["t2"]["idx_ji"].shape[0], s["t1"]["idx_ji"].shape[0])


def _pad1(a: np.ndarray, size: int) -> np.ndarray:
    if a.shape[0] > size:
        raise ValueError(
            f"padding overflow: have {a.shape[0]} rows, bucket holds {size}"
        )
    out = np.zeros((size,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _mask(count: int, size: int) -> np.ndarray:
    m = np.zeros(size, dtype=np.float32)
    m[:count] = 1.0
    return m


def _offsets(ids: np.ndarray, num_valid: int, num_groups: int) -> np.ndarray | None:
    """(groups+1,) int32 CSR offsets of rows sorted by ``ids``, or None when
    the first ``num_valid`` rows are not sorted."""
    ids = ids[:num_valid]
    if num_valid and np.any(np.diff(ids) < 0):
        return None
    return np.searchsorted(ids, np.arange(num_groups + 1)).astype(np.int32)


# (field, path into the structure dict, offset kind, pad dim); offsets:
# "node" adds the per-graph node offset, "edge" the local-edge offset.
_INT_FIELDS = (
    ("z", ("z",), "zero", "n"),
    ("eg_src", ("eg", 0), "node", "eg"),
    ("eg_dst", ("eg", 1), "node", "eg"),
    ("el_src", ("el", 0), "node", "el"),
    ("el_dst", ("el", 1), "node", "el"),
    ("t2_i", ("t2", "idx_i"), "node", "t2"),
    ("t2_j", ("t2", "idx_j"), "node", "t2"),
    ("t2_k", ("t2", "idx_k"), "node", "t2"),
    ("t2_kj", ("t2", "idx_kj"), "edge", "t2"),
    ("t2_ji", ("t2", "idx_ji"), "edge", "t2"),
    ("t1_i", ("t1", "idx_i"), "node", "t1"),
    ("t1_j1", ("t1", "idx_j1"), "node", "t1"),
    ("t1_j2", ("t1", "idx_j2"), "node", "t1"),
    ("t1_jj", ("t1", "idx_jj"), "edge", "t1"),
    ("t1_ji", ("t1", "idx_ji"), "edge", "t1"),
)
_F32_FIELDS = (("pos", "n"), ("dist_g", "eg"), ("dist_l", "el"),
               ("sbf_radial", "el"), ("cbf2", "t2"), ("cbf1", "t1"))


def collate_structures(structs: list[dict], pads: PadSizes | None = None,
                       align: int = 128) -> GraphBatch:
    """Concatenate structures (with ``attach_basis`` applied) into one padded
    batch, offsetting node ids by node counts and edge ids by local-edge
    counts; pads default to the geometric bucket of the batch's counts."""
    nb = len(structs)
    n_per = np.array([s["pos"].shape[0] for s in structs], np.int64)
    el_per = np.array([s["el"].shape[1] for s in structs], np.int64)
    n_eg = int(sum(s["eg"].shape[1] for s in structs))
    n_t2 = int(sum(s["t2"]["idx_ji"].shape[0] for s in structs))
    n_t1 = int(sum(s["t1"]["idx_ji"].shape[0] for s in structs))
    num_nodes, n_el = int(n_per.sum()), int(el_per.sum())
    offs_of = {
        "node": np.concatenate([[0], np.cumsum(n_per[:-1])]).astype(np.int32),
        "edge": np.concatenate([[0], np.cumsum(el_per[:-1])]).astype(np.int32),
        "zero": np.zeros(nb, np.int32),
    }
    if pads is None:
        pads = PadSizes.bucketed(num_nodes, n_eg, n_el, max(n_t2, 1),
                                 max(n_t1, 1), nb, align=align)
    pad_of = {"n": pads.n, "eg": pads.eg, "el": pads.el, "t2": pads.t2,
              "t1": pads.t1}

    f: dict[str, np.ndarray] = {}
    for key, path, okind, pdim in _INT_FIELDS:
        parts = []
        for s, o in zip(structs, offs_of[okind]):
            v = s
            for p in path:
                v = v[p]
            parts.append(v.astype(np.int32) + o)
        f[key] = _pad1(np.concatenate(parts), pad_of[pdim])
    for key, pdim in _F32_FIELDS:
        f[key] = _pad1(np.concatenate([s[key] for s in structs]).astype(np.float32),
                       pad_of[pdim])

    # The global layer reads whichever endpoint the edges are sorted by.
    eg_dst_off = _offsets(f["eg_dst"], n_eg, pads.n)
    eg_src_off = None if eg_dst_off is not None else _offsets(f["eg_src"], n_eg, pads.n)
    y = np.array([s["y"] for s in structs], dtype=np.float32)
    node_graph = np.repeat(np.arange(nb, dtype=np.int32), n_per)

    t = torch.from_numpy
    opt = lambda a: None if a is None else t(a)  # noqa: E731
    return GraphBatch(
        **{k: t(v) for k, v in f.items()},
        node_mask=t(_mask(num_nodes, pads.n)),
        node_graph=t(_pad1(node_graph, pads.n)),
        eg_mask=t(_mask(n_eg, pads.eg)),
        el_mask=t(_mask(n_el, pads.el)),
        t2_mask=t(_mask(n_t2, pads.t2)),
        t1_mask=t(_mask(n_t1, pads.t1)),
        y=t(_pad1(y, pads.g)),
        graph_mask=t(_mask(nb, pads.g)),
        eg_src_off=opt(eg_src_off),
        eg_dst_off=opt(eg_dst_off),
        el_dst_off=opt(_offsets(f["el_dst"], n_el, pads.n)),
        t2_ji_off=opt(_offsets(f["t2_ji"], n_t2, pads.el)),
        t1_ji_off=opt(_offsets(f["t1_ji"], n_t1, pads.el)),
        num_graphs=nb,
        valid={"n": num_nodes, "eg": n_eg, "el": n_el, "t2": n_t2, "t1": n_t1},
    )
