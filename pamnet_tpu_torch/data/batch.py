"""Padded graph batches for the port.

Builds the same batches as ``pamnet_tpu.data.batch.collate_structures(...,
build_tables=False)`` on its numpy path: per-structure graph structure and
host float64 geometry (QM9, PDBbind with its (N, 18) ``feat``, RNA; PAMNet_s
without triplets), concatenated with node/edge offsets and padded to a
bucket.  With ``wire_geometry="derive"`` a batch carries positions and
integer tables only, and the model derives distances and the spherical
basis on the device (``models/pamnet.py::derive_geometry``).  Every aggregation of the model reads the CSR offsets carried here
(``eg_src_off``/``eg_dst_off``, ``el_dst_off``, ``t2_ji_off``,
``t1_ji_off``), so rows must stay sorted by their aggregation key.

With ``build_perms=True`` (training) a batch also carries, in ``perms``, the
CSR of every index whose gather has a backward and whose rows are not sorted
by it: a permutation that stable-sorts the valid rows by the index, padded
rows parked at its end (``<key>_perm``), and its offsets (``<key>_poff``,
last entry = valid rows).  ``el_src``, ``t2_kj`` and ``t1_jj`` are the
arrays of JAX's ``collate_structures(build_perms=True)``, bit for bit; the
port adds the unsorted global endpoint, ``z`` (the embedding's backward;
none for PDBbind, which embeds no atom type) and
``t2_ji_by_kj`` = ``t2_ji[t2_kj_perm]`` / ``t1_ji_by_jj``, the rows the
triplet sums' backward reads through the permutation.

The CSR offsets and the permutations come from the native library
(``native.csr_offsets``, ``native.csr_perm``), bit for bit ``_offsets`` and
``build_perm_np``, the numpy reference they are held to.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pamnet_tpu_torch.data import graphbuild, native
from pamnet_tpu_torch.ops.bessel import bessel_basis_tables, sph_jn
from pamnet_tpu_torch.ops.triplet import AggregateGrad, Groups
from pamnet_tpu_torch.profiling import span

# Which padded dimension each grouping key indexes rows of.
_ROWS_OF = {"z": "n", "eg_src": "eg", "eg_dst": "eg", "el_src": "el",
            "el_dst": "el", "t2_kj": "t2", "t1_jj": "t1", "t2_ji": "t2", "t1_ji": "t1"}


@dataclasses.dataclass
class GraphBatch:
    """A padded multi-graph batch of tensors.  Masks are float 0/1; padded
    index entries point at slot 0.  ``*_off`` fields are (groups+1,) int32
    CSR offsets over rows sorted by that key, or None when the rows are not
    sorted by it.  ``num_graphs`` counts the real (unpadded) graphs and
    ``valid`` the real rows of each padded dimension ("n", "eg", "el", "t2",
    "t1"), host ints that the kernels' wrappers check against.  The float
    geometry (``dist_g``, ``dist_l``, ``sbf_radial``, ``cbf2``, ``cbf1``) is
    None where the batch leaves it to the model (derive geometry, or no
    host basis).  ``feat``
    holds the atom features, (N, 18) on PDBbind and (N, 0) otherwise.  ``perms``
    holds the backward's CSR arrays (module docstring), empty unless the
    batch was built with ``build_perms=True``.  ``longest`` holds the most
    rows of a group of each CSR the batch carries, by its key ("z",
    "eg_src", "t2_ji", ...), a host int that picks ``group_sum``'s kernel."""

    z: torch.Tensor
    pos: torch.Tensor
    feat: torch.Tensor
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
    dist_g: torch.Tensor | None
    dist_l: torch.Tensor | None
    sbf_radial: torch.Tensor | None
    cbf2: torch.Tensor | None
    cbf1: torch.Tensor | None
    eg_src_off: torch.Tensor | None
    eg_dst_off: torch.Tensor | None
    el_dst_off: torch.Tensor | None
    t2_ji_off: torch.Tensor | None
    t1_ji_off: torch.Tensor | None
    num_graphs: int
    valid: dict[str, int]
    perms: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    longest: dict[str, int] = dataclasses.field(default_factory=dict)

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor the batch holds, ``perms`` included."""
        return [v for f in dataclasses.fields(self)
                if isinstance(v := getattr(self, f.name), torch.Tensor)] + list(self.perms.values())

    def map(self, fn) -> "GraphBatch":
        """The batch with ``fn`` applied to each of its tensors, ``perms``
        included (host ints and None fields as they are)."""
        moved = {f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        moved["perms"] = {k: fn(v) for k, v in self.perms.items()}
        return dataclasses.replace(self, **moved)

    def to(self, device) -> "GraphBatch":
        return self.map(lambda t: t.to(device))

    def groups(self, key: str) -> Groups | None:
        """The CSR of index field ``key`` ("z", "eg_src", "el_src", "t2_kj",
        ...): its offsets where the rows are sorted by it, else its
        permutation from ``perms``; None when the batch holds neither."""
        total, longest = self.valid[_ROWS_OF[key]], self.longest.get(key)
        off = getattr(self, key + "_off", None)
        if off is not None:
            return Groups(off, None, total, longest)
        if key + "_perm" in self.perms:
            return Groups(self.perms[key + "_poff"], self.perms[key + "_perm"], total, longest)
        return None

    def triplet_grad(self, kind: str) -> AggregateGrad:
        """The backward arrays of the triplet sum of ``kind`` ("t2" or "t1"):
        rows summed at ``<kind>_ji``, gathered at ``t2_kj`` / ``t1_jj``."""
        idx = "t2_kj" if kind == "t2" else "t1_jj"
        seg_by_idx = self.perms.get("t2_ji_by_kj" if kind == "t2" else "t1_ji_by_jj")
        return AggregateGrad(getattr(self, kind + "_ji"), self.groups(idx), seg_by_idx)


@dataclasses.dataclass(frozen=True)
class PadSizes:
    """Padded row counts of one batch bucket."""

    n: int
    eg: int
    el: int
    t2: int
    t1: int
    g: int

    def widened(self, other: "PadSizes") -> "PadSizes":
        """The element-wise max of the two buckets."""
        return PadSizes(*map(max, dataclasses.astuple(self), dataclasses.astuple(other)))

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
                         cutoff_g: float, variant: str = "full") -> dict:
    """One structure's graph (reference: models.py:104-162, 263-301), the
    one-hop pairs, and for the full PAMNet the two-hop triplets, on the
    local edges:
      * qm9: local = the bond graph without self-loops; global =
        radius(``cutoff_g``, max 1000 neighbours; 500 for PAMNet_s) without
        self-loops;
      * pdbbind: global = radius(``cutoff_g``, max 1000) without
        self-loops; local = the global edges within ``cutoff_l``; ``feat``
        the (n, 18) atom features, ``z`` zeros;
      * rna: knn(50) superset; global within ``cutoff_g``, local within
        ``cutoff_l``.
    Global edges are sorted by the endpoint the global layer aggregates at:
    dst-major on QM9 and PDBbind (``source_to_target``), src-major on RNA;
    local edges dst-major.  ``variant="s"`` (PAMNet_s) leaves the triplets
    empty."""
    pos = np.asarray(mol["pos"], np.float32)
    n = pos.shape[0]
    if dataset_kind == "qm9":
        el = graphbuild.remove_self_loops_np(
            np.asarray(mol["edge_index"], np.int64).astype(np.int32))
        eg = graphbuild.remove_self_loops_np(graphbuild.radius_graph(
            pos, cutoff_g, None, 500 if variant == "s" else 1000))
    elif dataset_kind == "pdbbind":
        eg = graphbuild.remove_self_loops_np(
            graphbuild.radius_graph(pos, cutoff_g, None, 1000))
        el = eg[:, graphbuild.edge_distances_np(eg, pos) <= cutoff_l]
    elif dataset_kind == "rna":
        eknn = graphbuild.remove_self_loops_np(graphbuild.knn_graph(pos, 50))
        dist_knn = graphbuild.edge_distances_np(eknn, pos)
        eg = eknn[:, dist_knn <= cutoff_g]
        el = eknn[:, dist_knn <= cutoff_l]
    else:
        raise ValueError(f"unknown dataset kind: {dataset_kind}")
    if dataset_kind == "rna":
        eg = eg[:, np.lexsort((eg[1], eg[0]))]
    else:
        eg = eg[:, np.lexsort((eg[0], eg[1]))]
    el = el[:, np.lexsort((el[0], el[1]))]
    if variant == "full":
        t2 = graphbuild.triplets(el, n)
    else:
        t2 = {k: np.zeros(0, np.int32) for k in ("idx_i", "idx_j", "idx_k", "idx_kj", "idx_ji")}
    t1 = graphbuild.pairs(el, n)
    p64 = pos.astype(np.float64)
    if dataset_kind == "pdbbind":
        feat, z = np.asarray(mol["feat"], np.float32), np.zeros(n, np.int32)
    else:
        feat, z = np.zeros((n, 0), np.float32), np.asarray(mol["z"], np.int32)
    out = {
        "pos": pos,
        "z": z,
        "feat": feat,
        "y": np.float32(mol["y"]),
        "eg": np.ascontiguousarray(eg, np.int32),
        "el": np.ascontiguousarray(el, np.int32),
        "t2": t2,
        "t1": t1,
        "dist_g": np.sqrt(((p64[eg[1]] - p64[eg[0]]) ** 2).sum(-1)).astype(np.float32),
        "dist_l": np.sqrt(((p64[el[1]] - p64[el[0]]) ** 2).sum(-1)).astype(np.float32),
    }
    return out


def attach_basis(s: dict, cutoff_l: float, num_spherical: int = 7,
                 num_radial: int = 6, envelope_exponent: int = 5) -> dict:
    """Host float64 spherical basis of one structure: ``sbf_radial``
    (el, ns*nr), ``cbf2`` (t2, ns), ``cbf1`` (t1, ns) (reference math:
    layers/basic.py:79-116), computed by the native library
    (``native.sbf_radial``, ``native.cbf``), which releases the GIL: bit for
    bit ``attach_basis_np``, the numpy reference it is held to, but for a
    rare float32 ulp of ``sbf_radial`` where numpy's BLAS adds j_l's closed
    form in another order.  Geometry only, no trainable parameter."""
    t = bessel_basis_tables(num_spherical, num_radial)
    pos = np.ascontiguousarray(s["pos"], np.float64)
    t2, t1 = s["t2"], s["t1"]
    s["sbf_radial"] = native.sbf_radial(pos, s["el"], cutoff_l, envelope_exponent, t)
    s["cbf2"] = native.cbf(pos, t2["idx_i"], t2["idx_j"], t2["idx_k"], t["sph_pref"])
    s["cbf1"] = native.cbf(pos, t1["idx_i"], t1["idx_j1"], t1["idx_j2"], t["sph_pref"])
    return s


def attach_basis_np(s: dict, cutoff_l: float, num_spherical: int = 7,
                    num_radial: int = 6, envelope_exponent: int = 5) -> dict:
    """``attach_basis`` in numpy: the reference the native basis is held
    to."""
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
    # Explicit width: a structure with no local edges is legal.
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


def build_perm_np(ids: np.ndarray, num_valid: int, num_groups: int,
                  total_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """(perm (total_rows,), poff (num_groups+1,)) int32: ``perm`` stable-sorts
    the first ``num_valid`` rows by ``ids`` and parks the padded rows after
    them; ``poff`` marks each group's range in that order, ``poff[-1] ==
    num_valid`` (JAX: ``pamnet_tpu/ops/ell.py::build_perm_np``; the reference
    of ``native.csr_perm``)."""
    idv = np.asarray(ids[:num_valid], dtype=np.int64)
    if num_valid and (idv.min() < 0 or idv.max() >= num_groups):
        raise ValueError("group id out of range")
    order = np.argsort(idv, kind="stable").astype(np.int32)
    counts = np.bincount(idv, minlength=num_groups)
    poff = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    perm = np.concatenate([order, np.arange(num_valid, total_rows, dtype=np.int32)])
    return perm, poff


def _longest(off: np.ndarray) -> int:
    """The most rows of a group of CSR offsets ``off``."""
    return int(np.diff(off).max()) if off.shape[0] > 1 else 0


def _offsets(ids: np.ndarray, num_valid: int, num_groups: int) -> np.ndarray | None:
    """(groups+1,) int32 CSR offsets of rows sorted by ``ids``, or None when
    the first ``num_valid`` rows are not sorted (the reference of
    ``native.csr_offsets``)."""
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
_F32_FIELDS = (("pos", "n"), ("feat", "n"))
_DIST_FIELDS = (("dist_g", "eg"), ("dist_l", "el"))
_BASIS_FIELDS = (("sbf_radial", "el"), ("cbf2", "t2"), ("cbf1", "t1"))
GEOMETRY_FIELDS = tuple(k for k, _ in _DIST_FIELDS + _BASIS_FIELDS)


def _get(s: dict, path: tuple) -> np.ndarray:
    for p in path:
        s = s[p]
    return s


def _host_f32_fields(has_dist: bool, has_basis: bool, host: bool) -> tuple:
    """(field, pad dim) of the float fields a batch carries."""
    return (_F32_FIELDS + (_DIST_FIELDS if host and has_dist else ())
            + (_BASIS_FIELDS if host and has_basis else ()))


class CollatePlan:
    """Address and length tables of every collated field over all
    structures, built once (the JAX package's ``CollatePlan``,
    ``pamnet_tpu/data/batch.py:395``): a field of a batch is then one gather
    of its structures' rows of the tables and one call of the native
    library's ``concat_offset_i32`` / ``concat_rows_f32``, which writes the
    concatenation, its offsets and its padding straight into the padded
    buffer, bit for bit ``collate_structures`` without a plan.

    The plan keeps the structures and every array it addresses alive (a
    field of the wrong type or layout is read from a contiguous copy it
    holds).  Structures are frozen once a plan exists: ``verify(i)`` raises
    where a field array of structure ``i`` was replaced since.  Raises where
    the native library cannot be built."""

    def __init__(self, structs: list[dict]):
        native.library()
        self.structs = structs
        self.has_dist = all("dist_g" in s for s in structs)
        self.has_basis = all("sbf_radial" in s for s in structs)
        fields = [(key, path, np.int32) for key, path, _, _ in _INT_FIELDS]
        fields += [(key, (key,), np.float32)
                   for key, _ in _host_f32_fields(self.has_dist, self.has_basis, True)]
        self._paths = {key: path for key, path, _ in fields}
        self._arrays: list[np.ndarray] = []
        self.addr, self.len, self._live, self.trailing = {}, {}, {}, {}
        for key, path, dtype in fields:
            live = [_get(s, path) for s in structs]
            data = [a if a.dtype == dtype and a.flags.c_contiguous
                    else np.ascontiguousarray(a, dtype) for a in live]
            trailing = {a.shape[1:] for a in data}
            if len(trailing) != 1:
                raise ValueError(f"CollatePlan: field {key!r} has rows of shapes {trailing}")
            self.trailing[key] = trailing.pop()
            self._arrays += live
            self.addr[key], self.len[key] = native.addresses(data)
            self._live[key] = self.addr[key]
            if any(d is not a for d, a in zip(data, live)):
                self._arrays += data
                self._live[key] = native.addresses(live)[0]
        self.y = np.array([s["y"] for s in structs], dtype=np.float32)

    def verify(self, i: int) -> None:
        """Raise unless every field array of structure ``i`` is the one the
        plan was built on."""
        for key, path in self._paths.items():
            if _get(self.structs[i], path).__array_interface__["data"][0] != self._live[key][i]:
                raise RuntimeError(
                    f"CollatePlan is stale: field {key!r} of structure {i} was replaced "
                    f"after the plan was built (rebuild the plan or the loader)")

    def cat_i32(self, key: str, idxs: np.ndarray, offs: np.ndarray, size: int) -> np.ndarray:
        return native.concat_offset_i32(self.addr[key][idxs], self.len[key][idxs], offs, size)

    def cat_f32(self, key: str, idxs: np.ndarray, size: int) -> np.ndarray:
        return native.concat_rows_f32(self.addr[key][idxs], self.len[key][idxs],
                                      self.trailing[key], size)


def collate_structures(structs: list[dict] | None, pads: PadSizes | None = None,
                       align: int = 128, build_perms: bool = False,
                       num_atom_types: int | None = None,
                       variant: str = "full",
                       wire_geometry: str = "host",
                       plan: CollatePlan | None = None,
                       idxs: list[int] | None = None) -> GraphBatch:
    """Concatenate structures into one padded batch, offsetting node ids by node counts and edge ids by local-edge
    counts; pads default to the geometric bucket of the batch's counts.
    ``build_perms`` adds the backward's CSR arrays (module docstring); the
    CSR of ``z`` has ``num_atom_types`` groups, and None (PDBbind, which
    embeds no atom type) builds none.  ``variant="s"`` (PAMNet_s, no
    triplets) carries the padded t2 fields as JAX does but no CSR of
    them, so no kernel is handed the empty stream.

    ``wire_geometry="host"`` carries the structures' distances and, where
    every structure has ``attach_basis`` applied, their host basis;
    ``"derive"`` carries neither, even where the structures hold them (the
    JAX package's ``collate_structures(wire_geometry=)``).

    With ``plan`` (a ``CollatePlan``) and ``idxs``, the batch of the plan's
    structures ``idxs`` (``structs`` unused): each concatenated field comes
    from the native library in one call, the rest as without a plan.  The
    CSR offsets, ``longest`` and the backward's arrays are the span
    ``collate.csr``."""
    if wire_geometry not in ("host", "derive"):
        raise ValueError(f"wire_geometry must be 'host'|'derive', got {wire_geometry!r}")
    host = wire_geometry == "host"
    if plan is not None:
        idxs = np.asarray(idxs, dtype=np.int64)
        plan.verify(int(idxs[0]))
        nb = len(idxs)
        n_per, el_per = plan.len["pos"][idxs], plan.len["el_src"][idxs]
        n_eg, n_t2, n_t1 = (int(plan.len[k][idxs].sum()) for k in ("eg_src", "t2_ji", "t1_ji"))
        f32_fields = _host_f32_fields(plan.has_dist, plan.has_basis, host)
    else:
        nb = len(structs)
        n_per = np.array([s["pos"].shape[0] for s in structs], np.int64)
        el_per = np.array([s["el"].shape[1] for s in structs], np.int64)
        n_eg = int(sum(s["eg"].shape[1] for s in structs))
        n_t2 = int(sum(s["t2"]["idx_ji"].shape[0] for s in structs))
        n_t1 = int(sum(s["t1"]["idx_ji"].shape[0] for s in structs))
        f32_fields = _host_f32_fields(all("dist_g" in s for s in structs),
                                      all("sbf_radial" in s for s in structs), host)
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
        if plan is not None:
            f[key] = plan.cat_i32(key, idxs, offs_of[okind], pad_of[pdim])
        else:
            f[key] = _pad1(np.concatenate([_get(s, path).astype(np.int32) + o
                                           for s, o in zip(structs, offs_of[okind])]),
                           pad_of[pdim])
    for key, pdim in f32_fields:
        if plan is not None:
            f[key] = plan.cat_f32(key, idxs, pad_of[pdim])
        else:
            f[key] = _pad1(np.concatenate([s[key] for s in structs]).astype(np.float32),
                           pad_of[pdim])

    with span("collate.csr"):
        # The global layer reads whichever endpoint the edges are sorted by.
        eg_dst_off = native.csr_offsets(f["eg_dst"], n_eg, pads.n)
        eg_src_off = (None if eg_dst_off is not None
                      else native.csr_offsets(f["eg_src"], n_eg, pads.n))
        el_dst_off = native.csr_offsets(f["el_dst"], n_el, pads.n)
        two_hop = variant == "full"
        if not two_hop and n_t2:
            raise ValueError("PAMNet_s structures carry no triplets")
        sorted_off = {"eg_src": eg_src_off, "eg_dst": eg_dst_off, "el_dst": el_dst_off,
                      "t2_ji": native.csr_offsets(f["t2_ji"], n_t2, pads.el) if two_hop else None,
                      "t1_ji": native.csr_offsets(f["t1_ji"], n_t1, pads.el)}
        longest = {k: _longest(v) for k, v in sorted_off.items() if v is not None}
        perms: dict[str, np.ndarray] = {}
        if build_perms:
            keyed = [("el_src", n_el, pads.n, pads.el), ("t1_jj", n_t1, pads.el, pads.t1)]
            if two_hop:
                keyed.append(("t2_kj", n_t2, pads.el, pads.t2))
            if num_atom_types is not None:
                keyed.append(("z", num_nodes, num_atom_types, pads.n))
            for key, off in (("eg_src", eg_src_off), ("eg_dst", eg_dst_off),
                             ("el_dst", el_dst_off)):
                if off is None:
                    rows, n_valid = (pads.eg, n_eg) if key[:2] == "eg" else (pads.el, n_el)
                    keyed.append((key, n_valid, pads.n, rows))
            for key, n_valid, groups, rows in keyed:
                perms[key + "_perm"], perms[key + "_poff"] = native.csr_perm(
                    f[key], n_valid, groups, rows)
            if two_hop:
                perms["t2_ji_by_kj"] = f["t2_ji"][perms["t2_kj_perm"]]
            perms["t1_ji_by_jj"] = f["t1_ji"][perms["t1_jj_perm"]]
        longest.update({k[:-5]: _longest(v) for k, v in perms.items() if k.endswith("_poff")})
    y = plan.y[idxs] if plan is not None else np.array([s["y"] for s in structs], np.float32)
    node_graph = np.repeat(np.arange(nb, dtype=np.int32), n_per)

    t = torch.from_numpy
    opt = lambda a: None if a is None else t(a)  # noqa: E731
    return GraphBatch(
        **{k: t(v) for k, v in f.items()},
        **{k: None for k in GEOMETRY_FIELDS if k not in f},
        node_mask=t(_mask(num_nodes, pads.n)),
        node_graph=t(_pad1(node_graph, pads.n)),
        eg_mask=t(_mask(n_eg, pads.eg)),
        el_mask=t(_mask(n_el, pads.el)),
        t2_mask=t(_mask(n_t2, pads.t2)),
        t1_mask=t(_mask(n_t1, pads.t1)),
        y=t(_pad1(y, pads.g)),
        graph_mask=t(_mask(nb, pads.g)),
        **{k + "_off": opt(v) for k, v in sorted_off.items()},
        num_graphs=nb,
        valid={"n": num_nodes, "eg": n_eg, "el": n_el, "t2": n_t2, "t1": n_t1},
        perms={k: t(v) for k, v in perms.items()},
        longest=longest,
    )
