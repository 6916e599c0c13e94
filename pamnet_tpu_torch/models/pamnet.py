"""PAMNet and PAMNet_s on the RNA, QM9 and PDBbind branches (reference:
models.py:21-353; JAX counterpart ``pamnet_tpu/models/pamnet.py:116-397``).

A host-geometry batch carries host-f64 distances and spherical-basis tables
(``data/batch.py``); a derive batch carries positions and integer tables
only, and ``derive_geometry`` computes the same fields in f32 on the device
before anything reads them, so every later route (the folded kernel B path
included) stays as it is.  With ``cfg.device_graph`` the forward first
rebuilds the graph from the positions on the device
(``models/device_graph.py``).  The trainable Bessel basis is evaluated
here.  Where
``sbf_modulate`` has kernels for ``(num_spherical, dim)`` (the RNA dim-16
model), the model-level sbf MLP folds through the triplet gather, in scoring
and in training: the radial table is projected once per edge and the folded
stage runs in that kernel, forward and backward; otherwise (QM9 at dim 128)
the triplet basis is expanded and passed through the MLP per triplet, and
kernel A gathers and modulates.  The QM9 branch
embeds 5 atom types and pools by sum; RNA pools by mean; PDBbind projects
its 18 atom features through ``init_linear`` and pools the signed sum
E(complex) - E(pocket) - E(ligand), the sign -1 where x > 40 A.
``variant="s"`` (PAMNet_s) runs the one-hop triplet stream alone, through
one model-level sbf MLP (``mlp_sbf``) and ``mlp_m_jj`` local layers.

``compute_dtype="bfloat16"`` is the JAX package's mixed precision
(``pamnet_tpu/models/pamnet.py:158-168, 241-289, 367-397``): the parameters
stay float32; the geometry (distances, the Bessel basis with its trainable
frequencies, ``mlp_rbf_g``/``mlp_rbf_l``, the embedding or ``init_linear``,
the spherical tables on the card) runs in float32; the radial table and the
angular terms are cast before the triplet gather and the sbf MLPs run in
bfloat16; the node state, the edge attributes and the four masks cross into
bfloat16 before the layers, whose kernels sum in float32 and round once; the
heads go back to float32 before the fusion's softmax, and the pool runs in
float32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from pamnet_tpu_torch.config import PAMNetConfig, embeds_atom_types
from pamnet_tpu_torch.data.batch import GraphBatch
from pamnet_tpu_torch.models.device_graph import rebuild_structure
from pamnet_tpu_torch.models.layers import FoldedSBF, GlobalMP, LocalMP
from pamnet_tpu_torch.nn import Linear, as_dtype, cast_parameters, init_, mlp
from pamnet_tpu_torch.ops.basis import BesselRBF, legendre_cbf, spherical_basis_edge_rbf
from pamnet_tpu_torch.ops.gather import row_gather, row_gather_plain
from pamnet_tpu_torch.ops.segment import segment_mean, segment_sum


def _safe_edge_dist(pos, src, dst, mask, cutoff: float) -> torch.Tensor:
    """Edge lengths, padded edges at 2 * cutoff so every basis channel is
    exactly zero there (``pamnet_tpu/models/pamnet.py:77``); the padded
    rows' zero lengths never reach the square root, whose gradient at 0
    would be NaN."""
    v = torch.index_select(pos, 0, dst) - torch.index_select(pos, 0, src)
    real = mask > 0
    return torch.where(real, torch.sqrt(torch.where(real, (v * v).sum(-1), 1.0)), 2.0 * cutoff)


def _angle(pos, a, b, c, mask) -> torch.Tensor:
    """The angle between v1 = pos[b] - pos[a] and v2 = pos[c] - pos[b] as
    atan2(|v1 x v2|, v1 . v2) (reference: models.py:164-177), with a
    zero-safe norm and, at padded rows, dot = 1 (atan2(0, 0) has NaN
    gradients; ``pamnet_tpu/models/pamnet.py:84``)."""
    pb = torch.index_select(pos, 0, b)
    v1 = pb - torch.index_select(pos, 0, a)
    v2 = torch.index_select(pos, 0, c) - pb
    dot = (v1 * v2).sum(-1)
    cross = torch.linalg.cross(v1, v2, dim=-1)
    sq = (cross * cross).sum(-1)
    nrm = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, 1.0)), 0.0)
    return torch.atan2(nrm, torch.where(mask > 0, dot, 1.0))


def derive_geometry(g: GraphBatch, cfg: PAMNetConfig) -> GraphBatch:
    """``g`` with the geometry it does not carry computed from ``g.pos`` in
    its dtype: the distances (padded edges at 2 * cutoff), the radial table
    ``sbf_radial`` = ``spherical_basis_edge_rbf`` of the local distances,
    flattened to (El, ns*nr), and ``cbf2``/``cbf1`` = ``legendre_cbf`` of the
    triplets' angles (PAMNet_s: no ``cbf2``).  The fields JAX's derive
    forward computes in the step (``pamnet_tpu/models/pamnet.py:138-143,
    256-266``), laid out as the host's.  Geometry only: no parameter."""
    if g.dist_g is not None and g.sbf_radial is not None:
        return g
    rep = {}
    if g.dist_g is None:
        rep["dist_g"] = _safe_edge_dist(g.pos, g.eg_src, g.eg_dst, g.eg_mask, cfg.cutoff_g)
        rep["dist_l"] = _safe_edge_dist(g.pos, g.el_src, g.el_dst, g.el_mask, cfg.cutoff_l)
    if g.sbf_radial is None:
        ns, nr = cfg.num_spherical, cfg.num_radial
        dist_l = torch.where(g.el_mask > 0, rep.get("dist_l", g.dist_l), 2.0 * cfg.cutoff_l)
        rep["sbf_radial"] = spherical_basis_edge_rbf(
            dist_l, ns, nr, cfg.cutoff_l, cfg.envelope_exponent).reshape(-1, ns * nr)
        rep["cbf1"] = legendre_cbf(_angle(g.pos, g.t1_i, g.t1_j1, g.t1_j2, g.t1_mask), ns)
        rep["cbf2"] = (legendre_cbf(_angle(g.pos, g.t2_i, g.t2_j, g.t2_k, g.t2_mask), ns)
                       if cfg.variant == "full" else None)
    return dataclasses.replace(g, **rep)


class PAMNet(nn.Module):
    """Parameters are named as the reference's ``state_dict``
    (``weights.py`` loads reference checkpoints and JAX parameters) and
    initialized from ``generator`` (default: seed 0) with the JAX package's
    distributions."""

    def __init__(self, cfg: PAMNetConfig, generator: torch.Generator | None = None):
        super().__init__()
        full = cfg.variant == "full"
        if cfg.dataset_kind == "pdbbind" and not full:
            raise ValueError("PAMNet_s has no PDBbind branch: init_pamnet gives "
                             "init_linear to the full model only")
        self.cfg = cfg
        dim = cfg.dim
        sbf_dim = cfg.num_spherical * cfg.num_radial
        self.embeddings = nn.Parameter(torch.empty(cfg.num_atom_types, dim))
        self.rbf_g = BesselRBF(cfg.num_rbf)
        self.rbf_l = BesselRBF(cfg.num_rbf)
        self.mlp_rbf_g = mlp([cfg.num_rbf, dim])
        self.mlp_rbf_l = mlp([cfg.num_rbf, dim])
        if cfg.dataset_kind != "rna" and full:
            # Created as in the reference and init_pamnet.  PDBbind reads it
            # (and not the embedding); the QM9 forward embeds atom types and
            # never reads it, so its gradient is 0.
            self.init_linear = Linear(cfg.num_node_features, dim, bias=False)
        if full:
            self.mlp_sbf1 = mlp([sbf_dim, dim])
            self.mlp_sbf2 = mlp([sbf_dim, dim])
        else:
            self.mlp_sbf = mlp([sbf_dim, dim])
        self.global_layer = nn.ModuleList(GlobalMP(dim) for _ in range(cfg.n_layer))
        self.local_layer = nn.ModuleList(LocalMP(dim, cfg.variant)
                                         for _ in range(cfg.n_layer))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_(self, generator)
        self._stack_params: list[nn.Parameter] | None = None

    def fold_sbf(self) -> bool:
        """Fold the sbf MLP through the gather and run the folded stage in
        ``sbf_modulate``: by default wherever that kernel is built, training
        batches included, as the JAX package folds every batch without ELL
        tables (``_fold_gate``; its main_rna_puzzles.py builds none), and the port
        builds no ELL tables."""
        return self.cfg.folds()

    def _compute_parameters(self, dtype: torch.dtype):
        """The block in which the stack reads its parameters in ``dtype``:
        one batched cast where that is not their float32
        (``nn.cast_parameters``) of the parameters the stack reads, the sbf
        MLPs' and the layers' (not the embedding, the Bessel frequencies,
        ``mlp_rbf_*`` or ``init_linear``, which the float32 geometry side
        reads)."""
        if dtype == torch.float32:
            return contextlib.nullcontext()
        if self._stack_params is None:  # the same Parameter objects for the module's life
            sbf = ((self.mlp_sbf,) if self.cfg.variant == "s"
                   else (self.mlp_sbf2, self.mlp_sbf1))
            self._stack_params = [p for m in (*sbf, self.global_layer, self.local_layer)
                                  for p in m.parameters()]
        return cast_parameters(self._stack_params, dtype)

    def _triplet_basis(self, g: GraphBatch, plain: bool, dtype: torch.dtype):
        """(edge_attr_sbf2, edge_attr_sbf1): (T, dim) tensors in ``dtype``,
        or ``FoldedSBF`` inputs of the fused folded stage in ``dtype``;
        PAMNet_s has no two-hop stream (None) and one sbf MLP."""
        ns, nr = self.cfg.num_spherical, self.cfg.num_radial
        if self.cfg.variant == "s":
            mlp_sbf2, mlp_sbf1 = None, self.mlp_sbf
        else:
            mlp_sbf2, mlp_sbf1 = self.mlp_sbf2, self.mlp_sbf1
        if not self.fold_sbf():
            # Geometry only: the radial table's gather has no backward.  The
            # table and the angular terms take the stack's type before the
            # gather (JAX casts them there: half the gathered bytes).
            gather = row_gather_plain if plain else row_gather
            table = g.sbf_radial.to(dtype)

            def expand(mlp_sbf, idx, cbf):
                sbf = gather(table, idx) * torch.repeat_interleave(cbf.to(dtype), nr, dim=1)
                return mlp_sbf(sbf)

            return (None if mlp_sbf2 is None else expand(mlp_sbf2, g.t2_kj, g.cbf2),
                    expand(mlp_sbf1, g.t1_jj, g.cbf1))

        # The folded stage's operands in the stack's type, as JAX casts them
        # (``pamnet_tpu/models/pamnet.py:185-230``): the radial table, the
        # projection's weight and bias (so the projection runs in it) and the
        # angular terms.
        table = g.sbf_radial.to(dtype)

        def folded(mlp_sbf, cbf):
            lin = mlp_sbf[0][0]
            w = as_dtype(lin.weight, dtype)  # (dim, ns*nr)
            proj = torch.cat(
                [table[:, l * nr:(l + 1) * nr] @ w[:, l * nr:(l + 1) * nr].T
                 for l in range(ns)], dim=1,
            )  # (El, ns*dim)
            return FoldedSBF(proj, cbf.to(dtype), as_dtype(lin.bias, dtype))

        return (None if mlp_sbf2 is None else folded(mlp_sbf2, g.cbf2),
                folded(mlp_sbf1, g.cbf1))

    def forward(self, g: GraphBatch, plain: bool = False) -> torch.Tensor:
        """(G,) per-graph predictions, 0 for padded graphs.  ``plain=True``
        runs the plain versions of the kernels, on any device."""
        cfg = self.cfg
        kind = cfg.dataset_kind
        if cfg.device_graph:
            g = rebuild_structure(g, cfg)
        g = derive_geometry(g, cfg)
        if not embeds_atom_types(kind):
            x = self.init_linear(g.feat)
        elif plain:
            x = row_gather_plain(self.embeddings, g.z)
        else:
            x = row_gather(self.embeddings, g.z, g.groups("z"))
        # Mask before basis: padded distances at 2*cutoff zero every channel.
        dist_g = torch.where(g.eg_mask > 0, g.dist_g, 2.0 * cfg.cutoff_g)
        dist_l = torch.where(g.el_mask > 0, g.dist_l, 2.0 * cfg.cutoff_l)
        rbf_l = self.mlp_rbf_l(self.rbf_l(dist_l, cfg.cutoff_l, cfg.envelope_exponent))
        rbf_g = self.mlp_rbf_g(self.rbf_g(dist_g, cfg.cutoff_g, cfg.envelope_exponent))

        cdt = cfg.dtype
        outs, atts = [], []
        with self._compute_parameters(cdt):
            sbf2, sbf1 = self._triplet_basis(g, plain, cdt)
            # The mixed-precision boundary: the geometry above stays float32.
            x, rbf_g, rbf_l = x.to(cdt), rbf_g.to(cdt), rbf_l.to(cdt)
            if cdt != torch.float32:
                g = dataclasses.replace(g, **{k: getattr(g, k).to(cdt) for k in (
                    "eg_mask", "el_mask", "t2_mask", "t1_mask")})
            for glayer, llayer in zip(self.global_layer, self.local_layer):
                x, out_g, att_g = glayer(x, rbf_g, g, cfg.flow, plain)
                x, out_l, att_l = llayer(x, rbf_l, sbf2, sbf1, g, plain)
                outs.append(torch.cat([out_g, out_l], dim=1))
                atts.append(torch.cat([att_g, att_l], dim=1))
        # Two-plex fusion per (layer, node), summed over layers, in f32
        # whatever the stack's type (reference: models.py:206-213; JAX: a
        # bfloat16 softmax here biased RNA scores by about 2.5%).
        att = torch.softmax(F.leaky_relu(torch.stack(atts).float(), 0.2), dim=-1)
        node_out = (torch.stack(outs).float() * att).sum(-1).sum(0)  # (N,)
        node_out = node_out * g.node_mask
        num_graphs = g.y.shape[0]
        if kind == "qm9":  # sum pool (reference: models.py:215-216)
            pooled = segment_sum(node_out, g.node_graph, num_graphs)
        elif kind == "pdbbind":
            # E(complex) - E(pocket) - E(ligand): the pocket and ligand copies
            # sit at x + 100 and x + 200 A (reference: models.py:122-125,
            # 217-219; preprocess_pdbbind.py:33-43).
            sign = torch.where(g.pos[:, 0] > 40.0, -1.0, 1.0)
            pooled = segment_sum(node_out * sign, g.node_graph, num_graphs)
        else:  # RNA mean pool (reference: models.py:220-221)
            pooled = segment_mean(node_out[:, None], g.node_graph, num_graphs,
                                  mask=g.node_mask)[:, 0]
        return pooled * g.graph_mask
