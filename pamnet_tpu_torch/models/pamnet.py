"""PAMNet, full variant, RNA and QM9 branches (reference: models.py:21-224;
JAX counterpart ``pamnet_tpu/models/pamnet.py:116-397``).

The batch carries host-f64 distances and spherical-basis tables
(``data/batch.py``); the trainable Bessel basis is evaluated here.  Where
``sbf_modulate`` has a kernel for ``(num_spherical, dim)`` (the RNA dim-16
model) and the batch is not a training batch, the model-level sbf MLP folds
through the triplet gather: the radial table is projected once per edge and
the folded stage runs in that kernel; otherwise (training, and QM9 at dim
128) the triplet basis is expanded and passed through the MLP per triplet,
and kernel A gathers and modulates.  The QM9 branch
embeds 5 atom types and pools by sum; RNA pools by mean.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from pamnet_tpu_torch.config import PAMNetConfig
from pamnet_tpu_torch.data.batch import GraphBatch
from pamnet_tpu_torch.models.layers import FoldedSBF, GlobalMP, LocalMP
from pamnet_tpu_torch.nn import Linear, init_, mlp
from pamnet_tpu_torch.ops.basis import BesselRBF
from pamnet_tpu_torch.ops.gather import row_gather, row_gather_plain
from pamnet_tpu_torch.ops.sbf_modulate import KERNEL_SHAPES
from pamnet_tpu_torch.ops.segment import segment_mean, segment_sum


class PAMNet(nn.Module):
    """Parameters are named as the reference's ``state_dict``
    (``weights.py`` loads reference checkpoints and JAX parameters) and
    initialized from ``generator`` (default: seed 0) with the JAX package's
    distributions."""

    def __init__(self, cfg: PAMNetConfig, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.dataset_kind not in ("rna", "qm9") or cfg.variant != "full":
            raise NotImplementedError(
                "the port implements the full PAMNet on the RNA and QM9 "
                f"branches only (dataset {cfg.dataset!r}, variant {cfg.variant!r})"
            )
        self.cfg = cfg
        dim = cfg.dim
        sbf_dim = cfg.num_spherical * cfg.num_radial
        self.embeddings = nn.Parameter(torch.empty(cfg.num_atom_types, dim))
        self.rbf_g = BesselRBF(cfg.num_rbf)
        self.rbf_l = BesselRBF(cfg.num_rbf)
        self.mlp_rbf_g = mlp([cfg.num_rbf, dim])
        self.mlp_rbf_l = mlp([cfg.num_rbf, dim])
        if cfg.dataset_kind != "rna":
            # Created as in the reference and init_pamnet; the QM9 forward
            # embeds atom types and never reads it, so its gradient is 0.
            self.init_linear = Linear(cfg.num_node_features, dim, bias=False)
        self.mlp_sbf1 = mlp([sbf_dim, dim])
        self.mlp_sbf2 = mlp([sbf_dim, dim])
        self.global_layer = nn.ModuleList(GlobalMP(dim) for _ in range(cfg.n_layer))
        self.local_layer = nn.ModuleList(LocalMP(dim) for _ in range(cfg.n_layer))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_(self, generator)

    def fold_sbf(self, g: GraphBatch) -> bool:
        """Fold the sbf MLP through the gather and run the folded stage in
        ``sbf_modulate``: by default where that kernel is built, for batches
        without backward arrays.  ``sbf_modulate`` has no backward, so a
        training batch (``build_perms=True``) takes the unfolded path, whose
        radial-table gather carries no gradient; the JAX package unfolds its
        training batches too (``_fold_gate``: under ELL tables)."""
        cfg = self.cfg
        if cfg.fold_sbf is not None:
            return cfg.fold_sbf
        return (cfg.num_spherical, cfg.dim) in KERNEL_SHAPES and not g.perms

    def _triplet_basis(self, g: GraphBatch, plain: bool):
        """(edge_attr_sbf2, edge_attr_sbf1): (T, dim) tensors, or
        ``FoldedSBF`` inputs of the fused folded stage."""
        ns, nr = self.cfg.num_spherical, self.cfg.num_radial
        if not self.fold_sbf(g):
            # Geometry only: the radial table's gather has no backward.
            gather = row_gather_plain if plain else row_gather

            def expand(mlp_sbf, idx, cbf):
                sbf = gather(g.sbf_radial, idx) * torch.repeat_interleave(cbf, nr, dim=1)
                return mlp_sbf(sbf)

            return (expand(self.mlp_sbf2, g.t2_kj, g.cbf2),
                    expand(self.mlp_sbf1, g.t1_jj, g.cbf1))

        def folded(mlp_sbf, cbf):
            lin = mlp_sbf[0][0]
            w = lin.weight  # (dim, ns*nr)
            proj = torch.cat(
                [g.sbf_radial[:, l * nr:(l + 1) * nr] @ w[:, l * nr:(l + 1) * nr].T
                 for l in range(ns)], dim=1,
            )  # (El, ns*dim)
            return FoldedSBF(proj, cbf, lin.bias)

        return folded(self.mlp_sbf2, g.cbf2), folded(self.mlp_sbf1, g.cbf1)

    def forward(self, g: GraphBatch, plain: bool = False) -> torch.Tensor:
        """(G,) per-graph predictions, 0 for padded graphs.  ``plain=True``
        runs the plain versions of the kernels, on any device."""
        cfg = self.cfg
        if plain:
            x = row_gather_plain(self.embeddings, g.z)
        else:
            x = row_gather(self.embeddings, g.z, g.groups("z"))
        # Mask before basis: padded distances at 2*cutoff zero every channel.
        dist_g = torch.where(g.eg_mask > 0, g.dist_g, 2.0 * cfg.cutoff_g)
        dist_l = torch.where(g.el_mask > 0, g.dist_l, 2.0 * cfg.cutoff_l)
        rbf_l = self.mlp_rbf_l(self.rbf_l(dist_l, cfg.cutoff_l, cfg.envelope_exponent))
        rbf_g = self.mlp_rbf_g(self.rbf_g(dist_g, cfg.cutoff_g, cfg.envelope_exponent))
        sbf2, sbf1 = self._triplet_basis(g, plain)

        outs, atts = [], []
        for glayer, llayer in zip(self.global_layer, self.local_layer):
            x, out_g, att_g = glayer(x, rbf_g, g, cfg.flow, plain)
            x, out_l, att_l = llayer(x, rbf_l, sbf2, sbf1, g, plain)
            outs.append(torch.cat([out_g, out_l], dim=1))
            atts.append(torch.cat([att_g, att_l], dim=1))
        # Two-plex fusion per (layer, node), summed over layers, in f32
        # (reference: models.py:206-213).
        att = torch.softmax(F.leaky_relu(torch.stack(atts), 0.2), dim=-1)
        node_out = (torch.stack(outs) * att).sum(-1).sum(0)  # (N,)
        node_out = node_out * g.node_mask
        num_graphs = g.y.shape[0]
        if cfg.dataset_kind == "qm9":  # sum pool (reference: models.py:215-216)
            pooled = segment_sum(node_out, g.node_graph, num_graphs)
        else:  # RNA mean pool (reference: models.py:220-221)
            pooled = segment_mean(node_out[:, None], g.node_graph, num_graphs,
                                  mask=g.node_mask)[:, 0]
        return pooled * g.graph_mask
