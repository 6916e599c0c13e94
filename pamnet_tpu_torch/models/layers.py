"""Message-passing layers of PAMNet (reference: global_message_passing.py,
local_message_passing.py; JAX counterpart ``pamnet_tpu/models/layers.py``).

Every aggregation goes through ``ops.triplet.triplet_aggregate`` over the
batch's CSR offsets, every edge message through ``ops.gather.edge_message``
(which gathers its node rows itself), and the folded triplet stream through
``ops.sbf_modulate.sbf_modulate``.  The layers hand those autograd Functions
the batch's backward arrays (``GraphBatch.groups``, ``triplet_grad``), so a
loss differentiates through the backward kernels.  ``plain=True`` calls the
plain PyTorch versions of the kernels on any device, which PyTorch's own
autograd differentiates: the reference route that checks the kernels and
their backwards on the card.  Layers return ``(x, out, att)``: the new node
state, the per-node scalar head and the attention logit of the fusion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from pamnet_tpu_torch.nn import Linear, Res, mlp
from pamnet_tpu_torch.ops.gather import (edge_message, edge_message_plain, row_gather,
                                         row_gather_plain)
from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate, sbf_modulate_plain
from pamnet_tpu_torch.ops.triplet import (AggregateGrad, Groups, triplet_aggregate,
                                          triplet_aggregate_plain)


class FoldedSBF(NamedTuple):
    """Folded spherical basis: ``proj`` = the per-edge radial table projected
    through the model-level 1-stage sbf MLP, (El, ns*dim); ``cbf`` (T, ns);
    ``bias`` = that MLP's bias, (dim,)."""

    proj: torch.Tensor
    cbf: torch.Tensor
    bias: torch.Tensor


def aggregate(values: torch.Tensor, off: torch.Tensor | None, ids: torch.Tensor,
              mask: torch.Tensor, num_groups: int, idx: torch.Tensor | None = None,
              b: torch.Tensor | None = None, total: int | None = None,
              plain: bool = False, grad: AggregateGrad | None = None) -> torch.Tensor:
    """out[g] = sum over rows r with ids[r] == g (and mask[r] > 0) of
    values[idx[r]] * b[r] (``idx``/``b`` None: values[r], no modulation).

    ``off`` are the batch's CSR offsets when the rows are sorted by ``ids``,
    and ``total`` their last entry, the batch's valid row count; ``grad``
    the backward arrays of a gathered sum (without a gather they are
    ``ids``).  Otherwise the valid rows are sorted here (stable, padded rows
    last) and the permutation becomes the kernel's gather; that route has
    no backward arrays, so it raises under grad."""
    if off is not None:
        if plain:
            return triplet_aggregate_plain(values, off, idx, b)
        if grad is None and idx is None:
            grad = AggregateGrad(ids)
        return triplet_aggregate(values, off, idx, b, total=total, grad=grad)
    fn = triplet_aggregate_plain if plain else triplet_aggregate
    keyed = torch.where(mask > 0, ids.long(), num_groups)
    order = torch.argsort(keyed, stable=True)
    off = torch.searchsorted(
        keyed[order], torch.arange(num_groups + 1, device=ids.device)
    ).to(torch.int32)
    gather = order if idx is None else idx[order]
    if b is not None:
        b = (row_gather_plain if plain else row_gather)(b, order.to(torch.int32))
    return fn(values, off, gather.to(torch.int32), b)


class GlobalMP(nn.Module):
    """One global-plex layer (reference: global_message_passing.py:33-56).
    The message MLP's first product over concat(x_i, x_j, e) is split so the
    x-projections run over nodes, then gathered (project-then-gather)."""

    def __init__(self, dim: int):
        super().__init__()
        self.mlp_x1 = mlp([dim, dim])
        self.mlp_x2 = mlp([dim, dim])
        self.res1 = Res(dim)
        self.res2 = Res(dim)
        self.res3 = Res(dim)
        self.mlp_m = mlp([dim * 3, dim])
        self.W_edge_attr = Linear(dim, dim, bias=False)
        self.mlp_out = mlp([dim, dim, dim, dim])
        self.W_out = Linear(dim, 1)
        self.W = nn.Parameter(torch.empty(dim, 1))

    def forward(self, x, edge_attr, g, flow: str, plain: bool = False):
        """``g`` the batch; ``flow`` picks the endpoint messages go to."""
        res_x = x
        x = self.mlp_x1(x)
        i_key, j_key = (("eg_dst", "eg_src") if flow == "source_to_target"
                        else ("eg_src", "eg_dst"))
        i_idx, j_idx = getattr(g, i_key), getattr(g, j_key)
        m = _edge_message(self.mlp_m, x, edge_attr, i_idx, j_idx,
                          self.W_edge_attr(edge_attr), g.eg_mask, plain,
                          g.groups(i_key), g.groups(j_key))
        x = x + aggregate(m, getattr(g, i_key + "_off"), i_idx, g.eg_mask, x.shape[0],
                          total=g.valid["eg"], plain=plain)
        x = self.mlp_x2(x)
        x = self.res1(x) + res_x
        x = self.res3(self.res2(x))
        out = self.mlp_out(x)
        return x, self.W_out(out), out @ self.W


def _edge_message(mlp_m: nn.Sequential, x, e, i, j, gate=None, mask=None,
                  plain: bool = False, i_groups: Groups | None = None,
                  j_groups: Groups | None = None):
    """silu(W @ concat(x_i, x_j, e) + b) * gate * mask with the x-projections
    hoisted to node level (reference: local_message_passing.py:40-46 and
    the message of global_message_passing.py); the kernel gathers the
    projected rows by ``i``/``j`` itself, and its backward sums over
    ``i_groups``/``j_groups``, the CSRs of ``i``/``j``."""
    dim = x.shape[1]
    lin = mlp_m[0][0]
    w = lin.weight  # (dim, 3*dim) = [x_i | x_j | e]
    args = (x @ w[:, :dim].T, x @ w[:, dim:2 * dim].T, i, j,
            F.linear(e, w[:, 2 * dim:], lin.bias), gate, mask)
    if plain:
        return edge_message_plain(*args)
    return edge_message(*args, i_groups=i_groups, j_groups=j_groups)


class LocalMP(nn.Module):
    """One full local-plex layer with the two-hop and one-hop triplet
    streams (reference: local_message_passing.py:36-66)."""

    def __init__(self, dim: int):
        super().__init__()
        self.mlp_x1 = mlp([dim, dim])
        self.mlp_m_ji = mlp([3 * dim, dim])
        self.mlp_m_kj = mlp([3 * dim, dim])
        self.mlp_sbf = mlp([dim, dim, dim])
        self.lin_rbf = Linear(dim, dim, bias=False)
        self.res1 = Res(dim)
        self.res2 = Res(dim)
        self.res3 = Res(dim)
        self.lin_rbf_out = Linear(dim, dim, bias=False)
        self.mlp_x2 = mlp([dim, dim])
        self.mlp_out = mlp([dim, dim, dim, dim])
        self.W_out = Linear(dim, 1)
        self.W = nn.Parameter(torch.empty(dim, 1))

    def _modulate(self, m_neighbor, folded: FoldedSBF, idx, t_mask, plain):
        fn = sbf_modulate_plain if plain else sbf_modulate
        s1, s2 = self.mlp_sbf[0][0], self.mlp_sbf[1][0]
        return fn(folded.proj, m_neighbor, folded.cbf, folded.bias, s1.weight,
                  s1.bias, s2.weight, s2.bias, idx, t_mask)

    def forward(self, x, rbf, sbf2, sbf1, g, plain: bool = False):
        """``sbf2``/``sbf1``: (T, dim) outputs of the model-level sbf MLPs,
        or ``FoldedSBF`` inputs of the fused folded path; ``g`` the batch."""
        j, i = g.el_src, g.el_dst
        num_edges = rbf.shape[0]
        res_x = x
        x = self.mlp_x1(x)
        i_groups, j_groups = g.groups("el_dst"), g.groups("el_src")
        m_ji = _edge_message(self.mlp_m_ji, x, rbf, i, j, plain=plain,
                             i_groups=i_groups, j_groups=j_groups)
        m_neighbor = _edge_message(self.mlp_m_kj, x, rbf, i, j, self.lin_rbf(rbf),
                                   plain=plain, i_groups=i_groups, j_groups=j_groups)

        if isinstance(sbf2, FoldedSBF):
            m2 = self._modulate(m_neighbor, sbf2, g.t2_kj, g.t2_mask, plain)
            m1 = self._modulate(m_neighbor, sbf1, g.t1_jj, g.t1_mask, plain)
            m_other = (
                aggregate(m2, g.t2_ji_off, g.t2_ji, g.t2_mask, num_edges,
                          total=g.valid["t2"], plain=plain)
                + aggregate(m1, g.t1_ji_off, g.t1_ji, g.t1_mask, num_edges,
                            total=g.valid["t1"], plain=plain)
            )
        else:
            # The gradient reaches mlp_sbf through b (kernel A's d_b).
            b2 = self.mlp_sbf(sbf2) * g.t2_mask[:, None]
            b1 = self.mlp_sbf(sbf1) * g.t1_mask[:, None]
            m_other = (
                aggregate(m_neighbor, g.t2_ji_off, g.t2_ji, g.t2_mask, num_edges,
                          idx=g.t2_kj, b=b2, total=g.valid["t2"], plain=plain,
                          grad=g.triplet_grad("t2"))
                + aggregate(m_neighbor, g.t1_ji_off, g.t1_ji, g.t1_mask, num_edges,
                            idx=g.t1_jj, b=b1, total=g.valid["t1"], plain=plain,
                            grad=g.triplet_grad("t1"))
            )
        return self._tail(x, res_x, m_ji + m_other, rbf, g, plain)

    def _tail(self, x, res_x, m, rbf, g, plain):
        """rbf gating, edge->node sum at el_dst, residual update and heads
        (reference: local_message_passing.py:53-66)."""
        m = self.lin_rbf_out(rbf) * m * g.el_mask[:, None]
        x = x + aggregate(m, g.el_dst_off, g.el_dst, g.el_mask, x.shape[0],
                          total=g.valid["el"], plain=plain)
        x = self.mlp_x2(x)
        x = self.res1(x) + res_x
        x = self.res3(self.res2(x))
        out = self.mlp_out(x)
        return x, self.W_out(out), out @ self.W
