"""Message-passing layers of PAMNet (reference: global_message_passing.py,
local_message_passing.py; JAX counterpart ``pamnet_tpu/models/layers.py``).

Every aggregation goes through ``ops.triplet.triplet_aggregate`` over the
batch's CSR offsets, every edge message through ``ops.gather.edge_message``
(which gathers its node rows itself; the global layer's sums its messages
by node itself where the batch's rows are sorted by that node,
``out_groups``), and each folded triplet stream
through ``ops.sbf_modulate.sbf_modulate``, which sums its rows by center
edge itself (``out_groups``: the batch's ``t2_ji_off``/``t1_ji_off``), so
the folded path runs no kernel A sum over the triplets.  The layers hand
those autograd Functions the batch's backward arrays (``GraphBatch.groups``,
``triplet_grad``), so a loss differentiates through the backward kernels.
``plain=True`` calls the plain PyTorch versions of the kernels on any
device, which PyTorch's own autograd differentiates: the reference route
that checks the kernels and their backwards on the card.  The layers run in
their input's type (float32 or bfloat16, ``config.py``); the masks come in
that type too (``models/pamnet.py``), and weights are cast at each use
(``nn.as_dtype``).  Layers return ``(x, out, att)``: the new node
state, the per-node scalar head and the attention logit of the fusion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from pamnet_tpu_torch.nn import Linear, Res, as_dtype, mlp
from pamnet_tpu_torch.ops.gather import (edge_message, edge_message_plain, row_gather,
                                         row_gather_plain)
from pamnet_tpu_torch.ops.sbf_modulate import sbf_modulate, sbf_modulate_plain
from pamnet_tpu_torch.ops.triplet import (AggregateGrad, Groups, acc_dtype, triplet_aggregate,
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
        args = (self.mlp_m, x, edge_attr, i_idx, j_idx, self.W_edge_attr(edge_attr),
                g.eg_mask, plain, g.groups(i_key), g.groups(j_key))
        if getattr(g, i_key + "_off") is not None:
            # Rows sorted by i: the message summed by node in one kernel.
            x = x + _edge_message(*args, out_groups=g.groups(i_key))
        else:
            x = x + aggregate(_edge_message(*args), None, i_idx, g.eg_mask, x.shape[0],
                              plain=plain)
        x = self.mlp_x2(x)
        x = self.res1(x) + res_x
        x = self.res3(self.res2(x))
        out = self.mlp_out(x)
        return x, self.W_out(out), out @ as_dtype(self.W, out.dtype)


def _edge_message(mlp_m: nn.Sequential, x, e, i, j, gate=None, mask=None,
                  plain: bool = False, i_groups: Groups | None = None,
                  j_groups: Groups | None = None, out_groups: Groups | None = None):
    """silu(W @ concat(x_i, x_j, e) + b) * gate * mask with the x-projections
    hoisted to node level (reference: local_message_passing.py:40-46 and
    the message of global_message_passing.py); the kernel gathers the
    projected rows by ``i``/``j`` itself, and its backward sums over
    ``i_groups``/``j_groups``, the CSRs of ``i``/``j``.  With ``out_groups``,
    the sorted CSR of ``i``, the (N, D) sums of the messages by ``i``."""
    dim = x.shape[1]
    lin = mlp_m[0][0]
    w = as_dtype(lin.weight, x.dtype)  # (dim, 3*dim) = [x_i | x_j | e]
    args = (x @ w[:, :dim].T, x @ w[:, dim:2 * dim].T, i, j,
            F.linear(e, w[:, 2 * dim:], as_dtype(lin.bias, x.dtype)), gate, mask)
    if plain:
        return edge_message_plain(*args, None if out_groups is None else out_groups.off)
    return edge_message(*args, i_groups=i_groups, j_groups=j_groups, out_groups=out_groups)


class LocalMP(nn.Module):
    """One local-plex layer: with ``variant="full"`` the two-hop and one-hop
    triplet streams (reference: local_message_passing.py:36-66), with
    ``variant="s"`` (PAMNet_s) the one-hop stream alone, its neighbour
    message named ``mlp_m_jj`` (reference: local_message_passing.py:69-123;
    JAX ``local_mp_s``).  Both share the tail."""

    def __init__(self, dim: int, variant: str = "full"):
        super().__init__()
        self.mlp_x1 = mlp([dim, dim])
        self.mlp_m_ji = mlp([3 * dim, dim])
        self.two_hop = variant == "full"
        # Same shape, the reference's name for each variant.
        self.neighbor_name = "mlp_m_kj" if self.two_hop else "mlp_m_jj"
        setattr(self, self.neighbor_name, mlp([3 * dim, dim]))
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

    def _modulate(self, m_neighbor, folded: FoldedSBF, g, kind: str, plain):
        """The folded stage of triplet stream ``kind`` ("t2" or "t1";
        kernel B) summed by center edge: (El, dim).  Its backward walks the
        CSR of the neighbour index and reads the center edge of each
        triplet."""
        idx = g.t2_kj if kind == "t2" else g.t1_jj
        dt = m_neighbor.dtype
        s1, s2 = self.mlp_sbf[0][0], self.mlp_sbf[1][0]
        args = (folded.proj, m_neighbor, folded.cbf, folded.bias, as_dtype(s1.weight, dt),
                as_dtype(s1.bias, dt), as_dtype(s2.weight, dt), as_dtype(s2.bias, dt), idx,
                getattr(g, kind + "_mask"))
        center = g.groups(kind + "_ji")
        if center is None:
            raise ValueError(f"LocalMP: the folded path needs the batch's triplets "
                             f"sorted by {kind}_ji ({kind}_ji_off)")
        if plain:
            return sbf_modulate_plain(*args, out_off=center.off)
        return sbf_modulate(*args, groups=g.groups("t2_kj" if kind == "t2" else "t1_jj"),
                            out_groups=center, out_ids=getattr(g, kind + "_ji"))

    def forward(self, x, rbf, sbf2, sbf1, g, plain: bool = False):
        """``sbf2``/``sbf1``: (T, dim) outputs of the model-level sbf MLPs,
        or ``FoldedSBF`` inputs of the fused folded path (``sbf2`` None for
        PAMNet_s); ``g`` the batch."""
        j, i = g.el_src, g.el_dst
        res_x = x
        x = self.mlp_x1(x)
        i_groups, j_groups = g.groups("el_dst"), g.groups("el_src")
        m_ji = _edge_message(self.mlp_m_ji, x, rbf, i, j, plain=plain,
                             i_groups=i_groups, j_groups=j_groups)
        m_neighbor = _edge_message(getattr(self, self.neighbor_name), x, rbf, i, j,
                                   self.lin_rbf(rbf), plain=plain, i_groups=i_groups,
                                   j_groups=j_groups)
        if self.two_hop:
            m_other = (self._stream(m_neighbor, sbf2, g, "t2", plain)
                       + self._stream(m_neighbor, sbf1, g, "t1", plain))
        else:
            m_other = self._stream(m_neighbor, sbf1, g, "t1", plain)
        return self._tail(x, res_x, m_ji + m_other, rbf, g, plain)

    def _stream(self, m_neighbor, sbf, g, kind: str, plain):
        """Triplet stream ``kind`` ("t2" or "t1") summed by center edge:
        kernel B folded, else kernel A gathering ``m_neighbor`` and
        modulating it by ``mlp_sbf(sbf)`` (the gradient reaches mlp_sbf
        through b, kernel A's d_b)."""
        if isinstance(sbf, FoldedSBF):
            return self._modulate(m_neighbor, sbf, g, kind, plain)
        mask = getattr(g, kind + "_mask")
        return aggregate(m_neighbor, getattr(g, kind + "_ji_off"), getattr(g, kind + "_ji"),
                         mask, m_neighbor.shape[0],
                         idx=g.t2_kj if kind == "t2" else g.t1_jj,
                         b=self.mlp_sbf(sbf) * mask[:, None], total=g.valid[kind],
                         plain=plain, grad=g.triplet_grad(kind))

    def _tail(self, x, res_x, m, rbf, g, plain):
        """rbf gating, edge->node sum at el_dst, residual update and heads
        (reference: local_message_passing.py:53-66).  Where the batch's
        edges are sorted by el_dst, the gate rides in the sum as kernel A's
        modulation ``b`` and its backward is one kernel
        (``gated_sum_backward``); the ``el_mask`` product is the CSR's valid
        count there, since a batch's ``el_mask`` is 1 on exactly the rows
        ``[0, valid["el"])``.  The plain and the argsort routes multiply,
        then sum, as the reference does: ``aggregate(..., b=gate)`` would
        give the same sums there, but the branch keeps the plain route a
        transcription of the reference that does not rest on that
        invariant, so it can check the kernel route that does.  The plain
        route multiplies in float32, as the kernel does, and rounds once
        after the sum (a bfloat16 product per edge would round where the
        kernel does not)."""
        gate = self.lin_rbf_out(rbf)
        if g.el_dst_off is not None and not plain:
            s = aggregate(m, g.el_dst_off, g.el_dst, g.el_mask, x.shape[0], b=gate,
                          total=g.valid["el"])
        else:
            acc = acc_dtype(m.dtype) if plain else m.dtype
            s = aggregate(gate.to(acc) * m.to(acc) * g.el_mask[:, None].to(acc), g.el_dst_off,
                          g.el_dst, g.el_mask, x.shape[0], total=g.valid["el"],
                          plain=plain).to(m.dtype)
        x = x + s
        x = self.mlp_x2(x)
        x = self.res1(x) + res_x
        x = self.res3(self.res2(x))
        out = self.mlp_out(x)
        return x, self.W_out(out), out @ as_dtype(self.W, out.dtype)
