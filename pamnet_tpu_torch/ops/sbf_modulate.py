"""The folded spherical-basis modulate stage of the local layer (kernel B),
summed by center edge, a ``torch.autograd.Function`` with a backward kernel.

For each triplet t with neighbour edge e = idx[t]:

    acc = bias + sum_l cbf[t, l] * proj[e, l*D:(l+1)*D]
    h   = silu(silu(silu(acc) @ w1.T + b1) @ w2.T + b2) * mask[t]
    row(t) = m_neighbor[e] * h

which is ``pamnet_tpu/models/layers.py::_fused_sbf_gather`` with the
layer's 2-stage ``mlp_sbf`` given as torch (out, in) weights.  With
``out_groups``, the sorted CSR of the triplets' center edges (the batch's
``t2_ji_off``/``t1_ji_off``), the op returns ``out[c] = sum of row(t) over
the triplets of center edge c``: the JAX package's ``_fused_sbf_gather``
followed by its segment sum at ``t2_ji``/``t1_ji``
(``pamnet_tpu/models/layers.py:324-332``), which kernel A took over the
(T, D) rows before.  Without it the op returns the (T, D) rows.

``sbf_modulate`` runs the plain version on CPU tensors (PyTorch's autograd
differentiates it) and launches ``csrc/sbf_modulate.cu`` and, in the
backward, ``csrc/sbf_modulate_backward.cu`` on CUDA tensors; both kernels
serve both modes (without ``out_groups`` they write or read a row per
triplet).
It replaces the Pallas kernel of ``tools/fused_sbf_kernel_probe.py:42`` and
the gradient JAX takes of it by autodiff.

Backward: ``d_proj`` and ``d_m_neighbor`` are sums over the triplets of each
neighbour edge, so the backward walks the CSR of ``idx`` (``groups``: the
permutation that sorts the triplets by ``idx`` and its offsets, which
training batches carry) and reads each triplet's output gradient at its
center edge (``out_ids``, the batch's ``t2_ji``/``t1_ji``); the weight
gradients are sums over all triplets.  Triplets past ``groups.total``
(padded, mask 0) enter no sum, and past ``out_groups.total`` no center
edge.  ``cbf`` and ``mask`` are geometry and take no gradient.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from pamnet_tpu_torch.ops import _build
from pamnet_tpu_torch.ops.triplet import Groups, triplet_aggregate_plain

# (num_spherical, dim) pairs the CUDA sources are compiled for.
KERNEL_SHAPES = ((7, 16), (7, 8))
# Threads of a block of the backward kernel, and the most blocks it takes:
# each block walks edges at a fixed stride and writes one row of partial
# weight sums; two blocks of 256 fit an SM's registers, 132 SMs.
_BACKWARD_BLOCK = 256
_BACKWARD_MAX_BLOCKS = 2 * 132


def sbf_modulate_plain(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
                       out_off: torch.Tensor | None = None):
    """Reference version: one gather of concat(proj, m_neighbor), slice
    multiply-adds, the 2-stage MLP, mask and modulation; with ``out_off``,
    kernel A's plain sum of those rows over the center edges' CSR.  The
    gather is an ``index_select``, whose backward (``index_add_``) sums in
    one order on the CPU, where advanced indexing's does not."""
    d = m_neighbor.shape[1]
    ns = proj.shape[1] // d
    rows = torch.cat([proj, m_neighbor], dim=1).index_select(0, idx.long())
    acc = bias
    for l in range(ns):
        acc = acc + cbf[:, l:l + 1] * rows[:, l * d:(l + 1) * d]
    h = F.silu(F.linear(F.silu(acc), w1, b1))
    h = F.silu(F.linear(h, w2, b2)) * mask[:, None]
    out = rows[:, ns * d:] * h
    return out if out_off is None else triplet_aggregate_plain(out, out_off)


def _check_operands(what, proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
                    extra=None):
    """Raise on what the kernels do not take; returns (device, T, ns, d)."""
    dev = m_neighbor.device
    t_count, d = idx.shape[0], m_neighbor.shape[1]
    ns = cbf.shape[1]
    f32, i32 = torch.float32, torch.int32
    operands = {
        "proj": (proj, f32, (m_neighbor.shape[0], ns * d)),
        "m_neighbor": (m_neighbor, f32, (m_neighbor.shape[0], d)),
        "cbf": (cbf, f32, (t_count, ns)),
        "bias": (bias, f32, (d,)), "b1": (b1, f32, (d,)), "b2": (b2, f32, (d,)),
        "w1": (w1, f32, (d, d)), "w2": (w2, f32, (d, d)),
        "idx": (idx, i32, (t_count,)), "mask": (mask, f32, (t_count,)),
        **(extra or {}),
    }
    for name, (t, dtype, shape) in operands.items():
        _build.check_operand(what, name, t, dtype, dev, shape)
    if (ns, d) not in KERNEL_SHAPES:
        raise ValueError(
            f"{what}: no kernel for num_spherical={ns}, dim={d} "
            f"(compiled for {KERNEL_SHAPES})"
        )
    return dev, t_count, ns, d


def _check_out_groups(out_groups: Groups | None, out_ids: torch.Tensor | None,
                      num_triplets: int, needs_ids: bool) -> None:
    """Raise unless ``out_groups`` is a sorted CSR over at most the
    ``num_triplets`` rows with its valid row count on the host and, where the
    backward reads them, ``out_ids`` holds a center edge per triplet."""
    if out_groups is None:
        return
    if (out_groups.off is None or out_groups.perm is not None or out_groups.total is None
            or out_groups.off.dim() != 1 or out_groups.off.shape[0] < 1
            or not 0 <= out_groups.total <= num_triplets):
        raise ValueError(
            f"sbf_modulate: out_groups must be the sorted CSR of the center edges "
            f"over the {num_triplets} triplets with its valid row count, got perm "
            f"{'None' if out_groups.perm is None else 'given'}, total {out_groups.total}")
    if needs_ids and (out_ids is None or tuple(out_ids.shape) != (num_triplets,)):
        raise ValueError(
            f"sbf_modulate: the backward of the summed op needs out_ids, the center "
            f"edge of each of the {num_triplets} triplets, got "
            f"{None if out_ids is None else tuple(out_ids.shape)}")


def _forward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
             out_groups: Groups | None = None):
    """The forward kernel on CUDA tensors (counted), the plain version on
    CPU ones; summed over ``out_groups`` where given."""
    out_off = None if out_groups is None else out_groups.off
    if m_neighbor.device.type == "cpu":
        return sbf_modulate_plain(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
                                  out_off)
    extra = None if out_off is None else {"out_groups.off": (out_off, torch.int32, (None,))}
    dev, t_count, ns, d = _check_operands("sbf_modulate", proj, m_neighbor, cbf, bias,
                                          w1, b1, w2, b2, idx, mask, extra)
    num_groups = t_count if out_off is None else out_off.shape[0] - 1
    out = torch.empty((num_groups, d), dtype=torch.float32, device=dev)
    if num_groups == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_sbf_modulate(
            proj.data_ptr(), m_neighbor.data_ptr(), cbf.data_ptr(),
            bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), idx.data_ptr(), mask.data_ptr(),
            None if out_off is None else out_off.data_ptr(), out.data_ptr(),
            num_groups, t_count, 0 if out_groups is None else out_groups.total, ns, d,
            stream,
        )
    _build.check(code, "sbf_modulate")
    sbf_modulate.launches += 1
    return out


def _check_groups(groups: Groups | None, num_edges: int, num_triplets: int) -> None:
    if groups is None:
        raise ValueError("sbf_modulate: an input requires grad, so the backward "
                         "needs the Groups of idx (its permuted CSR)")
    if (groups.perm is None or groups.total is None
            or groups.off.shape[0] != num_edges + 1
            or groups.perm.shape[0] != num_triplets
            or not 0 <= groups.total <= num_triplets):
        raise ValueError(
            f"sbf_modulate: the Groups of idx must be its permuted CSR over the "
            f"{num_edges} rows of m_neighbor with its valid row count, got "
            f"{groups.off.shape[0] - 1} groups, "
            f"perm {None if groups.perm is None else tuple(groups.perm.shape)}, "
            f"total {groups.total}")


def sbf_modulate_backward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
                          groups: Groups, g: torch.Tensor,
                          out_groups: Groups | None = None,
                          out_ids: torch.Tensor | None = None):
    """``(d_proj, d_m_neighbor, d_bias, d_w1, d_b1, d_w2, d_b2)`` of
    ``sbf_modulate`` for the output gradient ``g``, (T, D) or, with
    ``out_groups``/``out_ids``, (center edges, D), on CUDA tensors: launches
    ``csrc/sbf_modulate_backward.cu`` (a walk over each edge's triplets
    through ``groups`` that recomputes the forward, then a fixed-order sum
    of the blocks' weight gradients) and counts the call in
    ``sbf_modulate_backward.launches``.  The plain version of this function
    is PyTorch's autograd of ``sbf_modulate_plain``.  float32 only."""
    _build.f32_only("sbf_modulate_backward", proj, m_neighbor, g)
    t_count = idx.shape[0]
    _check_out_groups(out_groups, out_ids, t_count, needs_ids=True)
    g_rows = t_count if out_groups is None else out_groups.off.shape[0] - 1
    extra = {"g": (g, torch.float32, (g_rows, m_neighbor.shape[1])),
             "groups.perm": (groups.perm, torch.int32, (t_count,)),
             "groups.off": (groups.off, torch.int32, (m_neighbor.shape[0] + 1,))}
    if out_groups is not None:
        extra["out_ids"] = (out_ids, torch.int32, (t_count,))
    dev, t_count, ns, d = _check_operands(
        "sbf_modulate_backward", proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
        extra)
    num_edges = m_neighbor.shape[0]
    width = 2 * d * d + 3 * d
    f32 = torch.float32
    d_proj = torch.empty((num_edges, ns * d), dtype=f32, device=dev)
    d_m = torch.empty((num_edges, d), dtype=f32, device=dev)
    if t_count == 0 or num_edges == 0:
        wgrad = torch.zeros(width, dtype=f32, device=dev)
        d_proj.zero_()
        d_m.zero_()
    else:
        # The grid follows the padded edge count alone, so a batch's sums are
        # taken in one order whatever its triplets.
        per_block = _BACKWARD_BLOCK // d
        blocks = min(_BACKWARD_MAX_BLOCKS, -(-num_edges // per_block))
        partial = torch.empty(blocks * width, dtype=f32, device=dev)
        wgrad = torch.empty(width, dtype=f32, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.pamnet_sbf_modulate_backward(
                proj.data_ptr(), m_neighbor.data_ptr(), cbf.data_ptr(), bias.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                mask.data_ptr(), g.data_ptr(),
                None if out_groups is None else out_ids.data_ptr(),
                groups.perm.data_ptr(), groups.off.data_ptr(), partial.data_ptr(),
                wgrad.data_ptr(), d_proj.data_ptr(), d_m.data_ptr(), blocks, num_edges,
                t_count if out_groups is None else out_groups.total, ns, d, stream,
            )
        _build.check(code, "sbf_modulate_backward")
        sbf_modulate_backward.launches += 1
    dd = d * d
    d_w1, d_b1 = wgrad[:dd].view(d, d), wgrad[dd:dd + d]
    d_w2, d_b2 = wgrad[dd + d:2 * dd + d].view(d, d), wgrad[2 * dd + d:2 * dd + 2 * d]
    return d_proj, d_m, wgrad[2 * dd + 2 * d:], d_w1, d_b1, d_w2, d_b2


sbf_modulate_backward.launches = 0


class _SbfModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, proj, m_neighbor, bias, w1, b1, w2, b2, cbf, idx, mask, groups,
                out_groups, out_ids):
        ctx.groups, ctx.out_groups = groups, out_groups
        ctx.save_for_backward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask, out_ids)
        return _forward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask, out_groups)

    @staticmethod
    def backward(ctx, g):
        *inputs, out_ids = ctx.saved_tensors
        grads = sbf_modulate_backward(*inputs, ctx.groups, g.contiguous(), ctx.out_groups,
                                      out_ids)
        # Inputs in forward's order: proj, m_neighbor, bias, w1, b1, w2, b2.
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad)) + (None,) * 6


def sbf_modulate(proj: torch.Tensor, m_neighbor: torch.Tensor,
                 cbf: torch.Tensor, bias: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 idx: torch.Tensor, mask: torch.Tensor,
                 groups: Groups | None = None, out_groups: Groups | None = None,
                 out_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Modulated triplet messages: (T, D), or with ``out_groups`` (the
    sorted CSR of the center edges, with its ``total``) their (center edges,
    D) sums.  Differentiable in ``proj``, ``m_neighbor``, ``bias`` and the
    weights through ``groups``, the permuted CSR of ``idx``, and, summed,
    ``out_ids``, the center edge of each triplet (needed, with ``total``,
    when any of them requires grad; the mask must be 0 past
    ``groups.total``).  The plain version for CPU tensors, the CUDA kernels
    for CUDA tensors; float32 only (no bfloat16 version yet: a bfloat16
    model never folds, ``config.py``).  Counts its forward kernel launches in
    ``sbf_modulate.launches``."""
    _build.f32_only("sbf_modulate", proj, m_neighbor, cbf, mask)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (proj, m_neighbor, cbf, bias, w1, b1, w2, b2, mask))
    _check_out_groups(out_groups, out_ids, idx.shape[0], needs_ids=needs_grad)
    if not needs_grad:
        return _forward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
                        out_groups)  # no graph node
    if cbf.requires_grad or mask.requires_grad:
        raise ValueError("sbf_modulate: cbf and mask are geometry and take no gradient")
    _check_groups(groups, m_neighbor.shape[0], idx.shape[0])
    if m_neighbor.device.type == "cpu":
        return sbf_modulate_plain(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
                                  None if out_groups is None else out_groups.off)
    return _SbfModulate.apply(proj, m_neighbor, bias, w1, b1, w2, b2, cbf, idx, mask,
                              groups, out_groups, out_ids)


sbf_modulate.launches = 0
