"""The folded spherical-basis modulate stage of the local layer (kernel B),
a ``torch.autograd.Function`` with a backward kernel.

For each triplet t with neighbour edge e = idx[t]:

    acc = bias + sum_l cbf[t, l] * proj[e, l*D:(l+1)*D]
    h   = silu(silu(silu(acc) @ w1.T + b1) @ w2.T + b2) * mask[t]
    out[t] = m_neighbor[e] * h

which is ``pamnet_tpu/models/layers.py::_fused_sbf_gather`` with the
layer's 2-stage ``mlp_sbf`` given as torch (out, in) weights.
``sbf_modulate`` runs the plain version on CPU tensors (PyTorch's autograd
differentiates it) and launches ``csrc/sbf_modulate.cu`` and, in the
backward, ``csrc/sbf_modulate_backward.cu`` on CUDA tensors.  It replaces the
Pallas kernel of ``tools/fused_sbf_kernel_probe.py:42`` and the gradient JAX
takes of it by autodiff.

Backward: ``d_proj`` and ``d_m_neighbor`` are sums over the triplets of each
edge, so the backward reads the CSR of ``idx`` (``Groups``: the permutation
that sorts the triplets by ``idx`` and its offsets, which training batches
carry); the weight gradients are sums over all triplets.  Triplets past
``groups.total`` (padded, mask 0) enter no sum.  ``cbf`` and ``mask`` are
geometry and take no gradient.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from pamnet_tpu_torch.ops import _build
from pamnet_tpu_torch.ops.triplet import Groups

# (num_spherical, dim) pairs the CUDA sources are compiled for.
KERNEL_SHAPES = ((7, 16), (7, 8))
# Threads of a block of the backward's per-triplet pass: one row of its
# partial weight sums per block.
_BACKWARD_BLOCK = 256


def sbf_modulate_plain(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask):
    """Reference version: one gather of concat(proj, m_neighbor), slice
    multiply-adds, the 2-stage MLP, mask and modulation.  The gather is an
    ``index_select``, whose backward (``index_add_``) sums in one order on
    the CPU, where advanced indexing's does not."""
    d = m_neighbor.shape[1]
    ns = proj.shape[1] // d
    rows = torch.cat([proj, m_neighbor], dim=1).index_select(0, idx.long())
    acc = bias
    for l in range(ns):
        acc = acc + cbf[:, l:l + 1] * rows[:, l * d:(l + 1) * d]
    h = F.silu(F.linear(F.silu(acc), w1, b1))
    h = F.silu(F.linear(h, w2, b2)) * mask[:, None]
    return rows[:, ns * d:] * h


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


def _forward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask):
    """The forward kernel on CUDA tensors (counted), the plain version on
    CPU ones."""
    if m_neighbor.device.type == "cpu":
        return sbf_modulate_plain(proj, m_neighbor, cbf, bias, w1, b1, w2, b2,
                                  idx, mask)
    dev, t_count, ns, d = _check_operands("sbf_modulate", proj, m_neighbor, cbf, bias,
                                          w1, b1, w2, b2, idx, mask)
    out = torch.empty((t_count, d), dtype=torch.float32, device=dev)
    if t_count == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_sbf_modulate(
            proj.data_ptr(), m_neighbor.data_ptr(), cbf.data_ptr(),
            bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), idx.data_ptr(), mask.data_ptr(), out.data_ptr(),
            t_count, ns, d, stream,
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
                          groups: Groups, g: torch.Tensor):
    """``(d_proj, d_m_neighbor, d_bias, d_w1, d_b1, d_w2, d_b2)`` of
    ``sbf_modulate`` for the output gradient ``g`` (T, D), on CUDA tensors:
    launches ``csrc/sbf_modulate_backward.cu`` (a per-triplet pass that
    recomputes the forward, a fixed-order sum of the blocks' weight
    gradients and a per-edge sum over ``groups``) and counts the call in
    ``sbf_modulate_backward.launches``.  The plain version of this function
    is PyTorch's autograd of ``sbf_modulate_plain``."""
    dev, t_count, ns, d = _check_operands(
        "sbf_modulate_backward", proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
        {"g": (g, torch.float32, (idx.shape[0], m_neighbor.shape[1])),
         "groups.perm": (groups.perm, torch.int32, (idx.shape[0],)),
         "groups.off": (groups.off, torch.int32, (m_neighbor.shape[0] + 1,))})
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
        # The grid follows the padded triplet count alone, so a batch's sums
        # are taken in one order whatever its valid count.
        blocks = -(-t_count // _BACKWARD_BLOCK)
        # One scratch allocation for what only the kernels read back: the
        # per-triplet d_acc and g*h rows and the blocks' partial weight sums.
        # wgrad is returned (as views), so it is its own small tensor.
        scratch = torch.empty(2 * t_count * d + blocks * width, dtype=f32, device=dev)
        d_acc, d_mrow, partial = scratch.split((t_count * d, t_count * d, blocks * width))
        wgrad = torch.empty(width, dtype=f32, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.pamnet_sbf_modulate_backward(
                proj.data_ptr(), m_neighbor.data_ptr(), cbf.data_ptr(), bias.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                idx.data_ptr(), mask.data_ptr(), g.data_ptr(), groups.perm.data_ptr(),
                groups.off.data_ptr(), d_acc.data_ptr(), d_mrow.data_ptr(),
                partial.data_ptr(), wgrad.data_ptr(), d_proj.data_ptr(), d_m.data_ptr(),
                blocks, groups.total, num_edges, ns, d, stream,
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
    def forward(ctx, proj, m_neighbor, bias, w1, b1, w2, b2, cbf, idx, mask, groups):
        ctx.groups = groups
        ctx.save_for_backward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask)
        return _forward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask)

    @staticmethod
    def backward(ctx, g):
        grads = sbf_modulate_backward(*ctx.saved_tensors, ctx.groups, g.contiguous())
        # Inputs in forward's order: proj, m_neighbor, bias, w1, b1, w2, b2.
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad)) + (None,) * 4


def sbf_modulate(proj: torch.Tensor, m_neighbor: torch.Tensor,
                 cbf: torch.Tensor, bias: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 idx: torch.Tensor, mask: torch.Tensor,
                 groups: Groups | None = None) -> torch.Tensor:
    """(T, D) modulated triplet messages, differentiable in ``proj``,
    ``m_neighbor``, ``bias`` and the weights through ``groups``, the permuted
    CSR of ``idx`` (needed, with its ``total``, when any of them requires
    grad; the mask must be 0 past ``total``).  The plain version for CPU
    tensors, the CUDA kernels for CUDA tensors.  Counts its forward kernel
    launches in ``sbf_modulate.launches``."""
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (proj, m_neighbor, cbf, bias, w1, b1, w2, b2, mask))):
        return _forward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask)  # no graph node
    if cbf.requires_grad or mask.requires_grad:
        raise ValueError("sbf_modulate: cbf and mask are geometry and take no gradient")
    _check_groups(groups, m_neighbor.shape[0], idx.shape[0])
    if m_neighbor.device.type == "cpu":
        return sbf_modulate_plain(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask)
    return _SbfModulate.apply(proj, m_neighbor, bias, w1, b1, w2, b2, cbf, idx, mask,
                              groups)


sbf_modulate.launches = 0
