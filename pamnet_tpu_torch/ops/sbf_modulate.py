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
(T, D) rows before.  Without it the op returns the (T, D) rows, which are
the sums over identity groups (``identity_groups``): the kernels have that
one form.

``sbf_modulate`` runs the plain version on CPU tensors (PyTorch's autograd
differentiates it) and launches ``csrc/sbf_modulate.cu`` and, in the
backward, ``csrc/sbf_modulate_backward.cu`` on CUDA tensors.
It replaces the Pallas kernel of ``tools/fused_sbf_kernel_probe.py:42`` and
the gradient JAX takes of it by autodiff.

Types: the float operands (``proj``, ``m_neighbor``, ``cbf``, ``mask``, the
bias and the weights, and in the backward the output gradient) are all
float32 or all bfloat16, the output and the gradients in that type too; the
kernels compute in float32 and round each output once, and so does the plain
version (``acc_dtype``).  A bfloat16 model hands the stage bfloat16 weights
(its batched parameter cast, ``nn.cast_parameters``), as the JAX package's
mixed precision casts the folded stage's operands to its compute type
(``pamnet_tpu/models/pamnet.py:185-230``).

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
from pamnet_tpu_torch.ops.triplet import Groups, acc_dtype, triplet_aggregate_plain

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
    kernel A's plain sum of those rows over the center edges' CSR.  In
    float32 for bfloat16 operands, rounded once to ``m_neighbor``'s type
    (the kernels' registers), so the backward's sums run in float32 too.
    The gather is an ``index_select``, whose backward (``index_add_``) sums
    in one order on the CPU, where advanced indexing's does not."""
    dt, f = m_neighbor.dtype, acc_dtype(m_neighbor.dtype)
    d = m_neighbor.shape[1]
    ns = proj.shape[1] // d
    rows = torch.cat([proj.to(f), m_neighbor.to(f)], dim=1).index_select(0, idx.long())
    cbf = cbf.to(f)
    acc = bias.to(f)
    for l in range(ns):
        acc = acc + cbf[:, l:l + 1] * rows[:, l * d:(l + 1) * d]
    h = F.silu(F.linear(F.silu(acc), w1.to(f), b1.to(f)))
    h = F.silu(F.linear(h, w2.to(f), b2.to(f))) * mask[:, None].to(f)
    out = rows[:, ns * d:] * h
    return (out if out_off is None else triplet_aggregate_plain(out, out_off)).to(dt)


def identity_groups(num_triplets: int, device) -> Groups:
    """Each triplet its own group: the sums over these are the (T, D) rows,
    bit for bit."""
    return Groups(torch.arange(num_triplets + 1, dtype=torch.int32, device=device), None,
                  num_triplets)


def _check_operands(what, proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
                    extra=None):
    """Raise on what the kernels do not take: every float operand in
    ``m_neighbor``'s type (float32 or bfloat16; a mixed call names the
    operand of the other type), ``proj`` and ``m_neighbor``
    16-byte aligned for the vector loads, the rest aligned to their element
    (the kernels read them a value at a time: a bfloat16 model's weights are
    views of one batched cast).  Returns (device, T, ns, d, bf16 flag)."""
    dev, dt = m_neighbor.device, m_neighbor.dtype
    bf16 = _build.dtype_flag(what, dt)
    t_count, d = idx.shape[0], m_neighbor.shape[1]
    ns = cbf.shape[1]
    i32 = torch.int32
    operands = {
        "proj": (proj, dt, (m_neighbor.shape[0], ns * d)),
        "m_neighbor": (m_neighbor, dt, (m_neighbor.shape[0], d)),
        "cbf": (cbf, dt, (t_count, ns)),
        "bias": (bias, dt, (d,)), "b1": (b1, dt, (d,)), "b2": (b2, dt, (d,)),
        "w1": (w1, dt, (d, d)), "w2": (w2, dt, (d, d)),
        "idx": (idx, i32, (t_count,)), "mask": (mask, dt, (t_count,)),
        **(extra or {}),
    }
    for name, (t, dtype, shape) in operands.items():
        vector = name in ("proj", "m_neighbor")
        _build.check_operand(what, name, t, dtype, dev, shape,
                             align=16 if vector else t.element_size())
    if (ns, d) not in KERNEL_SHAPES:
        raise ValueError(
            f"{what}: no kernel for num_spherical={ns}, dim={d} "
            f"(compiled for {KERNEL_SHAPES})"
        )
    return dev, t_count, ns, d, bf16


def _check_out_groups(out_groups: Groups, out_ids: torch.Tensor | None,
                      num_triplets: int, needs_ids: bool) -> None:
    """Raise unless ``out_groups`` is a sorted CSR over at most the
    ``num_triplets`` rows with its valid row count on the host and, where the
    backward reads them, ``out_ids`` holds a center edge per triplet."""
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


def _forward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask, out_groups: Groups):
    """The forward kernel on CUDA tensors (counted), the plain version on
    CPU ones: the sums over ``out_groups``."""
    if m_neighbor.device.type == "cpu":
        return sbf_modulate_plain(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
                                  out_groups.off)
    dev, t_count, ns, d, bf16 = _check_operands(
        "sbf_modulate", proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
        {"out_groups.off": (out_groups.off, torch.int32, (None,))})
    num_groups = out_groups.off.shape[0] - 1
    out = torch.empty((num_groups, d), dtype=m_neighbor.dtype, device=dev)
    if num_groups == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_sbf_modulate(
            proj.data_ptr(), m_neighbor.data_ptr(), cbf.data_ptr(),
            bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), idx.data_ptr(), mask.data_ptr(), out_groups.off.data_ptr(),
            out.data_ptr(), num_groups, t_count, out_groups.total, ns, d, bf16, stream,
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
    ``out_groups``/``out_ids``, (center edges, D), on CUDA tensors, in the
    operands' type: launches ``csrc/sbf_modulate_backward.cu`` (a walk over
    each edge's triplets through ``groups`` that recomputes the forward,
    then a fixed-order sum of the blocks' weight gradients; without
    ``out_groups`` over identity groups) and counts the call in
    ``sbf_modulate_backward.launches``.  The plain version of this function
    is PyTorch's autograd of ``sbf_modulate_plain``."""
    t_count = idx.shape[0]
    if out_groups is None:
        out_groups = identity_groups(t_count, m_neighbor.device)
        out_ids = out_groups.off[:-1]
    _check_out_groups(out_groups, out_ids, t_count, needs_ids=True)
    g_rows = out_groups.off.shape[0] - 1
    extra = {"g": (g, m_neighbor.dtype, (g_rows, m_neighbor.shape[1])),
             "groups.perm": (groups.perm, torch.int32, (t_count,)),
             "groups.off": (groups.off, torch.int32, (m_neighbor.shape[0] + 1,)),
             "out_ids": (out_ids, torch.int32, (t_count,))}
    dev, t_count, ns, d, bf16 = _check_operands(
        "sbf_modulate_backward", proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
        extra)
    num_edges = m_neighbor.shape[0]
    width = 2 * d * d + 3 * d
    dt = m_neighbor.dtype
    d_proj = torch.empty((num_edges, ns * d), dtype=dt, device=dev)
    d_m = torch.empty((num_edges, d), dtype=dt, device=dev)
    if t_count == 0 or num_edges == 0:
        wgrad = torch.zeros(width, dtype=dt, device=dev)
        d_proj.zero_()
        d_m.zero_()
    else:
        # The grid follows the padded edge count alone, so a batch's sums are
        # taken in one order whatever its triplets.  The blocks' partial
        # weight gradients are float32 in either type.
        per_block = _BACKWARD_BLOCK // d
        blocks = min(_BACKWARD_MAX_BLOCKS, -(-num_edges // per_block))
        partial = torch.empty(blocks * width, dtype=torch.float32, device=dev)
        wgrad = torch.empty(width, dtype=dt, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.pamnet_sbf_modulate_backward(
                proj.data_ptr(), m_neighbor.data_ptr(), cbf.data_ptr(), bias.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                mask.data_ptr(), g.data_ptr(), out_ids.data_ptr(),
                groups.perm.data_ptr(), groups.off.data_ptr(), partial.data_ptr(),
                wgrad.data_ptr(), d_proj.data_ptr(), d_m.data_ptr(), blocks, num_edges,
                out_groups.total, ns, d, bf16, stream,
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
    ``groups.total``).  Without ``out_groups`` the rows are the sums over
    ``identity_groups``.  The plain version for CPU tensors, the CUDA
    kernels for CUDA tensors; float32 or bfloat16 operands, all in one type.
    Counts its forward kernel launches in ``sbf_modulate.launches``."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (proj, m_neighbor, cbf, bias, w1, b1, w2, b2, mask))
    if out_groups is None:
        out_groups = identity_groups(idx.shape[0], idx.device)
        out_ids = out_groups.off[:-1]
    _check_out_groups(out_groups, out_ids, idx.shape[0], needs_ids=needs_grad)
    if not needs_grad:
        return _forward(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
                        out_groups)  # no graph node
    if cbf.requires_grad or mask.requires_grad:
        raise ValueError("sbf_modulate: cbf and mask are geometry and take no gradient")
    _check_groups(groups, m_neighbor.shape[0], idx.shape[0])
    if m_neighbor.device.type == "cpu":
        return sbf_modulate_plain(proj, m_neighbor, cbf, bias, w1, b1, w2, b2, idx, mask,
                                  out_groups.off)
    return _SbfModulate.apply(proj, m_neighbor, bias, w1, b1, w2, b2, cbf, idx, mask,
                              groups, out_groups, out_ids)


sbf_modulate.launches = 0
