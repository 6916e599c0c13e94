"""Gather - modulate - segmented sum over CSR offsets (kernel A), and its
backward.

    out[e, :] = sum_{r in [off[e], off[e+1])} a[idx[r], :] * b[r, :]

``idx=None`` sums rows of ``a`` directly (a row per summed row) and
``b=None`` skips the modulation, so one operation serves every aggregation
of the forward (a modulated sum without a gather, which no layer uses, has
no backward and raises under grad).  The rows must be sorted by their output row; ``off`` is the
(num_out+1,) int32 CSR offset array that batches carry.

``triplet_aggregate`` is the entry point, a ``torch.autograd.Function``: on
CPU tensors its forward and backward run plain PyTorch versions, on CUDA
tensors they launch ``csrc/triplet_aggregate.cu`` and
``csrc/gather_backward.cu``.  It replaces the Pallas kernel
``pamnet_tpu/ops/pallas_triplet.py:47`` and its custom VJP (:117-133):

    d_a[v] = sum_{r: idx[r] = v} g[seg[r]] * b[r]     kernel A, roles swapped
    d_b[r] = a[idx[r]] * g[seg[r]]                    ``gather_product``

where ``seg[r]`` is the output row of row ``r``.  The role swap sums over the
CSR of ``idx`` (``Groups``: a permutation sorting the rows by ``idx`` and its
offsets, built on the host per batch), reading ``g`` through ``seg[perm]``
and ``b`` through ``perm``.  ``group_sum`` is kernel A over such a CSR
alone: the backward of every row gather (``ops/gather.py``).

Padded rows: a CSR's last offset is the batch's valid row count, so padded
rows never enter a sum, forward or backward.  The sums of this module are
exact with padding.  The row gathers' backward is exact because the model
masks every padded row before any sum or pool, so a padded row's cotangent
is zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pamnet_tpu_torch.ops import _build


class Groups(NamedTuple):
    """The rows of an array grouped by an integer key (its CSR): group ``k``
    holds rows ``perm[off[k]:off[k+1]]``, or rows ``off[k]:off[k+1]`` when
    ``perm`` is None (the rows are sorted by the key).  ``off`` (groups+1,)
    int32 with ``off[-1]`` the valid row count, which ``total`` gives on the
    host where known; ``perm`` (rows,) int32 with the padded rows parked at
    its end."""

    off: torch.Tensor
    perm: torch.Tensor | None = None
    total: int | None = None


class AggregateGrad(NamedTuple):
    """What the backward of ``triplet_aggregate`` reads besides its forward
    inputs: ``seg`` (rows,) the output row of each row (the key the rows are
    sorted by); with a gather, ``by_idx`` the ``Groups`` of ``idx`` and
    ``seg_by_idx`` = ``seg[by_idx.perm]``, built on the host."""

    seg: torch.Tensor
    by_idx: Groups | None = None
    seg_by_idx: torch.Tensor | None = None


def triplet_aggregate_plain(a: torch.Tensor, off: torch.Tensor,
                            idx: torch.Tensor | None = None,
                            b: torch.Tensor | None = None,
                            bidx: torch.Tensor | None = None) -> torch.Tensor:
    """Reference version: gather, multiply, ``index_add_``.  ``bidx`` reads
    the modulation ``b[bidx[r]]`` instead of ``b[r]``."""
    num_out = off.shape[0] - 1
    rows = int(off[-1])
    seg = torch.repeat_interleave(
        torch.arange(num_out, device=a.device), (off[1:] - off[:-1]).long(),
        output_size=rows,
    )
    vals = a[idx[:rows].long()] if idx is not None else a[:rows]
    if b is not None:
        vals = vals * (b[bidx[:rows].long()] if bidx is not None else b[:rows])
    out = a.new_zeros((num_out, a.shape[1]))
    return out.index_add_(0, seg, vals)


def _kernel_a(what: str, a, off, idx, b, bidx, total):
    """Check the operands and launch kernel A on the current stream."""
    dev = a.device
    d = a.shape[1] if a.dim() == 2 else -1
    if d % 4 or d <= 0:
        raise ValueError(f"{what}: a must be (rows, D) with D % 4 == 0, "
                         f"got {tuple(a.shape)}")
    rows = next(t for t in (idx, bidx, b, a) if t is not None).shape[0]
    f32, i32 = torch.float32, torch.int32
    operands = {"a": (a, f32, (None, d)), "off": (off, i32, (None,)),
                "idx": (idx, i32, (rows,)), "bidx": (bidx, i32, (rows,)),
                "b": (b, f32, (None if bidx is not None else rows, d))}
    for name, (t, dtype, shape) in operands.items():
        if t is not None:
            _build.check_operand(what, name, t, dtype, dev, shape)
    limit = rows if idx is not None else min(rows, a.shape[0])
    if total is not None and not 0 <= total <= limit:
        raise ValueError(f"{what}: off[-1] = {total}, but the inputs hold "
                         f"{limit} rows")
    num_out = off.shape[0] - 1
    out = torch.empty((num_out, d), dtype=a.dtype, device=dev)
    if num_out == 0:
        return out
    lib = _build.library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_triplet_aggregate(ptr(a), ptr(b), ptr(idx), ptr(bidx),
                                            off.data_ptr(), out.data_ptr(), num_out,
                                            d, stream)
    _build.check(code, what)
    return out


def _forward(a, off, idx, b, total):
    """Kernel A on CUDA tensors (counted), the plain version on CPU ones."""
    if a.device.type == "cpu":
        return triplet_aggregate_plain(a, off, idx, b)
    out = _kernel_a("triplet_aggregate", a, off, idx, b, None, total)
    if out.shape[0]:
        triplet_aggregate.launches += 1
    return out


class _TripletAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, off, idx, total, grad):
        ctx.total, ctx.grad = total, grad
        ctx.save_for_backward(a, b, idx)
        return _forward(a, off, idx, b, total)

    @staticmethod
    def backward(ctx, g):
        a, b, idx = ctx.saved_tensors
        grad, total = ctx.grad, ctx.total
        g = g.contiguous()
        d_a = d_b = None
        if ctx.needs_input_grad[0]:
            if idx is not None:
                d_a = triplet_aggregate_grad_a(g, grad.by_idx, grad.seg_by_idx, b)
            else:
                from pamnet_tpu_torch.ops.gather import row_gather

                d_a = row_gather(g, grad.seg, valid=total)
        if ctx.needs_input_grad[1]:
            d_b = gather_product(a, idx, g, grad.seg, total)
        return d_a, d_b, None, None, None, None


def _check_grad_inputs(a, b, idx, total, grad: AggregateGrad | None, needs_a: bool):
    """Raise unless ``total`` and ``grad`` hold what the backward reads: a
    gradient is never dropped without a word, and the backward never reads
    ``off`` back from the card."""
    if grad is None:
        raise ValueError("triplet_aggregate: an input requires grad, so the "
                         "backward needs grad=AggregateGrad(seg, ...)")
    if idx is None and b is not None:
        raise ValueError("triplet_aggregate: a modulated sum without a gather "
                         "has no backward")
    if total is None:
        raise ValueError("triplet_aggregate: an input requires grad, so the "
                         "backward needs total = off[-1] from the host")
    rows = (idx if idx is not None else a).shape[0]
    if grad.seg.shape != (rows,):
        raise ValueError(f"triplet_aggregate: grad.seg must be ({rows},), got "
                         f"{tuple(grad.seg.shape)}")
    if needs_a and idx is not None:
        if grad.by_idx is None or grad.seg_by_idx is None:
            raise ValueError("triplet_aggregate: the gradient of a gathered a "
                             "needs grad.by_idx and grad.seg_by_idx")
        if grad.by_idx.perm is None or grad.by_idx.off.shape[0] != a.shape[0] + 1:
            raise ValueError("triplet_aggregate: grad.by_idx must be the "
                             f"permuted CSR of idx over the {a.shape[0]} rows of a")


def triplet_aggregate(a: torch.Tensor, off: torch.Tensor,
                      idx: torch.Tensor | None = None,
                      b: torch.Tensor | None = None,
                      total: int | None = None,
                      grad: AggregateGrad | None = None) -> torch.Tensor:
    """(num_out, D) sums, differentiable in ``a`` and ``b``; the plain
    version for CPU tensors, the CUDA kernels for CUDA tensors.  ``total``
    is ``off[-1]`` where the caller knows it on the host (the batch's valid
    row count): the rows the kernel reads are then checked without reading
    ``off`` back from the card.  ``total`` and ``grad``, the index arrays of
    the backward, must be given when ``a`` or ``b`` requires grad.  Counts
    its forward kernel launches in ``triplet_aggregate.launches``."""
    needs_a = a.requires_grad
    if not (torch.is_grad_enabled() and (needs_a or (b is not None and b.requires_grad))):
        return _forward(a, off, idx, b, total)  # no gradient wanted: no graph node
    _check_grad_inputs(a, b, idx, total, grad, needs_a)
    return _TripletAggregate.apply(a, b, off, idx, total, grad)


triplet_aggregate.launches = 0


def triplet_aggregate_grad_a_plain(g, by_idx: Groups, seg_by_idx, b=None) -> torch.Tensor:
    """Reference version of ``triplet_aggregate_grad_a``."""
    return triplet_aggregate_plain(g, by_idx.off, seg_by_idx, b,
                                   None if b is None else by_idx.perm)


def triplet_aggregate_grad_a(g: torch.Tensor, by_idx: Groups,
                             seg_by_idx: torch.Tensor,
                             b: torch.Tensor | None = None) -> torch.Tensor:
    """d_a of a gathered sum: kernel A with roles swapped,
    ``d_a[v] = sum_{r in [off[v], off[v+1])} g[seg_by_idx[r]] * b[perm[r]]``
    over ``by_idx`` = (perm, off), the CSR of the forward's ``idx``.  Counts
    its kernel launches in ``triplet_aggregate_grad_a.launches``."""
    if g.device.type == "cpu":
        return triplet_aggregate_grad_a_plain(g, by_idx, seg_by_idx, b)
    out = _kernel_a("triplet_aggregate_grad_a", g, by_idx.off, seg_by_idx, b,
                    None if b is None else by_idx.perm, by_idx.total)
    if out.shape[0]:
        triplet_aggregate_grad_a.launches += 1
    return out


triplet_aggregate_grad_a.launches = 0


def group_sum_plain(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """Reference version of ``group_sum``."""
    return triplet_aggregate_plain(x, groups.off, groups.perm)


def group_sum(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """(groups, D): ``out[k] = sum of x[r] over the rows r of group k``, the
    backward of a row gather ``src[idx]`` over the CSR of ``idx``: kernel A,
    gathering through ``groups.perm`` (or reading sorted rows in place).
    Counts its kernel launches in ``group_sum.launches``."""
    if x.device.type == "cpu":
        return group_sum_plain(x, groups)
    out = _kernel_a("group_sum", x, groups.off, groups.perm, None, None, groups.total)
    if out.shape[0]:
        group_sum.launches += 1
    return out


group_sum.launches = 0


def gather_product_plain(x, xi, y, yi, valid: int) -> torch.Tensor:
    """Reference version of ``gather_product``."""
    out = x.new_zeros((xi.shape[0], x.shape[1]))
    out[:valid] = x[xi[:valid].long()] * y[yi[:valid].long()]
    return out


def gather_product(x: torch.Tensor, xi: torch.Tensor, y: torch.Tensor,
                   yi: torch.Tensor, valid: int) -> torch.Tensor:
    """(rows, D): ``out[r] = x[xi[r]] * y[yi[r]]`` for ``r < valid``, zero
    after: the d_b of kernel A's gathered sum, ``a[idx] * g[seg]``.  The
    plain version for CPU tensors, ``csrc/gather_backward.cu`` for CUDA
    tensors; counts its kernel launches in ``gather_product.launches``."""
    if x.device.type == "cpu":
        return gather_product_plain(x, xi, y, yi, valid)
    dev = x.device
    rows = xi.shape[0]
    d = x.shape[1] if x.dim() == 2 else -1
    if d % 4 or d <= 0:
        raise ValueError(f"gather_product: needs D % 4 == 0, got {tuple(x.shape)}")
    f32, i32 = torch.float32, torch.int32
    operands = {"x": (x, f32, (None, d)), "xi": (xi, i32, (rows,)),
                "y": (y, f32, (None, d)), "yi": (yi, i32, (rows,))}
    for name, (t, dtype, shape) in operands.items():
        _build.check_operand("gather_product", name, t, dtype, dev, shape)
    if not 0 <= valid <= rows:
        raise ValueError(f"gather_product: valid = {valid} outside [0, {rows}]")
    out = torch.empty((rows, d), dtype=f32, device=dev)
    if rows == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_gather_product(x.data_ptr(), xi.data_ptr(), y.data_ptr(),
                                         yi.data_ptr(), out.data_ptr(), rows, valid, d,
                                         stream)
    _build.check(code, "gather_product")
    gather_product.launches += 1
    return out


gather_product.launches = 0
