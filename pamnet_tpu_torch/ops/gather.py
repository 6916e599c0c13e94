"""Row gathers of the forward, a plain row gather and the fused edge message,
as ``torch.autograd.Function``s with backward kernels.

    row_gather(src, idx)[r]      = src[idx[r]]
    edge_message(xi, xj, i, j, base, gate, mask)[r]
        = silu(xi[i[r]] + xj[j[r]] + base[r]) * gate[r] * mask[r]
    edge_message(..., out_groups=G)[v] = sum of those rows over group v of G

``gate`` and ``mask`` may be None (no factor).  ``out_groups`` is the sorted
CSR of ``i`` (``i[r] = v`` for the rows of group ``v``), so the summed form is
the global layer's message with its edge->node sum at ``i``
(``pamnet_tpu/models/layers.py:224-228``, ``global_mp``), in one kernel that
writes no (E, D) message.  On CPU tensors forward and backward run their
plain versions, on CUDA tensors they launch ``csrc/row_gather.cu``,
``csrc/gather_backward.cu`` and kernel A.  They replace the Pallas row
gathers of ``tools/vmem_gather_probe.py:42``, ``:62`` and ``:86``.

Backward: the gradient of a gathered table is a sum of the output gradient
by index, ``d_src[v] = sum_{r: idx[r] = v} g[r]``: ``group_sum`` (kernel A)
over the CSR of the index (``Groups``), built on the host per batch.  The
edge message's backward kernel recomputes the pre-activation and writes
``d_pre`` (= ``d_base``) and ``d_gate``; ``d_xi`` and ``d_xj`` are group sums
of ``d_pre`` by ``i`` and by ``j``.  Summed, the backward kernel reads the
(N, D) node gradient at each row's ``i`` and gives the rows past the CSR's
valid count zeros.  A CSR holds the valid rows only, so these
are exact when the padded rows' gradient is zero, which the model makes
sure of by masking every padded row before any sum or pool.

Types: float32 or bfloat16 rows, every float operand of a call (the mask
too) in one type and the outputs in it (``csrc/vec.cuh``); the arithmetic is
float32 and each output is rounded once, in the kernels as in the plain
versions.  The row gather is a copy of either type.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from pamnet_tpu_torch.ops import _build
from pamnet_tpu_torch.ops.triplet import (Groups, acc_dtype, group_sum,
                                          triplet_aggregate_plain, walk_shape)


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor,
                     valid: int | None = None) -> torch.Tensor:
    """Reference version: advanced indexing of a float32 copy of bfloat16
    rows (its backward sums a row's uses in float32 and rounds once); rows
    past ``valid`` are 0."""
    rows = src.to(acc_dtype(src.dtype))
    if valid is None or valid == idx.shape[0]:
        return rows[idx.long()].to(src.dtype)
    out = src.new_zeros((idx.shape[0], src.shape[1]))
    out[:valid] = rows[idx[:valid].long()]
    return out


def _row_gather(src, idx, valid):
    if src.device.type == "cpu":
        return row_gather_plain(src, idx, valid)
    dev = src.device
    bf16 = _build.dtype_flag("row_gather", src.dtype)
    _build.check_operand("row_gather", "src", src, src.dtype, dev, (None, None))
    _build.check_operand("row_gather", "idx", idx, torch.int32, dev, (None,))
    rows = idx.shape[0]
    valid = rows if valid is None else valid
    if not 0 <= valid <= rows:
        raise ValueError(f"row_gather: valid = {valid} outside [0, {rows}]")
    out = torch.empty((rows, src.shape[1]), dtype=src.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_row_gather(src.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                     rows, valid, src.shape[1], bf16, stream)
    _build.check(code, "row_gather")
    row_gather.launches += 1
    return out


def _need_groups(what: str, groups: Groups | None, rows: int, name: str):
    if groups is None:
        raise ValueError(f"{what}: {name} requires grad, so the backward needs "
                         f"the Groups of its index")
    if groups.off.shape[0] != rows + 1:
        raise ValueError(f"{what}: the Groups of {name}'s index must have "
                         f"{rows} groups, got {groups.off.shape[0] - 1}")


class _RowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx, groups, valid):
        ctx.groups = groups
        return _row_gather(src, idx, valid)

    @staticmethod
    def backward(ctx, g):
        d_src = group_sum(g.contiguous(), ctx.groups) if ctx.needs_input_grad[0] else None
        return d_src, None, None, None


def row_gather(src: torch.Tensor, idx: torch.Tensor, groups: Groups | None = None,
               valid: int | None = None) -> torch.Tensor:
    """(rows, D) gathered rows (rows past ``valid`` zero), differentiable in
    ``src`` through ``groups``, the CSR of ``idx`` (needed when ``src``
    requires grad; a table that does not, such as the geometry's radial
    table, gets no backward).  The plain version for CPU tensors, the CUDA
    kernel for CUDA tensors.  Counts its kernel launches in
    ``row_gather.launches``."""
    if not (torch.is_grad_enabled() and src.requires_grad):
        return _row_gather(src, idx, valid)  # no gradient wanted: no graph node
    _need_groups("row_gather", groups, src.shape[0], "src")
    return _RowGather.apply(src, idx, groups, valid)


row_gather.launches = 0


def edge_message_plain(xi, xj, i_idx, j_idx, base, gate=None, mask=None,
                       out_off: torch.Tensor | None = None):
    """Reference version: two gathers, sum, silu, then the factors; with
    ``out_off``, kernel A's plain sum of those rows over that CSR; in
    float32 for bfloat16 rows, rounded once to ``base``'s type.  The
    gathers are ``index_select``s of float32 copies, whose backward
    (``index_add_``) sums in float32, in one order on the CPU."""
    acc = acc_dtype(base.dtype)
    m = F.silu(xi.to(acc).index_select(0, i_idx.long())
               + xj.to(acc).index_select(0, j_idx.long()) + base.to(acc))
    if gate is not None:
        m = m * gate.to(acc)
    if mask is not None:
        m = m * mask[:, None].to(acc)
    return (m if out_off is None else triplet_aggregate_plain(m, out_off)).to(base.dtype)


def _edge_operands(what, xi, xj, i_idx, j_idx, base, gate, mask, extra=None):
    dev, dt = base.device, base.dtype
    rows, d = base.shape
    if d % 4:
        raise ValueError(f"{what}: needs D % 4 == 0, got D = {d}")
    bf16 = _build.dtype_flag(what, dt)
    i32 = torch.int32
    operands = {"xi": (xi, dt, (None, d)), "xj": (xj, dt, (xi.shape[0], d)),
                "i_idx": (i_idx, i32, (rows,)), "j_idx": (j_idx, i32, (rows,)),
                "base": (base, dt, (rows, d)), "gate": (gate, dt, (rows, d)),
                "mask": (mask, dt, (rows,)), **(extra or {})}
    for name, (t, dtype, shape) in operands.items():
        if t is not None:
            _build.check_operand(what, name, t, dtype, dev, shape)
    return dev, rows, d, bf16


def _edge_message(xi, xj, i_idx, j_idx, base, gate, mask):
    if base.device.type == "cpu":
        return edge_message_plain(xi, xj, i_idx, j_idx, base, gate, mask)
    dev, rows, d, bf16 = _edge_operands("edge_message", xi, xj, i_idx, j_idx, base, gate,
                                        mask)
    out = torch.empty((rows, d), dtype=base.dtype, device=dev)
    if rows == 0:
        return out
    lib = _build.library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_edge_message(
            xi.data_ptr(), xj.data_ptr(), i_idx.data_ptr(), j_idx.data_ptr(),
            base.data_ptr(), ptr(gate), ptr(mask), out.data_ptr(), rows, d, bf16, stream,
        )
    _build.check(code, "edge_message")
    edge_message.launches += 1
    return out


class _EdgeMessage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xi, xj, base, gate, mask, i_idx, j_idx, i_groups, j_groups):
        ctx.groups = (i_groups, j_groups)
        ctx.save_for_backward(xi, xj, base, gate, mask, i_idx, j_idx)
        return _edge_message(xi, xj, i_idx, j_idx, base, gate, mask)

    @staticmethod
    def backward(ctx, g):
        xi, xj, base, gate, mask, i_idx, j_idx = ctx.saved_tensors
        i_groups, j_groups = ctx.groups
        d_pre, d_gate = edge_message_backward(xi, xj, i_idx, j_idx, base, gate, mask,
                                              g.contiguous())
        needs = ctx.needs_input_grad
        d_xi = group_sum(d_pre, i_groups) if needs[0] else None
        d_xj = group_sum(d_pre, j_groups) if needs[1] else None
        return (d_xi, d_xj, d_pre if needs[2] else None, d_gate if needs[3] else None,
                None, None, None, None, None)


def _check_out_groups(out_groups: Groups, nodes: int, rows: int) -> None:
    """Raise unless ``out_groups`` is a sorted CSR over the ``nodes`` rows of
    ``xi`` with its valid row count, at most ``rows``, on the host."""
    if (out_groups.perm is not None or out_groups.total is None
            or tuple(out_groups.off.shape) != (nodes + 1,)
            or not 0 <= out_groups.total <= rows):
        raise ValueError(
            f"edge_message: out_groups must be the sorted CSR of i over the {nodes} rows "
            f"of xi with its valid row count (at most {rows}), got "
            f"{tuple(out_groups.off.shape)} offsets, perm "
            f"{'None' if out_groups.perm is None else 'given'}, total {out_groups.total}")


def edge_message_sum(xi: torch.Tensor, xj: torch.Tensor, i_idx: torch.Tensor,
                     j_idx: torch.Tensor, base: torch.Tensor, gate: torch.Tensor | None,
                     mask: torch.Tensor | None, out_groups: Groups) -> torch.Tensor:
    """(N, D) edge messages summed by the node they go to, over
    ``out_groups``, the sorted CSR of ``i_idx`` (group ``v`` holds the rows
    with ``i[r] = v``, so the kernel reads ``xi[v]`` once per group and not
    ``i_idx``): the forward of ``edge_message(..., out_groups=)``, kernel A's
    walk with the message as its row (``csrc/row_gather.cu``), on CUDA
    tensors; its plain version on CPU ones; no gradient.  Counts its
    launches in ``edge_message_sum.launches`` and, as every launch of the
    edge message, in ``edge_message.launches``."""
    _check_out_groups(out_groups, xi.shape[0], base.shape[0])
    if base.device.type == "cpu":
        return edge_message_plain(xi, xj, i_idx, j_idx, base, gate, mask, out_groups.off)
    dev, rows, d, bf16 = _edge_operands(
        "edge_message_sum", xi, xj, i_idx, j_idx, base, gate, mask,
        {"out_groups.off": (out_groups.off, torch.int32, (xi.shape[0] + 1,))})
    num_out = xi.shape[0]
    out = torch.empty((num_out, d), dtype=base.dtype, device=dev)
    if num_out == 0:
        return out
    lanes, slots = walk_shape(d, num_out, out_groups.total, base.dtype)
    lib = _build.library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_edge_message_sum(
            xi.data_ptr(), xj.data_ptr(), j_idx.data_ptr(), base.data_ptr(), ptr(gate),
            ptr(mask), out_groups.off.data_ptr(), out.data_ptr(), num_out, d, lanes, slots,
            bf16, stream)
    _build.check(code, "edge_message_sum")
    edge_message_sum.launches += 1
    edge_message.launches += 1
    return out


edge_message_sum.launches = 0


class _EdgeMessageSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xi, xj, base, gate, mask, i_idx, j_idx, out_groups, j_groups):
        ctx.groups = (out_groups, j_groups)
        ctx.save_for_backward(xi, xj, base, gate, mask, i_idx, j_idx)
        return edge_message_sum(xi, xj, i_idx, j_idx, base, gate, mask, out_groups)

    @staticmethod
    def backward(ctx, g):
        xi, xj, base, gate, mask, i_idx, j_idx = ctx.saved_tensors
        out_groups, j_groups = ctx.groups
        d_pre, d_gate = edge_message_backward(xi, xj, i_idx, j_idx, base, gate, mask,
                                              g.contiguous(), at_i=True,
                                              valid=out_groups.total)
        needs = ctx.needs_input_grad
        d_xi = group_sum(d_pre, out_groups) if needs[0] else None
        d_xj = group_sum(d_pre, j_groups) if needs[1] else None
        return (d_xi, d_xj, d_pre if needs[2] else None, d_gate if needs[3] else None,
                None, None, None, None, None)


def edge_message(xi: torch.Tensor, xj: torch.Tensor, i_idx: torch.Tensor,
                 j_idx: torch.Tensor, base: torch.Tensor,
                 gate: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None,
                 i_groups: Groups | None = None,
                 j_groups: Groups | None = None,
                 out_groups: Groups | None = None) -> torch.Tensor:
    """(E, D) edge messages, or with ``out_groups`` (the sorted CSR of
    ``i_idx`` with its ``total``) their (N, D) sums by the node they go to;
    differentiable in ``xi``, ``xj``, ``base`` and ``gate``.
    ``i_groups``/``j_groups`` are the CSRs of ``i_idx``/``j_idx`` that the
    backward sums over (needed when ``xi``/``xj`` require grad; summed, the
    sum by ``i`` takes ``out_groups``).  The plain version for CPU tensors
    (summed, PyTorch's autograd of ``edge_message_plain(..., out_off=)``),
    the CUDA kernels for CUDA tensors.  Counts its forward kernel launches in
    ``edge_message.launches`` (the summed ones in ``edge_message_sum.launches``
    too)."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (xi, xj, base, gate, mask))
    if mask is not None and mask.requires_grad and needs_grad:
        raise ValueError("edge_message: the mask takes no gradient")
    if out_groups is not None:
        if not needs_grad or base.device.type == "cpu":
            # No graph node, or the plain version that autograd differentiates.
            return edge_message_sum(xi, xj, i_idx, j_idx, base, gate, mask, out_groups)
        if xj.requires_grad:
            _need_groups("edge_message", j_groups, xj.shape[0], "xj")
        return _EdgeMessageSum.apply(xi, xj, base, gate, mask, i_idx, j_idx, out_groups,
                                     j_groups)
    if not needs_grad:
        return _edge_message(xi, xj, i_idx, j_idx, base, gate, mask)  # no graph node
    if xi.requires_grad:
        _need_groups("edge_message", i_groups, xi.shape[0], "xi")
    if xj.requires_grad:
        _need_groups("edge_message", j_groups, xj.shape[0], "xj")
    return _EdgeMessage.apply(xi, xj, base, gate, mask, i_idx, j_idx, i_groups,
                              j_groups)


edge_message.launches = 0


def edge_message_backward_plain(xi, xj, i_idx, j_idx, base, gate, mask, g,
                                at_i: bool = False, valid: int | None = None):
    """Reference version of ``edge_message_backward`` (in float32 for
    bfloat16 rows, each output rounded once to ``base``'s type)."""
    acc, dt = acc_dtype(base.dtype), base.dtype
    pre = xi[i_idx.long()].to(acc) + xj[j_idx.long()].to(acc) + base.to(acc)
    s = torch.sigmoid(pre)
    g = (g[i_idx.long()] if at_i else g).to(acc)
    if mask is not None:
        g = g * mask[:, None].to(acc)
    d_gate = None if gate is None else g * (pre * s)
    d_pre = (g if gate is None else g * gate.to(acc)) * (s * (1.0 + pre * (1.0 - s)))
    if valid is not None and valid < base.shape[0]:
        d_pre[valid:] = 0.0
        if d_gate is not None:
            d_gate[valid:] = 0.0
    return d_pre.to(dt), None if d_gate is None else d_gate.to(dt)


def edge_message_backward(xi: torch.Tensor, xj: torch.Tensor, i_idx: torch.Tensor,
                          j_idx: torch.Tensor, base: torch.Tensor,
                          gate: torch.Tensor | None, mask: torch.Tensor | None,
                          g: torch.Tensor, at_i: bool = False,
                          valid: int | None = None):
    """``(d_pre, d_gate)`` of the edge message for output gradient ``g``:
    ``d_pre = G * gate * mask * silu'(pre)`` (also ``d_base``) and
    ``d_gate = G * mask * silu(pre)`` (None without a gate), with ``pre``
    recomputed from the gathered rows and ``G = g[r]``, or with ``at_i`` (the
    summed message's backward, ``g`` (N, D)) ``G = g[i[r]]``; rows from
    ``valid`` on get zeros.  The plain version for CPU tensors,
    ``csrc/gather_backward.cu`` for CUDA tensors; counts its kernel launches
    in ``edge_message_backward.launches``."""
    if base.device.type == "cpu":
        return edge_message_backward_plain(xi, xj, i_idx, j_idx, base, gate, mask, g,
                                           at_i, valid)
    g_shape = (xi.shape[0], base.shape[1]) if at_i else tuple(base.shape)
    dev, rows, d, bf16 = _edge_operands("edge_message_backward", xi, xj, i_idx, j_idx,
                                        base, gate, mask, {"g": (g, base.dtype, g_shape)})
    valid = rows if valid is None else valid
    if not 0 <= valid <= rows:
        raise ValueError(f"edge_message_backward: valid = {valid} outside [0, {rows}]")
    d_pre = torch.empty((rows, d), dtype=base.dtype, device=dev)
    d_gate = None if gate is None else torch.empty_like(d_pre)
    if rows == 0:
        return d_pre, d_gate
    lib = _build.library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_edge_message_backward(
            xi.data_ptr(), xj.data_ptr(), i_idx.data_ptr(), j_idx.data_ptr(),
            base.data_ptr(), ptr(gate), ptr(mask), g.data_ptr(), d_pre.data_ptr(),
            ptr(d_gate), rows, valid, d, int(at_i), bf16, stream,
        )
    _build.check(code, "edge_message_backward")
    edge_message_backward.launches += 1
    return d_pre, d_gate


edge_message_backward.launches = 0
