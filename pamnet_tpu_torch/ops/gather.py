"""Row gathers of the forward, a plain row gather and the fused edge message,
as ``torch.autograd.Function``s with backward kernels.

    row_gather(src, idx)[r]      = src[idx[r]]
    edge_message(xi, xj, i, j, base, gate, mask)[r]
        = silu(xi[i[r]] + xj[j[r]] + base[r]) * gate[r] * mask[r]

``gate`` and ``mask`` may be None (no factor).  On CPU tensors forward and
backward run their plain versions, on CUDA tensors they launch
``csrc/row_gather.cu``, ``csrc/gather_backward.cu`` and kernel A.  They
replace the Pallas row gathers of ``tools/vmem_gather_probe.py:42``, ``:62``
and ``:86``.

Backward: the gradient of a gathered table is a sum of the output gradient
by index, ``d_src[v] = sum_{r: idx[r] = v} g[r]``: ``group_sum`` (kernel A)
over the CSR of the index (``Groups``), built on the host per batch.  The
edge message's backward kernel recomputes the pre-activation and writes
``d_pre`` (= ``d_base``) and ``d_gate``; ``d_xi`` and ``d_xj`` are group sums
of ``d_pre`` by ``i`` and by ``j``.  A CSR holds the valid rows only, so these
are exact when the padded rows' gradient is zero, which the model makes
sure of by masking every padded row before any sum or pool.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from pamnet_tpu_torch.ops import _build
from pamnet_tpu_torch.ops.triplet import Groups, group_sum


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor,
                     valid: int | None = None) -> torch.Tensor:
    """Reference version: advanced indexing; rows past ``valid`` are 0."""
    if valid is None or valid == idx.shape[0]:
        return src[idx.long()]
    out = src.new_zeros((idx.shape[0], src.shape[1]))
    out[:valid] = src[idx[:valid].long()]
    return out


def _row_gather(src, idx, valid):
    if src.device.type == "cpu":
        return row_gather_plain(src, idx, valid)
    dev = src.device
    _build.check_operand("row_gather", "src", src, torch.float32, dev, (None, None))
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
                                     rows, valid, src.shape[1], stream)
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


def edge_message_plain(xi, xj, i_idx, j_idx, base, gate=None, mask=None):
    """Reference version: two gathers, sum, silu, then the factors."""
    m = F.silu(xi[i_idx.long()] + xj[j_idx.long()] + base)
    if gate is not None:
        m = m * gate
    if mask is not None:
        m = m * mask[:, None]
    return m


def _edge_operands(what, xi, xj, i_idx, j_idx, base, gate, mask, extra=None):
    dev = base.device
    rows, d = base.shape
    if d % 4:
        raise ValueError(f"{what}: needs D % 4 == 0, got D = {d}")
    f32, i32 = torch.float32, torch.int32
    operands = {"xi": (xi, f32, (None, d)), "xj": (xj, f32, (xi.shape[0], d)),
                "i_idx": (i_idx, i32, (rows,)), "j_idx": (j_idx, i32, (rows,)),
                "base": (base, f32, (rows, d)), "gate": (gate, f32, (rows, d)),
                "mask": (mask, f32, (rows,)), **(extra or {})}
    for name, (t, dtype, shape) in operands.items():
        if t is not None:
            _build.check_operand(what, name, t, dtype, dev, shape)
    return dev, rows, d


def _edge_message(xi, xj, i_idx, j_idx, base, gate, mask):
    if base.device.type == "cpu":
        return edge_message_plain(xi, xj, i_idx, j_idx, base, gate, mask)
    dev, rows, d = _edge_operands("edge_message", xi, xj, i_idx, j_idx, base, gate, mask)
    out = torch.empty((rows, d), dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    lib = _build.library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_edge_message(
            xi.data_ptr(), xj.data_ptr(), i_idx.data_ptr(), j_idx.data_ptr(),
            base.data_ptr(), ptr(gate), ptr(mask), out.data_ptr(), rows, d, stream,
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


def edge_message(xi: torch.Tensor, xj: torch.Tensor, i_idx: torch.Tensor,
                 j_idx: torch.Tensor, base: torch.Tensor,
                 gate: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None,
                 i_groups: Groups | None = None,
                 j_groups: Groups | None = None) -> torch.Tensor:
    """(E, D) edge messages, differentiable in ``xi``, ``xj``, ``base`` and
    ``gate``; ``i_groups``/``j_groups`` are the CSRs of ``i_idx``/``j_idx``
    that the backward sums over (needed when ``xi``/``xj`` require grad).
    The plain version for CPU tensors, the CUDA kernels for CUDA tensors.
    Counts its forward kernel launches in ``edge_message.launches``."""
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xi, xj, base, gate, mask))):
        return _edge_message(xi, xj, i_idx, j_idx, base, gate, mask)  # no graph node
    if mask is not None and mask.requires_grad:
        raise ValueError("edge_message: the mask takes no gradient")
    if xi.requires_grad:
        _need_groups("edge_message", i_groups, xi.shape[0], "xi")
    if xj.requires_grad:
        _need_groups("edge_message", j_groups, xj.shape[0], "xj")
    return _EdgeMessage.apply(xi, xj, base, gate, mask, i_idx, j_idx, i_groups,
                              j_groups)


edge_message.launches = 0


def edge_message_backward_plain(xi, xj, i_idx, j_idx, base, gate, mask, g):
    """Reference version of ``edge_message_backward``."""
    pre = xi[i_idx.long()] + xj[j_idx.long()] + base
    s = torch.sigmoid(pre)
    if mask is not None:
        g = g * mask[:, None]
    d_gate = None if gate is None else g * (pre * s)
    d_pre = (g if gate is None else g * gate) * (s * (1.0 + pre * (1.0 - s)))
    return d_pre, d_gate


def edge_message_backward(xi: torch.Tensor, xj: torch.Tensor, i_idx: torch.Tensor,
                          j_idx: torch.Tensor, base: torch.Tensor,
                          gate: torch.Tensor | None, mask: torch.Tensor | None,
                          g: torch.Tensor):
    """``(d_pre, d_gate)`` of the edge message for output gradient ``g``:
    ``d_pre = g * gate * mask * silu'(pre)`` (also ``d_base``) and
    ``d_gate = g * mask * silu(pre)`` (None without a gate), with ``pre``
    recomputed from the gathered rows.  The plain version for CPU tensors,
    ``csrc/gather_backward.cu`` for CUDA tensors; counts its kernel launches
    in ``edge_message_backward.launches``."""
    if base.device.type == "cpu":
        return edge_message_backward_plain(xi, xj, i_idx, j_idx, base, gate, mask, g)
    dev, rows, d = _edge_operands("edge_message_backward", xi, xj, i_idx, j_idx,
                                  base, gate, mask,
                                  {"g": (g, torch.float32, tuple(base.shape))})
    d_pre = torch.empty((rows, d), dtype=torch.float32, device=dev)
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
            ptr(d_gate), rows, d, stream,
        )
    _build.check(code, "edge_message_backward")
    edge_message_backward.launches += 1
    return d_pre, d_gate


edge_message_backward.launches = 0
