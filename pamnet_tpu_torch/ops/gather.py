"""Row gathers of the forward: a plain row gather and the fused edge message.

    row_gather(src, idx)[r]      = src[idx[r]]
    edge_message(xi, xj, i, j, base, gate, mask)[r]
        = silu(xi[i[r]] + xj[j[r]] + base[r]) * gate[r] * mask[r]

``gate`` and ``mask`` may be None (no factor).  On CPU tensors both run their
plain versions, on CUDA tensors they launch ``csrc/row_gather.cu``.  They
replace the Pallas row gathers of ``tools/vmem_gather_probe.py:42``, ``:62``
and ``:86``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from pamnet_tpu_torch.ops import _build


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Reference version: advanced indexing."""
    return src[idx.long()]


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(rows, D) gathered rows; the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors.  Counts its kernel launches in
    ``row_gather.launches``."""
    if src.device.type == "cpu":
        return row_gather_plain(src, idx)
    dev = src.device
    _build.check_operand("row_gather", "src", src, torch.float32, dev, (None, None))
    _build.check_operand("row_gather", "idx", idx, torch.int32, dev, (None,))
    out = torch.empty((idx.shape[0], src.shape[1]), dtype=src.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_row_gather(src.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                     idx.shape[0], src.shape[1], stream)
    _build.check(code, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0


def edge_message_plain(xi, xj, i_idx, j_idx, base, gate=None, mask=None):
    """Reference version: two gathers, sum, silu, then the factors."""
    m = F.silu(xi[i_idx.long()] + xj[j_idx.long()] + base)
    if gate is not None:
        m = m * gate
    if mask is not None:
        m = m * mask[:, None]
    return m


def edge_message(xi: torch.Tensor, xj: torch.Tensor, i_idx: torch.Tensor,
                 j_idx: torch.Tensor, base: torch.Tensor,
                 gate: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """(E, D) edge messages; the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors.  Counts its kernel launches in
    ``edge_message.launches``."""
    if base.device.type == "cpu":
        return edge_message_plain(xi, xj, i_idx, j_idx, base, gate, mask)
    dev = base.device
    rows, d = base.shape
    if d % 4:
        raise ValueError(f"edge_message: needs D % 4 == 0, got D = {d}")
    f32, i32 = torch.float32, torch.int32
    operands = {"xi": (xi, f32, (None, d)), "xj": (xj, f32, (xi.shape[0], d)),
                "i_idx": (i_idx, i32, (rows,)), "j_idx": (j_idx, i32, (rows,)),
                "base": (base, f32, (rows, d)), "gate": (gate, f32, (rows, d)),
                "mask": (mask, f32, (rows,))}
    for name, (t, dtype, shape) in operands.items():
        if t is not None:
            _build.check_operand("edge_message", name, t, dtype, dev, shape)
    out = torch.empty((rows, d), dtype=f32, device=dev)
    if rows == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_edge_message(
            xi.data_ptr(), xj.data_ptr(), i_idx.data_ptr(), j_idx.data_ptr(),
            base.data_ptr(), None if gate is None else gate.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), rows, d,
            stream,
        )
    _build.check(code, "edge_message")
    edge_message.launches += 1
    return out


edge_message.launches = 0
