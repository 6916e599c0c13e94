"""Gather - modulate - segmented sum over CSR offsets (kernel A).

    out[e, :] = sum_{r in [off[e], off[e+1])} a[idx[r], :] * b[r, :]

``idx=None`` sums rows of ``a`` directly (a row per summed row) and
``b=None`` skips the modulation, so one operation serves every aggregation
of the forward.  The rows must be sorted by their output row; ``off`` is the
(num_out+1,) int32 CSR offset array that batches carry.

``triplet_aggregate`` is the entry point: on CPU tensors it runs the plain
version, on CUDA tensors it launches ``csrc/triplet_aggregate.cu``.  It
replaces the Pallas kernel ``pamnet_tpu/ops/pallas_triplet.py:47``.
"""

from __future__ import annotations

import torch

from pamnet_tpu_torch.ops import _build


def triplet_aggregate_plain(a: torch.Tensor, off: torch.Tensor,
                            idx: torch.Tensor | None = None,
                            b: torch.Tensor | None = None) -> torch.Tensor:
    """Reference version: gather, multiply, ``index_add_``."""
    num_out = off.shape[0] - 1
    rows = int(off[-1])
    seg = torch.repeat_interleave(
        torch.arange(num_out, device=a.device), (off[1:] - off[:-1]).long(),
        output_size=rows,
    )
    vals = a[idx[:rows].long()] if idx is not None else a[:rows]
    if b is not None:
        vals = vals * b[:rows]
    out = a.new_zeros((num_out, a.shape[1]))
    return out.index_add_(0, seg, vals)


def triplet_aggregate(a: torch.Tensor, off: torch.Tensor,
                      idx: torch.Tensor | None = None,
                      b: torch.Tensor | None = None,
                      total: int | None = None) -> torch.Tensor:
    """(num_out, D) sums; the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors.  ``total`` is ``off[-1]`` where the caller knows it on
    the host (the batch's valid row count): the rows the kernel reads are
    then checked without reading ``off`` back from the card.  Counts its
    kernel launches in ``triplet_aggregate.launches``."""
    if a.device.type == "cpu":
        return triplet_aggregate_plain(a, off, idx, b)
    dev = a.device
    d = a.shape[1] if a.dim() == 2 else -1
    if d % 4 or d <= 0:
        raise ValueError(f"triplet_aggregate: a must be (rows, D) with D % 4 == 0, "
                         f"got {tuple(a.shape)}")
    rows = (idx if idx is not None else b if b is not None else a).shape[0]
    operands = {"a": (a, torch.float32, (None, d)), "off": (off, torch.int32, (None,)),
                "idx": (idx, torch.int32, (rows,)), "b": (b, torch.float32, (rows, d))}
    for name, (t, dtype, shape) in operands.items():
        if t is not None:
            _build.check_operand("triplet_aggregate", name, t, dtype, dev, shape)
    limit = rows if idx is not None else min(rows, a.shape[0])
    if total is not None and not 0 <= total <= limit:
        raise ValueError(f"triplet_aggregate: off[-1] = {total}, but the inputs "
                         f"hold {limit} rows")
    num_out = off.shape[0] - 1
    out = torch.empty((num_out, d), dtype=a.dtype, device=dev)
    if num_out == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pamnet_triplet_aggregate(
            a.data_ptr(), None if b is None else b.data_ptr(),
            None if idx is None else idx.data_ptr(), off.data_ptr(),
            out.data_ptr(), num_out, d, int(idx is not None),
            int(b is not None), stream,
        )
    _build.check(code, "triplet_aggregate")
    triplet_aggregate.launches += 1
    return out


triplet_aggregate.launches = 0
