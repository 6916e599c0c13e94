"""Plain segment reductions with static segment counts (the graph pooling of
reference models.py:215-224).  Padded rows must carry zeros or be masked."""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets, as the product of
    the (num_segments, rows) one-hot matrix with ``data``.  ``index_add_``
    on CUDA adds with atomics in an order that changes from run to run; a
    product sums in a fixed order, so a training step repeats bit for bit.
    The product runs in float64, which no TF32 or reduced-precision matmul
    setting touches: a pooled value is the float64 sum of its rows, rounded
    once, whatever matmul precision the caller set.  The pools it serves
    have few segments (graphs per batch)."""
    rows = data.shape[0]
    onehot = segment_ids.long()[None, :] == torch.arange(
        num_segments, device=data.device)[:, None]
    out = onehot.double() @ data.reshape(rows, -1).double()
    return out.to(data.dtype).reshape((num_segments,) + data.shape[1:])


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked mean over segments; ``mask`` (float 0/1 per row) marks valid
    rows.  Empty segments give 0."""
    if mask is not None:
        data = data * mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
        ones = mask
    else:
        ones = data.new_ones(data.shape[0])
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(ones, segment_ids, num_segments).clamp_min(1.0)
    return total / count.reshape(count.shape + (1,) * (data.ndim - count.ndim))
