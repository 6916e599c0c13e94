"""Plain segment reductions with static segment counts (the graph pooling of
reference models.py:215-224).  Padded rows must carry zeros or be masked."""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets."""
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids.long(), data)


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
