"""Exponential moving average of the parameters (reference: utils/ema.py:3-33;
JAX counterpart ``pamnet_tpu/train/ema.py``), over state dicts."""

from __future__ import annotations

import torch


def ema_init(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The shadow starts as a copy of the live parameters (reference:
    utils/ema.py:9-11)."""
    return {k: v.detach().clone() for k, v in state.items()}


@torch.no_grad()
def ema_update(shadow: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
               decay: float = 0.999, num_updates: int = 99999) -> None:
    """shadow <- (1-d) * param + d * shadow, in place, with
    d = min(decay, (1 + n) / (10 + n)) (reference: utils/ema.py:13-20; the
    training scripts call it with the default n=99999, so d == decay)."""
    d = min(decay, (1.0 + num_updates) / (10.0 + num_updates))
    keys = list(shadow)
    new = torch._foreach_mul([params[k].detach() for k in keys], 1.0 - d)
    old = [shadow[k] for k in keys]
    torch._foreach_mul_(old, d)
    torch._foreach_add_(old, new)
