"""Basic blocks (reference: layers/basic.py:11-33), named so that a module's
``state_dict`` keys are the reference's: an MLP is a Sequential of
(Linear, SiLU) stages (``mlp_x1.0.0.weight``), a Res block holds one
(``res1.mlp.1.0.bias``).  Weights are torch's (out, in) layout.

Parameters are created uninitialized; ``init_`` fills a module tree with
the JAX package's init distributions from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


class Linear(nn.Module):
    """y = x @ weight.T + bias, weight (out, in)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def mlp(channels: list[int]) -> nn.Sequential:
    """Linear + SiLU on every stage (reference: layers/basic.py:19-22)."""
    return nn.Sequential(*[
        nn.Sequential(Linear(channels[i], channels[i + 1]), nn.SiLU())
        for i in range(len(channels) - 1)
    ])


class Res(nn.Module):
    """Two-stage MLP with identity skip (reference: layers/basic.py:25-33)."""

    def __init__(self, dim: int):
        super().__init__()
        self.mlp = mlp([dim, dim, dim])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x) + x


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


@torch.no_grad()
def init_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter with the distribution of ``pamnet_tpu/nn.py``:
    Linear U(-1/sqrt(in), 1/sqrt(in)) for weight and bias; embeddings
    U(-sqrt 3, sqrt 3); Bessel frequencies n*pi; attention vectors ``W``
    glorot U(-sqrt(6/(in+out)), ...)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "embeddings":
            p.copy_(_uniform(p.shape, math.sqrt(3.0), generator))
        elif leaf == "freq":
            p.copy_(torch.arange(1, p.shape[0] + 1, dtype=p.dtype) * math.pi)
        elif leaf == "W":
            p.copy_(_uniform(p.shape, math.sqrt(6.0 / sum(p.shape)), generator))
        elif leaf == "weight":
            p.copy_(_uniform(p.shape, 1.0 / math.sqrt(p.shape[1]), generator))
        elif leaf == "bias":
            owner = module.get_submodule(name.rsplit(".", 1)[0])
            fan_in = owner.weight.shape[1]
            p.copy_(_uniform(p.shape, 1.0 / math.sqrt(fan_in), generator))
        else:
            raise KeyError(f"no init rule for parameter {name!r}")
