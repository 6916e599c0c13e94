"""Basic blocks (reference: layers/basic.py:11-33), named so that a module's
``state_dict`` keys are the reference's: an MLP is a Sequential of
(Linear, SiLU) stages (``mlp_x1.0.0.weight``), a Res block holds one
(``res1.mlp.1.0.bias``).  Weights are torch's (out, in) layout.

Parameters are created uninitialized; ``init_`` fills a module tree with
the JAX package's init distributions from a ``torch.Generator``.

Mixed precision (JAX ``pamnet_tpu/nn.py:39-45``): parameters stay float32
and a Linear follows its input's type, its weight and bias cast at each use,
so gradients reach the float32 parameters through the cast.  Inside
``cast_parameters`` the casts of a forward's parameters come from one
batched cast (a concatenation, one cast and views, and the same in the
backward) instead of a cast and a cast-back launch per tensor: the same
values and gradients in a handful of launches.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn
from torch.nn import functional as F

# id(parameter) -> its copy in the compute type, inside ``cast_parameters``.
_casts = threading.local()


def as_dtype(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    """``p`` in ``dtype``: unchanged where it has that type, else the copy
    ``cast_parameters`` made for this forward, else a cast."""
    if p is None or p.dtype == dtype:
        return p
    cast = (getattr(_casts, "by_id", None) or {}).get(id(p))
    return cast if cast is not None and cast.dtype == dtype else p.to(dtype)


class _CastAll(torch.autograd.Function):
    """Every tensor of ``params`` cast to ``dtype`` through one flat buffer;
    the backward casts the gradients back the same way."""

    @staticmethod
    def forward(ctx, dtype, *params):
        ctx.src_dtype = params[0].dtype
        ctx.shapes = [p.shape for p in params]
        flat = torch.cat([p.reshape(-1) for p in params]).to(dtype)
        return tuple(v.view(shape) for v, shape in
                     zip(flat.split([p.numel() for p in params]), ctx.shapes))

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads]).to(ctx.src_dtype)
        sizes = [math.prod(shape) for shape in ctx.shapes]
        return (None, *(v.view(shape) for v, shape in zip(flat.split(sizes), ctx.shapes)))


@contextlib.contextmanager
def cast_parameters(params: list[torch.Tensor], dtype: torch.dtype):
    """Within the block, ``as_dtype(p, dtype)`` of each of ``params`` (one
    type) is its view of one batched cast, differentiable in ``p``."""
    prev = getattr(_casts, "by_id", None)
    casts = _CastAll.apply(dtype, *params)
    _casts.by_id = {**(prev or {}), **{id(p): c for p, c in zip(params, casts)}}
    try:
        yield
    finally:
        _casts.by_id = prev


class Linear(nn.Module):
    """y = x @ weight.T + bias, weight (out, in), in ``x``'s type."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, as_dtype(self.weight, x.dtype), as_dtype(self.bias, x.dtype))


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
