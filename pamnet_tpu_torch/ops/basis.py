"""Radial basis with trainable frequencies, evaluated on the device
(reference: layers/basic.py:36-76).

Callers sanitize padded distances first (mask before basis: padded entries
set to 2 * cutoff), so x = d / cutoff >= 1 there and the envelope zeroes
every channel; the 1/x term never sees 0.
"""

from __future__ import annotations

import torch
from torch import nn


def envelope(x: torch.Tensor, exponent: int = 5) -> torch.Tensor:
    """u(x) = 1/x + a x^p + b x^(p+1) + c x^(p+2), zero for x >= 1."""
    p = exponent
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    x_pow_p0 = x**p
    x_pow_p1 = x_pow_p0 * x
    env_val = 1.0 / x + a * x_pow_p0 + b * x_pow_p1 + c * x_pow_p1 * x
    return torch.where(x < 1.0, env_val, torch.zeros_like(x))


def bessel_rbf(dist: torch.Tensor, freq: torch.Tensor, cutoff: float,
               exponent: int = 5) -> torch.Tensor:
    """envelope(d/c) * sin(freq * d/c): (E,) distances -> (E, num_radial)."""
    x = dist[:, None] / cutoff
    return envelope(x, exponent) * torch.sin(freq * x)


class BesselRBF(nn.Module):
    """Holds the trainable frequencies (state-dict key ``<name>.freq``)."""

    def __init__(self, num_radial: int):
        super().__init__()
        self.freq = nn.Parameter(torch.empty(num_radial))

    def forward(self, dist: torch.Tensor, cutoff: float,
                exponent: int = 5) -> torch.Tensor:
        return bessel_rbf(dist, self.freq, cutoff, exponent)
