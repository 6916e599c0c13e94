"""The bases evaluated on the device: the radial basis with trainable
frequencies (reference: layers/basic.py:36-76) and the geometry-only
spherical basis of derive-geometry batches (reference:
layers/basic.py:79-116; ``pamnet_tpu/ops/basis.py:54-197``), in the input's
dtype (f32 on the card, where the host tables are f64).

Callers sanitize padded distances first (mask before basis: padded entries
set to 2 * cutoff), so x = d / cutoff >= 1 there and the envelope zeroes
every channel; the 1/x term never sees 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from pamnet_tpu_torch.ops.bessel import bessel_basis_tables, sph_jn_coeffs


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


@functools.lru_cache(maxsize=None)
def _jn_constants(lmax: int, dtype: torch.dtype, device: torch.device):
    """The constants of ``spherical_jn_all`` as tensors on ``device``,
    uploaded once (a copy from host memory waits for the card): (2l+1)!!,
    the series' two coefficients and the closed forms' tables S^T, C^T."""
    ls = np.arange(lmax + 1, dtype=np.float64)
    dfact = np.array([np.prod(np.arange(1, 2 * l + 2, 2, dtype=np.float64))
                      for l in range(lmax + 1)])
    c1 = 1.0 / (2.0 * (2.0 * ls + 3.0))
    c2 = 1.0 / (8.0 * (2.0 * ls + 3.0) * (2.0 * ls + 5.0))
    S, C = sph_jn_coeffs(lmax)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (dfact, c1, c2, S.T, C.T))


@functools.lru_cache(maxsize=None)
def _basis_constants(num_spherical: int, num_radial: int, dtype: torch.dtype,
                     device: torch.device):
    """The basis tables' zeros, normalizers (ns, nr) and harmonic prefactors
    (ns,) as tensors on ``device``, uploaded once."""
    t = bessel_basis_tables(num_spherical, num_radial)
    return tuple(torch.as_tensor(t[k], dtype=dtype, device=device)
                 for k in ("zeros", "norm", "sph_pref"))


def spherical_jn_all(arg: torch.Tensor, lmax: int) -> torch.Tensor:
    """j_l(arg) for l = 0..lmax elementwise, arg.shape + (lmax+1,)
    (``pamnet_tpu/ops/basis.py:54``).  Three regimes, every branch NaN-free
    everywhere: a 3-term ascending series for arg < 1; Miller's downward
    recurrence, normalized by j0 or j1 (whichever is larger), for
    1 <= arg < lmax + 2, where the closed forms cancel in f32; the closed
    form S_l(1/x) sin x + C_l(1/x) cos x above."""
    dt, dev = arg.dtype, arg.device
    dfact, c1, c2, s_t, c_t = _jn_constants(lmax, dt, dev)
    safe = torch.clamp_min(arg, 1e-6)

    ls = torch.arange(lmax + 1, device=dev)
    x2 = (safe * safe)[..., None]
    series = safe[..., None] ** ls / dfact * (1.0 - x2 * c1 + x2 * x2 * c2)

    xm = torch.clamp(safe, 1.0, float(lmax + 2))
    jp = torch.zeros_like(xm)
    jc = torch.full_like(xm, 1e-8)
    down_cols = [None] * (lmax + 1)
    for l in range(lmax + 12, -1, -1):
        if l <= lmax:
            down_cols[l] = jc
        jp, jc = jc, (2.0 * l + 1.0) / xm * jc - jp
    down = torch.stack(down_cols, dim=-1)
    j0t = torch.sin(xm) / xm
    j1t = torch.sin(xm) / (xm * xm) - torch.cos(xm) / xm
    use0 = torch.abs(j0t) >= torch.abs(j1t)
    d0 = torch.where(use0, down_cols[0], 1.0)
    d1 = torch.where(use0, 1.0, down_cols[1] if lmax >= 1 else down_cols[0])
    down = down * torch.where(use0, j0t / d0, j1t / d1)[..., None]

    u = 1.0 / safe
    powers = u[..., None] ** torch.arange(s_t.shape[0], device=dev, dtype=dt)
    closed = (torch.sin(safe)[..., None] * (powers @ s_t)
              + torch.cos(safe)[..., None] * (powers @ c_t))

    a = arg[..., None]
    return torch.where(a < 1.0, series, torch.where(a < float(lmax + 2), down, closed))


def spherical_basis_edge_rbf(dist: torch.Tensor, num_spherical: int, num_radial: int,
                             cutoff: float, exponent: int = 5) -> torch.Tensor:
    """env(x) * norm[l,n] * j_l(z[l,n] * x) for x = dist / cutoff, (E, ns, nr)
    (``pamnet_tpu/ops/basis.py:124``; reference: layers/basic.py:107-110).
    Padded distances sanitized to >= cutoff give exact zeros."""
    zeros, norm, _ = _basis_constants(num_spherical, num_radial, dist.dtype, dist.device)
    x = dist / cutoff
    j_all = spherical_jn_all(x[:, None, None] * zeros, num_spherical - 1)  # (E, ns, nr, ns)
    # Channel (l, n) takes order l: the diagonal over the two l axes.
    j = torch.diagonal(j_all, dim1=1, dim2=3).permute(0, 2, 1)  # (E, ns, nr)
    return envelope(x, exponent)[:, None, None] * norm * j


def legendre_cbf(angle: torch.Tensor, num_spherical: int) -> torch.Tensor:
    """Y_l0(theta) = pref_l * P_l(cos theta), l < num_spherical, by the
    Legendre recurrence: (T, ns) (``pamnet_tpu/ops/basis.py:154``)."""
    pref = _basis_constants(num_spherical, 1, angle.dtype, angle.device)[2]
    c = torch.cos(angle)
    polys = [torch.ones_like(c)]
    if num_spherical > 1:
        polys.append(c)
    for l in range(2, num_spherical):
        polys.append(((2 * l - 1) * c * polys[l - 1] - (l - 1) * polys[l - 2]) / l)
    return torch.stack(polys, dim=-1) * pref


def spherical_basis(dist: torch.Tensor, angle: torch.Tensor, idx_edge: torch.Tensor,
                    num_spherical: int, num_radial: int, cutoff: float,
                    exponent: int = 5) -> torch.Tensor:
    """The 2D distance x angle basis, (T, ns*nr): the radial table of edge
    ``idx_edge[t]`` times the angle's harmonics repeated over the radial
    channels (``pamnet_tpu/ops/basis.py:173``; reference:
    layers/basic.py:107-116)."""
    rbf = spherical_basis_edge_rbf(dist, num_spherical, num_radial, cutoff, exponent)
    cbf = legendre_cbf(angle, num_spherical)
    rbf_flat = rbf.reshape(rbf.shape[0], num_spherical * num_radial)
    return rbf_flat[idx_edge.long()] * torch.repeat_interleave(cbf, num_radial, dim=1)
