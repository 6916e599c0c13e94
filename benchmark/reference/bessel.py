"""Float64 tables of the spherical-Bessel basis and j_l itself: a frozen
copy of ``pamnet_tpu_torch/ops/bessel.py`` at commit 3e9441f (closed-form
coefficients of j_l, the zeros z_{l,n} by bisection on interlaced brackets,
the DimeNet normalizers; reference: utils/sbf.py:14-49), and ``sph_jn_t``,
j_l on tensors in float64 by its ascending series below x = 2.5 and its
closed form above, where the float64 closed form is exact to ~1e-12."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def sph_jn_coeffs(lmax: int) -> tuple[np.ndarray, np.ndarray]:
    """(S, C), each (lmax+1, lmax+2): j_l(x) = sum_p S[l,p] u^p sin x +
    sum_p C[l,p] u^p cos x, u = 1/x."""
    P = lmax + 2
    S = np.zeros((lmax + 1, P), dtype=np.float64)
    C = np.zeros((lmax + 1, P), dtype=np.float64)
    S[0, 1] = 1.0
    if lmax >= 1:
        S[1, 2] = 1.0
        C[1, 1] = -1.0
    for l in range(1, lmax):
        S[l + 1, 1:] = (2 * l + 1) * S[l, :-1]
        S[l + 1] -= S[l - 1]
        C[l + 1, 1:] = (2 * l + 1) * C[l, :-1]
        C[l + 1] -= C[l - 1]
    return S, C


def sph_jn(l: int, x: np.ndarray) -> np.ndarray:
    S, C = sph_jn_coeffs(l)
    x = np.asarray(x, dtype=np.float64)
    u = 1.0 / x
    powers = u[..., None] ** np.arange(S.shape[1])
    return np.sin(x) * (powers @ S[l]) + np.cos(x) * (powers @ C[l])


def _bisect_zero(l: int, lo: float, hi: float, iters: int = 200) -> float:
    flo = sph_jn(l, np.array(lo))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        fm = sph_jn(l, np.array(mid))
        if fm == 0.0:
            return mid
        if (flo < 0) == (fm < 0):
            lo, flo = mid, fm
        else:
            hi = mid
        if hi - lo < 1e-14 * max(1.0, hi):
            break
    return 0.5 * (lo + hi)


@functools.lru_cache(maxsize=None)
def sph_jn_zeros(n: int, k: int) -> np.ndarray:
    zeros = np.zeros((n, k), dtype=np.float64)
    zeros[0] = np.arange(1, k + 1) * np.pi
    points = np.arange(1, k + n) * np.pi
    racines = np.zeros(k + n - 1, dtype=np.float64)
    for i in range(1, n):
        for j in range(k + n - 1 - i):
            racines[j] = _bisect_zero(i, points[j], points[j + 1])
        points = racines.copy()
        zeros[i, :k] = racines[:k]
    return zeros


@functools.lru_cache(maxsize=None)
def basis_tables(num_spherical: int, num_radial: int) -> dict:
    """``zeros`` and ``norm`` (ns, nr), ``sph_pref`` (ns,) = sqrt((2l+1)/4pi)."""
    zeros = sph_jn_zeros(num_spherical, num_radial)
    norm = np.zeros_like(zeros)
    for l in range(num_spherical):
        norm[l] = 1.0 / np.sqrt(0.5 * sph_jn(l + 1, zeros[l]) ** 2)
    ls = np.arange(num_spherical, dtype=np.float64)
    return {"zeros": zeros, "norm": norm, "sph_pref": np.sqrt((2.0 * ls + 1.0) / (4.0 * np.pi))}


def sph_jn_t(l: int, x: torch.Tensor, terms: int = 16) -> torch.Tensor:
    """j_l(x) elementwise on a float64 tensor of x > 0."""
    S, C = sph_jn_coeffs(l)
    safe = x.clamp_min(1e-12)
    u = 1.0 / safe
    closed = torch.zeros_like(safe)
    for p in range(S.shape[1]):
        if S[l, p] or C[l, p]:
            closed = closed + u**p * (S[l, p] * torch.sin(safe) + C[l, p] * torch.cos(safe))
    # j_l(x) = x^l / (2l+1)!! * sum_k (-x^2/2)^k / (k! (2l+3)(2l+5)...(2l+2k+1))
    term = safe**l / math.prod(range(1, 2 * l + 2, 2))
    series = term.clone()
    half = -0.5 * safe * safe
    for k in range(1, terms):
        term = term * half / (k * (2 * l + 2 * k + 1))
        series = series + term
    return torch.where(x < 2.5, series, closed)
