"""Host (numpy, float64) tables of the spherical-Bessel basis.

The port's own copy of ``pamnet_tpu/ops/bessel.py``: closed-form coefficient
tables of j_l (integer polynomials in u = 1/x from the upward recurrence),
the first zeros z_{l,n} of j_l (bisection on interlaced brackets), and the
DimeNet normalizers 1/sqrt(0.5 * j_{l+1}(z_{l,n})^2) (reference:
utils/sbf.py:14-49).
"""

from __future__ import annotations

import functools

import numpy as np


def sph_jn_coeffs(lmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Coefficient tables (S, C), each (lmax+1, lmax+2):
    j_l(x) = sum_p S[l, p] u^p sin(x) + sum_p C[l, p] u^p cos(x), u = 1/x."""
    P = lmax + 2
    S = np.zeros((lmax + 1, P), dtype=np.float64)
    C = np.zeros((lmax + 1, P), dtype=np.float64)
    S[0, 1] = 1.0  # j_0 = sin(x)/x
    if lmax >= 1:
        S[1, 2] = 1.0  # j_1 = sin(x)/x^2 - cos(x)/x
        C[1, 1] = -1.0
    for l in range(1, lmax):
        # j_{l+1} = (2l+1) * u * j_l - j_{l-1}
        S[l + 1, 1:] = (2 * l + 1) * S[l, :-1]
        S[l + 1] -= S[l - 1]
        C[l + 1, 1:] = (2 * l + 1) * C[l, :-1]
        C[l + 1] -= C[l - 1]
    return S, C


def sph_jn(l: int, x: np.ndarray) -> np.ndarray:
    """j_l(x) in float64 from the closed-form coefficient table."""
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
    """First k positive zeros of j_l for l = 0..n-1, shape (n, k); the zeros
    of j_l interlace those of j_{l-1}, which bracket the bisection."""
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
def bessel_basis_tables(num_spherical: int, num_radial: int) -> dict:
    """Constants of the normalized 2D spherical basis: ``zeros`` and ``norm``
    (ns, nr), ``S``/``C`` (ns, ns+1), ``sph_pref`` (ns,) = sqrt((2l+1)/4pi)."""
    zeros = sph_jn_zeros(num_spherical, num_radial)
    norm = np.zeros_like(zeros)
    for l in range(num_spherical):
        jl1 = sph_jn(l + 1, zeros[l])
        norm[l] = 1.0 / np.sqrt(0.5 * jl1**2)
    S, C = sph_jn_coeffs(num_spherical - 1)
    ls = np.arange(num_spherical, dtype=np.float64)
    sph_pref = np.sqrt((2.0 * ls + 1.0) / (4.0 * np.pi))
    return {"zeros": zeros, "norm": norm, "S": S, "C": C, "sph_pref": sph_pref}
