"""Evaluation metrics of PDBbind training (reference: utils/metrics.py:6-24;
the port's copy of ``pamnet_tpu/utils/metrics.py``).

``sd`` is the residual standard deviation after a least-squares refit
``y ~ a*f + b``: the reference fits it with sklearn's LinearRegression, which
for one feature is the closed form below.
"""

from __future__ import annotations

import numpy as np


def rmse(y: np.ndarray, f: np.ndarray) -> float:
    return float(np.sqrt(((y - f) ** 2).mean(axis=0)))


def mae(y: np.ndarray, f: np.ndarray) -> float:
    return float(np.abs(y - f).mean())


def sd(y: np.ndarray, f: np.ndarray) -> float:
    f = f.reshape(-1).astype(np.float64)
    y = y.reshape(-1).astype(np.float64)
    fm, ym = f.mean(), y.mean()
    denom = ((f - fm) ** 2).sum()
    a = ((f - fm) * (y - ym)).sum() / denom if denom > 0 else 0.0
    resid = y - (a * f + (ym - a * fm))
    return float(np.sqrt((resid**2).sum() / (len(y) - 1)))


def pearson(y: np.ndarray, f: np.ndarray) -> float:
    return float(np.corrcoef(y, f)[0, 1])
