"""P-value calibration: Gumbel and two-piece log-linear fits to
test-statistic distributions (reference src/gumbel.cpp, src/calibrate*.cpp,
src/statsig.cpp).

The shipped StatSig constants were fitted offline by the reference author;
this module lets the fits be regenerated from a search's TS histogram (e.g.
on shuffled/decoy databases), producing the same parameter shapes
(x1/m0/c0/m/c for the elbow model, mu/beta for Gumbel).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


def gumbel_pdf(mu: float, beta: float, x: np.ndarray) -> np.ndarray:
    z = (np.asarray(x, np.float64) - mu) / beta
    return (1.0 / beta) * np.exp(-(z + np.exp(-z)))


def gumbel_cdf(mu: float, beta: float, x: np.ndarray) -> np.ndarray:
    return np.exp(-np.exp(-(np.asarray(x, np.float64) - mu) / beta))


def fit_gumbel(xs: np.ndarray, ys: np.ndarray,
               n_grid: int = 64) -> Tuple[float, float, float]:
    """Weighted grid-search fit of Scale*gumbel(mu, beta, x) to a histogram
    (GetRMSE weighting y*|yfit-y|, gumbel.cpp:43-64).
    Returns (mu, beta, scale)."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    mode = xs[np.argmax(ys)]
    spread = max(xs.max() - xs.min(), 1e-6)
    best = (mode, spread / 4, ys.sum() * (xs[1] - xs[0] if len(xs) > 1
                                          else 1.0))
    best_err = np.inf
    scale0 = best[2]
    for mu in np.linspace(mode - spread / 4, mode + spread / 4, n_grid):
        for beta in np.linspace(spread / 50, spread / 2, n_grid):
            yfit = scale0 * gumbel_pdf(mu, beta, xs)
            err = np.sqrt(np.sum(ys * np.abs(yfit - ys) * 2) / len(ys))
            if err < best_err:
                best_err = err
                best = (mu, beta, scale0)
    return best


@dataclasses.dataclass
class LogLinearFit:
    """Two-piece log10(P) = m*TS + c model (statsig.cpp:27-44)."""

    x1: float
    m0: float
    c0: float
    m: float
    c: float

    def pvalue(self, ts: float) -> float:
        if ts < self.x1:
            lp = self.m0 * ts + self.c0
        else:
            lp = self.m * ts + self.c
        return min(10.0 ** lp, 1.0)


def fit_log_linear(ts_values: Sequence[float], n_queries: int,
                   elbow_quantile: float = 0.98) -> LogLinearFit:
    """Fit the elbow model from decoy (false-positive) test statistics:
    empirical P(TS >= t) per query, fitted piecewise in log10 space."""
    ts = np.sort(np.asarray(ts_values, np.float64))[::-1]
    n = len(ts)
    if n < 10:
        raise ValueError("need >= 10 decoy scores")
    # empirical tail probability per query
    p = (np.arange(n) + 1) / max(n_queries, 1)
    logp = np.log10(np.clip(p, 1e-300, None))
    x1 = float(np.quantile(ts, elbow_quantile))
    hi = ts >= x1
    lo = ~hi

    def linfit(x, y):
        if x.size < 2:
            return 0.0, float(y.mean()) if y.size else 0.0
        A = np.stack([x, np.ones_like(x)], axis=1)
        sol, *_ = np.linalg.lstsq(A, y, rcond=None)
        return float(sol[0]), float(sol[1])

    m, c = linfit(ts[hi], logp[hi])
    m0, c0 = linfit(ts[lo], logp[lo])
    return LogLinearFit(x1=x1, m0=m0, c0=c0, m=m, c=c)
