"""Kabsch superposition: optimal rigid transform u,t minimizing
sum |u·x + t - y|^2 over aligned CA pairs, via SVD (numerically equivalent
to the reference's TM-align-derived eigen solver, src/kabsch.cpp:21-385).

Convention matches the reference: x = query coords, y = target coords,
transformed query point = t + u @ x (src/abcxyz.cpp:149-155); returns the
mean squared deviation (reference returns RMS/M, src/kabsch.cpp:385)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def kabsch(x: np.ndarray, y: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """x, y: [M, 3] float.  Returns (t[3], u[3,3], mean squared deviation)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    m = x.shape[0]
    if m == 0:
        return np.zeros(3), np.eye(3), 0.0
    xc = x.mean(axis=0)
    yc = y.mean(axis=0)
    x0 = x - xc
    y0 = y - yc
    h = x0.T @ y0
    U, _s, Vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    u = Vt.T @ D @ U.T
    t = yc - u @ xc
    resid = (x0 @ u.T) - y0
    msd = float((resid * resid).sum() / m)
    return t, u, msd


def kabsch_path(coords_q: np.ndarray, coords_t: np.ndarray,
                lo_q: int, lo_t: int, path: str
                ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Kabsch over the M columns of an alignment path
    (src/kabsch.cpp:330-385)."""
    pq, pt = [], []
    a, b = lo_q, lo_t
    for c in path:
        if c == "M":
            pq.append(a)
            pt.append(b)
            a += 1
            b += 1
        elif c == "D":
            a += 1
        elif c == "I":
            b += 1
    return kabsch(coords_q[pq], coords_t[pt])
