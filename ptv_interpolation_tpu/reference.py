"""Plain f64 scipy references for the kernels' parity checks.

Straightforward implementations of the reference's own formulas,
independent of the code under test: KDTree k-nearest neighbors, then the
sibson/IDW weights of `/root/reference/interpolator.py:83-155` and the
kNN-MAD decision of `/root/reference/filtering.py:5-58`, all in float64 on
the host. The benchmarks and the on-card smoke test compare the device
results against these.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-10


def _knn(points, queries, k: int):
    from scipy.spatial import KDTree
    tree = KDTree(np.asarray(points, np.float64))
    return tree.query(np.asarray(queries, np.float64), k=k, workers=-1)


def sibson_values(points, values, queries, k: int):
    """Sibson (smoothed inverse distance) values at ``queries``, (Q, V)."""
    dist, idx = _knn(points, queries, k)
    inv = 1.0 / (dist + _EPS)
    w = inv / inv.sum(1, keepdims=True)
    std = dist.std(1, keepdims=True)
    w = w * np.exp(-dist / (std + _EPS))
    w /= w.sum(1, keepdims=True)
    return np.einsum("qk,qkc->qc", w,
                     np.asarray(values, np.float64)[idx])


def idw_values(points, values, queries, k: int, power: float = 2.0):
    """Inverse-distance-weighted values at ``queries``, (Q, V)."""
    dist, idx = _knn(points, queries, k)
    w = 1.0 / (dist ** power + _EPS)
    w /= w.sum(1, keepdims=True)
    return np.einsum("qk,qkc->qc", w,
                     np.asarray(values, np.float64)[idx])


def mad_keep(points, values, k: int, threshold: float, idx=None):
    """Keep decisions of the kNN median/MAD filter for the points ``idx``
    (all points when None): each point's k nearest other points, the
    median and MAD of their speeds, keep ⟺ |s − med| / (MAD + 1e-6) ≤
    threshold."""
    p = np.asarray(points, np.float64)
    v = np.asarray(values, np.float64)
    speed = np.sqrt((v * v).sum(axis=1))
    sel = np.arange(len(p)) if idx is None else np.asarray(idx)
    _, nn = _knn(p, p[sel], k + 1)
    neigh = speed[nn[:, 1:]]                    # drop the point itself
    med = np.median(neigh, axis=1)
    mad = np.median(np.abs(neigh - med[:, None]), axis=1)
    return np.abs(speed[sel] - med) / (mad + 1e-6) <= threshold
