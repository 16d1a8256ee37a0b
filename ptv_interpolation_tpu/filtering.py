"""Outlier rejection for scattered PTV vectors.

Port of `/root/reference/filtering.py`:
* global speed threshold (`filtering.py:60-73`)
* k-NN median/MAD statistical filter (`filtering.py:5-58`): a point is an
  outlier when its speed deviates from the local (k-neighbor) median by more
  than ``threshold`` MAD units (ε = 1e-6 guards uniform regions).

Design: the filter *decisions* (a boolean keep mask) are computed
entirely on device with fixed shapes — the kNN query reuses the same
neighbor primitive as interpolation, and median/MAD run fused in the tile
loop. The variable-length compaction (dropping rows) is a host-side
finalisation, because downstream static shapes must be host-known anyway.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ptv_interpolation_tpu.io.csvio import PointCloud
from ptv_interpolation_tpu.ops.neighbors import (
    bruteforce_tile_fn,
    build_cell_list,
    celllist_tile_fn,
    map_query_tiles,
)


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Mirrors the reference CLI flags (`main.py:43-46`)."""

    filter_outliers: bool = False
    filter_neighbors: int = 25        # --filter-neighbors
    filter_threshold: float = 3.0     # --filter-threshold (MAD units)
    filter_max_speed: float = 10.0    # --filter-max-speed


@functools.partial(jax.jit, static_argnames=())
def speed_threshold_mask(values, max_speed):
    """Keep mask of the global speed filter (`filtering.py:60-73`)."""
    v = jnp.asarray(values, jnp.float32)
    speed = jnp.sqrt(jnp.sum(v * v, axis=-1))
    return speed <= max_speed


@functools.partial(jax.jit, static_argnames=("k", "query_tile", "rings"))
def knn_mad_mask(points, values, k: int = 25, threshold: float = 3.0,
                 query_tile: int = 1024, cells=None, rings: int = 1):
    """Keep mask of the k-NN median/MAD filter (`filtering.py:5-58`),
    exact brute-force formulation (small clouds / parity tests; the
    pipeline uses :func:`knn_mad_mask_scatter` at scale). With ``cells``
    (a prebuilt :class:`CellList`) the neighbor search runs through the
    generic cell-list path instead of the O(N²) brute force — the escape
    hatch for large clouds the scatter-block kernel rejects.

    Queries the k+1 nearest (self included, then dropped — reference
    `filtering.py:26-30`), computes the neighborhood speed median and MAD,
    and flags ``|speed - median| / (MAD + 1e-6) > threshold``.

    Returns ``(keep_mask, median_filter_radius)`` where the radius is the
    median distance to the k-th neighbor (the reference's reported
    diagnostic, `filtering.py:33-35`).
    """
    pts = jnp.asarray(points, jnp.float32)
    v = jnp.asarray(values, jnp.float32)
    speed = jnp.sqrt(jnp.sum(v * v, axis=-1))

    if cells is not None:
        neighbor = celllist_tile_fn(cells, k + 1, rings=rings)
    else:
        neighbor = bruteforce_tile_fn(pts, k + 1)

    def tile(q_tile):
        sq, idx = neighbor(q_tile)
        # drop self (nearest neighbor of a point in its own cloud)
        n_idx = idx[:, 1:]
        n_sq = sq[:, 1:]
        n_speeds = speed[jnp.clip(n_idx, 0, None)]
        n_speeds = jnp.where(n_idx >= 0, n_speeds, jnp.nan)
        med = jnp.nanmedian(n_speeds, axis=1)
        mad = jnp.nanmedian(jnp.abs(n_speeds - med[:, None]), axis=1)
        kth_dist = jnp.sqrt(jnp.maximum(n_sq[:, -1], 0.0))
        return med, mad, kth_dist

    med, mad, kth = map_query_tiles(tile, pts, query_tile)
    z = jnp.abs(speed - med) / (mad + 1e-6)
    keep = z <= threshold
    radius = jnp.median(kth)
    return keep, radius


def remove_outliers_threshold(cloud: PointCloud, max_speed: float = 10.0,
                              verbose: bool = True) -> PointCloud:
    # host numpy on purpose: the values live on host before/after, and a
    # 500k-point norm is microseconds of CPU vs ~8 MB of round-trip
    # transfer for zero device compute (`speed_threshold_mask` stays the
    # jitted form for on-device pipelines)
    v = np.asarray(cloud.values, np.float32)
    keep = np.sqrt((v * v).sum(axis=-1)) <= max_speed
    n_removed = int((~keep).sum())
    if n_removed > 0:
        if verbose:
            print(f"  Threshold Filter: Removed {n_removed} points with speed > {max_speed}.")
        return cloud.select(keep)
    return cloud


@functools.lru_cache(maxsize=8)
def _mad_consume(k: int, threshold: float):
    """Scatter-block consumer: per-point keep flag + k-th neighbor distance.

    The query set IS the point set, so the nearest candidate (distance 0)
    is the point itself — dropped like the reference's ``idx[:, 1:]``
    (`filtering.py:26-30`). Neighbor *speeds* ride in the value channel.
    """
    def consume(sq, n_pos, n_val, ok, q):
        speeds = n_val[:, :, 0]
        own = speeds[:, 0]
        neigh = jnp.where(ok[:, 1:], speeds[:, 1:], jnp.nan)
        med = jnp.nanmedian(neigh, axis=1)
        mad = jnp.nanmedian(jnp.abs(neigh - med[:, None]), axis=1)
        z = jnp.abs(own - med) / (mad + 1e-6)
        keep = (z <= threshold).astype(jnp.float32)
        kth = jnp.sqrt(jnp.maximum(sq[:, -1], 0.0))
        return jnp.stack([keep, kth], axis=-1)
    return consume


def _host_exact_mad_decide(pts, speed, idx, k, threshold):
    """Exact keep decisions for a handful of panel-uncovered points:
    the reference formulation in f64 (`/root/reference/filtering.py:5-58`)
    brute-forced over the full cloud — one O(N) distance pass per point,
    so only sensible for len(idx) ≲ 16."""
    p = pts.astype(np.float64)
    s = np.asarray(speed, np.float64)
    # one vectorized (len(idx), N) distance pass — ~60 MB f64 at the
    # 16-point cap, vs one full traversal per point when looped
    d2 = ((p[idx, None, :] - p[None, :, :]) ** 2).sum(axis=2)
    kk = min(k + 1, len(p) - 1)
    nn = np.argpartition(d2, kk, axis=1)[:, :k + 2]
    ord_ = np.argsort(np.take_along_axis(d2, nn, axis=1), axis=1,
                      kind="stable")
    nn = np.take_along_axis(nn, ord_, axis=1)[:, :k + 1]
    neigh = s[nn[:, 1:]]                        # drop one self-copy
    med = np.median(neigh, axis=1)
    mad = np.median(np.abs(neigh - med[:, None]), axis=1)
    return np.abs(s[idx] - med) / (mad + 1e-6) <= threshold


def knn_mad_mask_scatter(points, values, k: int = 25, threshold: float = 3.0,
                         interpret: bool = False, **kwargs):
    """At-scale kNN-MAD decisions.

    On the GPU the default route is the fused panel kernel
    (``ops/fused_mad.py``, chosen by ``ops.kernels.select_kernels``):
    every statistic the filter needs (k-th distance, median, MAD) is an
    order statistic, found by monotone counting over a streamed candidate
    panel — no sort, no selection, no neighbor gathers. Queries the panel
    could not certify (domain corners, density holes — flagged via the
    coverage sentinel) are re-decided exactly through the selection-based
    scatter kernel.

    On the CPU (or when the cloud's density exceeds the kernel's capacity
    bounds, or a caller pins selection behavior via ``kwargs``), the
    scatter-block kernel serves: O(k) candidates per point via
    ``approx_min_k``; even at ``recall_target=0.95`` decisions match
    ``exact_topk=True`` on ≥99.9% of points (tests/test_filtering.py),
    shipped default 0.99. ``interpret=True`` runs the fused kernel in the
    Pallas interpreter."""
    from ptv_interpolation_tpu.ops.grid_knn import scatter_knn_apply
    from ptv_interpolation_tpu.ops.kernels import select_kernels

    pts = np.asarray(points, np.float32)
    v = np.asarray(values, np.float32)
    speed = np.sqrt((v * v).sum(axis=-1, keepdims=True))

    if select_kernels(interpret) == "triton" and not kwargs:
        from ptv_interpolation_tpu.ops.fused_mad import fused_mad_filter
        res = fused_mad_filter(pts, speed[:, 0], int(k), float(threshold),
                               interpret=interpret)
        if res is not None:
            keep, covered, radius, _ = res
            unc = ~covered
            n_unc = int(unc.sum())
            if 0 < n_unc <= 16:
                # a handful of corner/density-hole points: exact f64
                # re-decide on host — one O(N) pass per point beats a
                # whole second kernel dispatch chain
                keep[unc] = _host_exact_mad_decide(
                    pts, speed[:, 0], np.flatnonzero(unc), int(k),
                    float(threshold))
                n_unc = 0
            elif 0 < n_unc <= 0.05 * len(pts):
                sub = scatter_knn_apply(
                    pts, speed, pts[unc], k + 1,
                    _mad_consume(int(k), float(threshold)), out_dim=2,
                    exact_topk=True)
                keep[unc] = sub[:, 0] > 0.5
                n_unc = 0
            if n_unc == 0:
                return keep, radius
            # pathological coverage (>5% uncovered): selection path below

    out = scatter_knn_apply(pts, speed, pts, k + 1,
                            _mad_consume(int(k), float(threshold)),
                            out_dim=2, **kwargs)
    keep = out[:, 0] > 0.5
    radius = float(np.median(out[:, 1]))
    return keep, radius


def remove_outliers_knn(cloud: PointCloud, k: int = 25, threshold: float = 3.0,
                        use_celllist: bool | None = None,
                        verbose: bool = True) -> PointCloud:
    n = len(cloud)
    if n <= k:
        if verbose:
            print(f"  Warning: point cloud too small ({n}) for k-NN filter (k={k}). Skipping.")
        return cloud
    if use_celllist is None:
        use_celllist = n > 200_000  # O(N²) beyond this is wasteful
    if use_celllist:
        from ptv_interpolation_tpu.ops.grid_knn import RowCapacityError
        try:
            keep, radius = knn_mad_mask_scatter(cloud.points, cloud.values,
                                                k=k, threshold=threshold)
        except RowCapacityError:
            # pathologically clustered cloud: fall back to the generic
            # cell-list path (its per-cell capacity is not bound by the
            # scatter kernel's 1024-row padding) — but keep the candidate
            # panel bounded: the (2r+1)³·cap gather grows with the global
            # max cap, so an unbounded cap OOMs before it is slow. When even
            # the cell list cannot bound the panel (cap is a global max),
            # the streamed brute-force tile loop is the exact, memory-
            # bounded answer — slow at this size, but these clouds are
            # pathological by construction (the scatter kernel already
            # refused them after refinement).
            pts_np = np.asarray(cloud.points, np.float32)
            cells = build_cell_list(pts_np, k_hint=k + 1)
            if 27 * cells.cap > 16384:
                cells = None
            keep, radius = knn_mad_mask(cloud.points, cloud.values, k=k,
                                        threshold=threshold, cells=cells)
    else:
        keep, radius = knn_mad_mask(cloud.points, cloud.values, k=k,
                                    threshold=threshold)
        keep = np.asarray(keep)
    keep = np.asarray(keep)
    if verbose:
        print(f"  Filtering radius: median voxel distance to {k}-th neighbor = {float(radius):.4f}")
    n_removed = int((~keep).sum())
    if n_removed > 0:
        if verbose:
            print(f"  Outlier Filter: Removed {n_removed} points ({n_removed / n * 100:.2f}%).")
        return cloud.select(keep)
    if verbose:
        print("  Outlier Filter: No outliers detected.")
    return cloud


def apply_filters(cloud: PointCloud, config: FilterConfig,
                  verbose: bool = True) -> PointCloud:
    """Centralized filtering entry point (`filtering.py:75-89`)."""
    if not config.filter_outliers:
        return cloud
    cloud = remove_outliers_threshold(cloud, config.filter_max_speed, verbose)
    if len(cloud) > 0:
        cloud = remove_outliers_knn(cloud, k=config.filter_neighbors,
                                    threshold=config.filter_threshold,
                                    verbose=verbose)
    return cloud
