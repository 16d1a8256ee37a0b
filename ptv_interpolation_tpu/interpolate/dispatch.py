"""Interpolation dispatcher — the `interpolate_field` entry point.

One call serving the six methods of the reference dispatcher
(`/root/reference/interpolator.py:65-203`):

  linear   — Delaunay barycentric (host Qhull topology + device eval)
  nearest  — kNN k=1 on device
  cubic    — unsupported in 3D (scipy's griddata 'cubic' is 2D-only; the
             reference would raise from Qhull too). Raises with guidance,
             or serves local RBF kernel='cubic' under cubic_fallback=True.
  rbf      — local kNN RBF (batched small solves); `neighbors=None` escalates
             to the global dense solve
  idw      — inverse-distance weighting
  sibson   — the reference's smoothed-IDW variant

All device paths accept an optional prebuilt CellList so repeated calls
(e.g. filtering + interpolation) share one spatial index.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ptv_interpolation_tpu.grid import Grid
from ptv_interpolation_tpu.interpolate.delaunay import linear_interpolate
from ptv_interpolation_tpu.interpolate.knn_weights import (
    idw_interpolate,
    nearest_interpolate,
    sibson_interpolate,
)
from ptv_interpolation_tpu.interpolate.rbf_global import rbf_global_interpolate
from ptv_interpolation_tpu.interpolate.rbf_local import rbf_local_interpolate
from ptv_interpolation_tpu.ops.neighbors import CellList, build_cell_list

_CELLLIST_THRESHOLD = 2 ** 31  # Q·N beyond which brute force is wasteful


def interpolate_values(points, values, queries, method: str = "linear",
                       rbf_neighbors: Optional[int] = 20,
                       rbf_kernel: str = "thin_plate_spline",
                       smoothing: float = 0.0, epsilon: float = 1.0,
                       idw_power: float = 2.0, idw_neighbors: int = 50,
                       sibson_neighbors: int = 30,
                       cells: CellList | None = None,
                       neighbor_method: str = "auto",
                       rings: int = 1, verbose: bool = False,
                       cubic_fallback: bool = False,
                       tri_cache_dir: Optional[str] = None):
    """Interpolate scattered ``values`` (N, C) onto ``queries`` (Q, 3)."""
    n_pts = int(np.asarray(points).shape[0])
    n_q = int(np.asarray(queries).shape[0])

    def make_progress():
        # the reference prints per-chunk progress during long RBF
        # evaluations (interpolator.py:192-193); mirror it at ~10% steps
        if not verbose or n_q < 500_000:
            return None
        last = [0]

        def report(done, total):
            pct = done * 10 // total
            if pct > last[0]:
                last[0] = pct
                print(f"  Interpolated {done}/{total} points...", flush=True)
        return report

    def get_cells(k):
        nonlocal cells
        if neighbor_method == "bruteforce":
            return None
        if neighbor_method == "auto" and n_pts * n_q <= _CELLLIST_THRESHOLD:
            return None
        if cells is None:
            cells = build_cell_list(np.asarray(points), k_hint=k)
            # bound the (2r+1)³·cap candidate panel: on clustered clouds
            # (e.g. boundary particles dense on an interface) the auto
            # cell size can hold thousands of points per cell, and the
            # per-tile candidate panel grows with it without bound (105k
            # candidates per query exhausted device memory). `cap` is a
            # global max, so cell
            # refinement cannot bound it for genuinely clustered clouds;
            # the exact answer at this path's moderate N is the streamed
            # brute-force tile loop (memory O(tile·chunk), no panel).
            if (2 * rings + 1) ** 3 * cells.cap > 16384:
                cells = None
        return cells

    if method == "sibson":
        if verbose:
            print(f"Using Sibson (Natural Neighbor) Interpolation (neighbors={sibson_neighbors})...")
        k = min(sibson_neighbors, n_pts)
        return sibson_interpolate(points, values, queries, k=k,
                                  cells=get_cells(k), rings=rings)
    if method == "idw":
        if verbose:
            print(f"Using IDW Interpolation (power={idw_power}, neighbors={idw_neighbors})...")
        k = min(idw_neighbors, n_pts)
        return idw_interpolate(points, values, queries, k=k, power=idw_power,
                               cells=get_cells(k), rings=rings)
    if method == "rbf":
        if rbf_neighbors is None or rbf_neighbors >= n_pts:
            if verbose:
                print(f"Using global RBF ({rbf_kernel}), dense solve over {n_pts} points...")
            return rbf_global_interpolate(points, values, queries,
                                          kernel=rbf_kernel,
                                          smoothing=smoothing, epsilon=epsilon,
                                          progress=make_progress())
        if verbose:
            print(f"Using RBF Interpolation ({rbf_kernel}) with {rbf_neighbors} "
                  f"neighbors, smoothing={smoothing}...")
        k = min(rbf_neighbors, n_pts)
        return rbf_local_interpolate(points, values, queries, k=k,
                                     kernel=rbf_kernel, smoothing=smoothing,
                                     epsilon=epsilon, cells=get_cells(k),
                                     rings=rings, progress=make_progress())
    if method == "nearest":
        return nearest_interpolate(points, values, queries,
                                   cells=get_cells(1), rings=rings)
    if method == "linear":
        return linear_interpolate(points, values, queries, fill_value=0.0,
                                  cache_dir=tri_cache_dir)
    if method == "cubic":
        # scipy's griddata 'cubic' is 2D-only (the reference dispatcher at
        # interpolator.py:196-197 would raise from Qhull too on 3D data).
        # With cubic_fallback=True we serve the documented substitute — a
        # local RBF with the cubic kernel, a smooth C² 3D interpolant.
        if cubic_fallback:
            if verbose:
                print("method='cubic': serving local RBF (kernel='cubic') "
                      "as the 3D substitute...")
            k = min(rbf_neighbors or 20, n_pts)
            return rbf_local_interpolate(points, values, queries, k=k,
                                         kernel="cubic", smoothing=smoothing,
                                         cells=get_cells(k), rings=rings)
        raise ValueError(
            "method='cubic' is 2D-only in scipy's griddata and unsupported "
            "in 3D here as well — pass cubic_fallback=True (CLI: "
            "--cubic-fallback) to serve rbf kernel='cubic' instead.")
    raise ValueError(f"unknown interpolation method {method!r}")


# Q·N above which the block kernel serves instead of the generic per-query
# kNN path: the block kernel's shared candidate gathers pay off once the
# problem is large, the generic path's lower fixed cost wins below. The
# crossover has not been measured on a GPU (PERF.md, Open questions).
_GRID_FASTPATH_MIN_WORK = 2 ** 29


def interpolate_field(points, values, grid: Grid, method: str = "linear",
                      use_grid_kernel: str = "auto", skip_mask=None,
                      tau_mode: str = "bisect", **kwargs):
    """Interpolate onto a :class:`Grid`; returns ``(U, V, W)`` arrays of
    shape ``grid.shape`` — the reference `interpolate_field` contract
    (`interpolator.py:65-203`).

    For the kNN methods on large problems the evaluation routes through
    the block-centric grid kernel (`ops/grid_knn.py`) — exploiting the
    regular-grid structure of the queries is where the order-of-magnitude
    speedup over the scipy path comes from. ``use_grid_kernel``:
    'auto' (size-based), 'always', or 'never'.

    ``skip_mask`` ((nz,ny,nx) bool, True = value will be discarded): lets
    the grid kernel skip exact repair of uncovered nodes the caller
    overwrites anyway — the pipeline passes the solid mask here, since
    solid voxels are zeroed right after (`main.py:201-207`).
    """
    n_pts = int(np.asarray(points).shape[0])
    work = n_pts * grid.n_points
    use_fast = (use_grid_kernel == "always"
                or (use_grid_kernel == "auto"
                    and work >= _GRID_FASTPATH_MIN_WORK and n_pts >= 4096))
    if use_fast and method in ("idw", "sibson", "rbf"):
        from ptv_interpolation_tpu.interpolate.knn_weights import (
            idw_grid_interpolate, sibson_grid_interpolate)
        if method == "idw":
            out = idw_grid_interpolate(
                points, values, grid, k=min(kwargs.get("idw_neighbors", 50), n_pts),
                power=kwargs.get("idw_power", 2.0), skip_mask=skip_mask,
                tau_mode=tau_mode)
        elif method == "sibson":
            out = sibson_grid_interpolate(
                points, values, grid,
                k=min(kwargs.get("sibson_neighbors", 30), n_pts),
                skip_mask=skip_mask, tau_mode=tau_mode)
        else:
            from ptv_interpolation_tpu.interpolate.rbf_local import (
                rbf_local_grid_interpolate)
            rbf_neighbors = kwargs.get("rbf_neighbors", 20)
            if rbf_neighbors is None or rbf_neighbors >= n_pts:
                use_fast = False  # global RBF: no grid fast path
            else:
                out = rbf_local_grid_interpolate(
                    points, values, grid, k=min(rbf_neighbors, n_pts),
                    kernel=kwargs.get("rbf_kernel", "thin_plate_spline"),
                    smoothing=kwargs.get("smoothing", 0.0),
                    epsilon=kwargs.get("epsilon", 1.0))
        if use_fast:
            return out[..., 0], out[..., 1], out[..., 2]

    if method == "linear":
        # grid targets use the fastest measured exact evaluator (scipy's
        # walk+blend; Qhull triangulation dominates the wall either way —
        # see interpolate/delaunay.py)
        from ptv_interpolation_tpu.interpolate.delaunay import (
            linear_grid_interpolate)
        out = linear_grid_interpolate(points, values, grid, fill_value=0.0,
                                      cache_dir=kwargs.get("tri_cache_dir"))
        return out[..., 0], out[..., 1], out[..., 2]

    queries = grid.flat_coords()
    out = interpolate_values(points, values, queries, method=method, **kwargs)
    out = out.reshape(grid.shape + (out.shape[-1],))
    U = out[..., 0]
    V = out[..., 1]
    W = out[..., 2]
    return U, V, W
