#!/usr/bin/env python
"""Linear (Delaunay/griddata) at the production shape: ours (simplex
rasterization, `interpolate/delaunay.py::linear_grid_interpolate`) vs the
reference's `scipy.interpolate.griddata(method='linear')`
(`/root/reference/interpolator.py:197`, production method per
`run_porous_glass.py:18`) on the 1M→256³ bench problem.

The scipy side walks the triangulation once per query; at 16.7M nodes
that is hours, so it is timed on a 1/64 z-slab and projected linearly
(per-query work is uniform — same methodology as the scenario baselines).
Parity is checked against the actual scipy values on the slab.
"""

import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

import jax  # noqa: E402

from ptv_interpolation_tpu.utils import enable_compilation_cache
enable_compilation_cache()


def main():
    from scipy.interpolate import LinearNDInterpolator
    from scipy.spatial import Delaunay

    from bench import GRID_N, make_problem
    from ptv_interpolation_tpu.grid import create_grid
    from ptv_interpolation_tpu.interpolate.delaunay import (
        linear_grid_interpolate)

    pts, vals = make_problem()
    grid = create_grid(((0, GRID_N + 1), (0, GRID_N + 1), (0, GRID_N + 1)),
                       GRID_N)

    t0 = time.time()
    tri = Delaunay(pts.astype(np.float64))
    t_tri = time.time() - t0
    print(f"Delaunay (Qhull, 1M pts, shared by both paths): {t_tri:.1f}s",
          flush=True)

    # ---- ours (default 'walk' evaluator) ----
    t0 = time.time()
    ours = linear_grid_interpolate(pts, vals, grid, tri=tri)
    t_walk = time.time() - t0
    print(f"ours (walk evaluator) 16.7M nodes: {t_walk:.1f}s", flush=True)

    # ---- raster oracle (kept for tests; loses at scale) ----
    t0 = time.time()
    rast = linear_grid_interpolate(pts, vals, grid, tri=tri,
                                   evaluator="raster")
    t_raster = time.time() - t0
    print(f"raster oracle 16.7M nodes: {t_raster:.1f}s", flush=True)
    del rast

    # ---- scipy: LinearNDInterpolator on a 1/64 z-slab, projected ----
    nz = GRID_N // 64
    gx, gy, gz = (np.asarray(grid.x), np.asarray(grid.y), np.asarray(grid.z))
    ZZ, YY, XX = np.meshgrid(gz[:nz], gy, gx, indexing="ij")
    slab_q = np.stack([XX.ravel(), YY.ravel(), ZZ.ravel()], axis=-1)
    t0 = time.time()
    interp = LinearNDInterpolator(tri, vals.astype(np.float64),
                                  fill_value=0.0)
    ref_slab = interp(slab_q)
    t_slab = time.time() - t0
    t_scipy = t_slab * 64
    print(f"scipy: slab of {len(slab_q)} nodes: {t_slab:.1f}s "
          f"→ projected full grid: {t_scipy:.1f}s", flush=True)

    # ---- parity on the slab ----
    ours_slab = np.asarray(ours)[:nz].reshape(-1, vals.shape[1])
    ref_slab = ref_slab.reshape(-1, vals.shape[1])
    denom = np.linalg.norm(ref_slab)
    l2 = float(np.linalg.norm(ours_slab - ref_slab) / denom)
    print(f"parity (rel L2, ours vs scipy on slab): {l2:.2e}", flush=True)

    wall_ours = t_tri + t_walk
    wall_ref = t_tri + t_scipy
    print(f"\nTOTAL ours {wall_ours:.1f}s (tri {t_tri:.1f} + walk "
          f"{t_walk:.1f}) vs reference {wall_ref:.1f}s (tri + slab-proj "
          f"walks) = {wall_ref / wall_ours:.2f}x; raster {t_raster:.1f}s",
          flush=True)


if __name__ == "__main__":
    main()
