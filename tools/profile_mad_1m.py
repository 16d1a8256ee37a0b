#!/usr/bin/env python
"""Scenario-5 filter breakdown: where the 1M-point kNN-MAD wall goes.

Scenario 5's `apply_filters` call (1M porous points, k=30, threshold=4,
max_speed=5) measures ~4.6 s warm while the 500k scenario-3 filter is
~1.3 s — super-linear. This probe runs the same call and attributes the
wall: speed-threshold stage, fused panel path (or its capacity
fallback), the exact re-decide of uncovered points, and host
scatter/compaction.

    PYTHONPATH=/root/repo:$PYTHONPATH python tools/profile_mad_1m.py [n_points [grid_n]]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from ptv_interpolation_tpu.utils import enable_compilation_cache
enable_compilation_cache()


def main(n_points=1_000_000, grid_n=256):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks"))
    from scenarios import porous_problem

    from ptv_interpolation_tpu import filtering as fl
    from ptv_interpolation_tpu.io.csvio import PointCloud
    from ptv_interpolation_tpu.filtering import FilterConfig, apply_filters
    from ptv_interpolation_tpu.ops import fused_mad as fm

    pts, vals, _ = porous_problem(n_points, grid_n)
    cloud = PointCloud(pts, vals)
    cfg = FilterConfig(filter_outliers=True, filter_neighbors=30,
                       filter_threshold=4.0, filter_max_speed=5.0)

    # ---- end-to-end apply_filters (scenario-5 exact call) ----
    apply_filters(cloud, cfg, verbose=False)      # warmup/compile
    walls = []
    for _ in range(3):
        t0 = time.time()
        out = apply_filters(cloud, cfg, verbose=False)
        walls.append(time.time() - t0)
    print(f"apply_filters end-to-end: {np.median(walls):.3f}s "
          f"(runs {' '.join(f'{w:.3f}' for w in walls)}), kept {len(out)}",
          flush=True)

    # ---- stage: speed threshold ----
    speed = np.sqrt((vals * vals).sum(axis=-1))
    t0 = time.time()
    keep_thr = speed <= 5.0
    pts_t = pts[keep_thr]
    vals_t = vals[keep_thr]
    t_thr = time.time() - t0
    print(f"threshold + host compaction: {t_thr:.3f}s "
          f"({len(pts_t)} survive)", flush=True)

    speed_t = np.sqrt((vals_t * vals_t).sum(axis=-1))

    # ---- stage: fused panel filter ----
    res = fm.fused_mad_filter(pts_t, speed_t, k=30, threshold=4.0)
    if res is None:
        print("fused_mad_filter: CAPACITY FALLBACK (returns None) — "
              "scenario 5 runs the scatter path!", flush=True)
    else:
        walls = []
        for _ in range(3):
            t0 = time.time()
            keep, covered, radius, _ = fm.fused_mad_filter(
                pts_t, speed_t, k=30, threshold=4.0)
            walls.append(time.time() - t0)
        n_unc = int((~covered).sum())
        print(f"fused_mad_filter warm: {np.median(walls):.3f}s "
              f"(runs {' '.join(f'{w:.3f}' for w in walls)}); "
              f"uncovered={n_unc} ({100.0 * n_unc / len(pts_t):.3f}%)",
              flush=True)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    g = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    main(n, g)
