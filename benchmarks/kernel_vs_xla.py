#!/usr/bin/env python
"""Each hand-written kernel against the plain XLA form of the same math,
end to end, on one GPU.

Three comparisons, each through the public entry point with only the
kernel route changed:

* ``headline``: 1M tracks → 256³ sibson k=50 (``bench.py``'s problem),
  ``backend='triton'`` vs ``backend='xla'``;
* ``production_interp``: the porous-glass production shape (161×168×243
  grid, ~650k tracks + boundary particles, sibson k=50, solid voxels
  skipped), same two routes;
* ``production_mad``: the production MAD filter (k=30, threshold 4) on the
  same cloud, the fused kernel vs the selection-based scatter path.

Per route: the first call (compile included) and the median of three warm
calls, run in turns (kernel, XLA, XLA, kernel, ...). Each comparison also
reports how far the two routes' outputs differ. Prints one JSON line per
comparison, stamped with the device, and refuses to run on anything but
a GPU.

    python benchmarks/kernel_vs_xla.py [headline] [production_interp]
                                       [production_mad]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _timed(fn):
    import jax
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def compare(name, routes, diff, reps=3):
    """Time ``routes`` ({label: zero-arg callable}) in turns; returns the
    result record."""
    first, outs = {}, {}
    for label, fn in routes.items():
        outs[label], first[label] = _timed(fn)
        log(f"  {name}/{label}: first call {first[label]:.3f}s")
    warm = {label: [] for label in routes}
    labels = list(routes)
    for i in range(reps):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            _, t = _timed(routes[label])
            warm[label].append(t)
    rec = {"cell": name,
           "first_call_s": first,
           "warm_s": {k: float(np.median(v)) for k, v in warm.items()},
           "warm_runs_s": warm,
           "route_difference": diff(*(outs[label] for label in labels))}
    log(f"  {name}: warm {rec['warm_s']}  diff {rec['route_difference']}")
    return rec


def _max_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def headline():
    from bench import K, make_grid, make_problem
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        sibson_grid_interpolate)
    pts, vals = make_problem()
    grid = make_grid()
    routes = {b: (lambda b=b: sibson_grid_interpolate(
        pts, vals, grid, k=K, tau_mode="bisect", backend=b))
        for b in ("triton", "xla")}
    return compare("headline_1M_256cubed_sibson", routes,
                   lambda a, b: {"max_rel": _max_rel(a, b)})


def production_problem():
    """The production pipeline's interpolation inputs at the crop shape:
    the grid and fluid mask at downscale 2, tracks + boundary particles."""
    from ptv_interpolation_tpu.datasets import porous_crop
    from ptv_interpolation_tpu.grid import (
        create_grid, extract_boundary_particles, sample_mask_on_grid)
    pts, vals, fluid_raw, _ = porous_crop.generate()
    nz, ny, nx = fluid_raw.shape
    bounds = ((0, nx), (0, ny), (0, nz))
    grid = create_grid(bounds, (round(nx / 2), round(ny / 2), round(nz / 2)))
    fluid = np.asarray(sample_mask_on_grid(fluid_raw, grid, bounds))
    bx, by, bz = extract_boundary_particles(fluid_raw, bounds,
                                            sampling_step=50, thickness=2)
    bpts = np.stack([bx, by, bz], axis=-1).astype(np.float32)
    all_pts = np.concatenate([pts, bpts])
    all_vals = np.concatenate([vals, np.zeros_like(bpts)])
    return pts, vals, all_pts, all_vals, grid, fluid


def production_interp(problem):
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        sibson_grid_interpolate)
    _, _, all_pts, all_vals, grid, fluid = problem
    routes = {b: (lambda b=b: sibson_grid_interpolate(
        all_pts, all_vals, grid, k=50, tau_mode="bisect", skip_mask=~fluid,
        backend=b)) for b in ("triton", "xla")}
    return compare("production_interp_161x168x243_sibson", routes,
                   lambda a, b: {"max_rel_fluid": _max_rel(
                       np.asarray(a)[fluid], np.asarray(b)[fluid])})


def production_mad(problem):
    from ptv_interpolation_tpu.filtering import knn_mad_mask_scatter
    pts, vals, *_ = problem
    routes = {
        "triton": lambda: knn_mad_mask_scatter(pts, vals, k=30,
                                               threshold=4.0)[0],
        # any selection keyword pins the selection-based scatter path
        "xla": lambda: knn_mad_mask_scatter(pts, vals, k=30, threshold=4.0,
                                            recall_target=0.99)[0],
    }
    return compare("production_mad_k30", routes,
                   lambda a, b: {"decisions_differing": int(
                       (np.asarray(a) != np.asarray(b)).sum()),
                       "n": int(len(pts))})


def main(argv):
    from ptv_interpolation_tpu.utils import (device_stamp,
                                             enable_compilation_cache)
    enable_compilation_cache()
    device = device_stamp("gpu")
    cells = argv or ["headline", "production_interp", "production_mad"]
    problem = None
    for cell in cells:
        if cell == "headline":
            rec = headline()
        else:
            if problem is None:
                problem = production_problem()
            rec = {"production_interp": production_interp,
                   "production_mad": production_mad}[cell](problem)
        rec["device"] = device
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
