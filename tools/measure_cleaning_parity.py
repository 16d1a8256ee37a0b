#!/usr/bin/env python
"""At-scale variational-cleaning parity vs the reference solver: at 128³ on the porous scenario-4 problem, run

* the reference's own operator-assembled solve (sparse
  `build_divergence_operators` + bmat CG, `/root/reference/physics.py:
  356-491`, scipy 1.17 rtol-kwarg fix only) to its own budget
  (rtol=1e-8, maxiter=2000), and
* our matrix-free SPD-CG (`physics.clean_divergence_variational`) to the
  same budget, plus the capped maxiter=200 configuration the round-2
  scenarios used,

on the SAME input field, and report cleaned-field rel-L2 between the two
solvers plus both walls — so the scenario speedups are quoted at equal
convergence.
"""

import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np



def main():
    import jax

    from ptv_interpolation_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    from benchmarks.scenarios import porous_problem
    from ptv_interpolation_tpu.grid import create_grid
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        sibson_grid_interpolate)
    from ptv_interpolation_tpu.physics import clean_divergence_variational
    from tools.measure_scenarios import _variational_scipy

    n = 128
    pts, vals, fluid = porous_problem(500_000, n)
    grid = create_grid(((0, n + 1), (0, n + 1), (0, n + 1)), n)
    maskf = fluid.astype(np.float32)

    print("building the shared input field (sibson 500k→128³)...",
          flush=True)
    out = sibson_grid_interpolate(pts, vals, grid, k=50)
    u = np.asarray(out[..., 0]) * maskf
    v = np.asarray(out[..., 1]) * maskf
    w = np.asarray(out[..., 2]) * maskf

    # ---- ours, reference budget ----
    for label, maxiter in (("reference budget (tol=1e-8, maxiter=2000)",
                            2000),
                           ("capped (maxiter=200)", 200)):
        res = clean_divergence_variational(u, v, w, fluid, *grid.spacing,
                                           lambda_reg=200.0, tol=1e-8,
                                           maxiter=maxiter)
        jax.block_until_ready((res.u, res.v, res.w))
        t0 = time.time()
        res = clean_divergence_variational(u, v, w, fluid, *grid.spacing,
                                           lambda_reg=200.0, tol=1e-8,
                                           maxiter=maxiter)
        jax.block_until_ready((res.u, res.v, res.w))
        wall = time.time() - t0
        print(f"ours {label}: {wall:.2f}s, iters={int(res.cg_iterations)}, "
              f"converged={bool(res.converged)}, "
              f"div ÷{float(res.mean_abs_div_initial / res.mean_abs_div_final):.2f}",
              flush=True)
        if maxiter == 2000:
            ours = (np.asarray(res.u), np.asarray(res.v), np.asarray(res.w))

    # ---- reference solver, same budget ----
    print("reference sparse solve (host scipy)...", flush=True)
    t0 = time.time()
    x, info = _variational_scipy(u.astype(np.float64), v.astype(np.float64),
                                 w.astype(np.float64), fluid, lam=200.0,
                                 maxiter=2000)
    t_ref = time.time() - t0
    n_fluid = int(fluid.sum())
    ru = np.zeros_like(u)
    rv = np.zeros_like(v)
    rw = np.zeros_like(w)
    ru[fluid] = x[:n_fluid]
    rv[fluid] = x[n_fluid:2 * n_fluid]
    rw[fluid] = x[2 * n_fluid:]
    print(f"reference: {t_ref:.1f}s (cg info={info})", flush=True)

    # ---- parity ----
    num = 0.0
    den = 0.0
    for a, b in zip(ours, (ru, rv, rw)):
        num += float(np.sum((a[fluid] - b[fluid]) ** 2))
        den += float(np.sum(b[fluid] ** 2))
    rel = np.sqrt(num / den)
    print(f"\ncleaned-field rel-L2 (ours @ reference budget vs reference "
          f"solver): {rel:.2e}", flush=True)


if __name__ == "__main__":
    main()
