#!/usr/bin/env python
"""Measure the reference SciPy path for scenarios 2-5 (PERF.md). Scenario
1 (IDW 64³) completes directly; the expensive configs are
measured on slabs and projected linearly (the per-query work is uniform),
with the projection noted in the output.

Reference math being timed:
  S1: KDTree k=50 IDW over 64³ nodes (/root/reference/interpolator.py:126-155)
  S2: RBFInterpolator neighbors=None gaussian (interpolator.py:162-167)
  S3: KDTree MAD filter (filtering.py:5-58) + RBFInterpolator neighbors=20
      over 128³ nodes (interpolator.py:157-195)
  S4: KDTree sibson over 128³ (interpolator.py:83-124) + variational
      cleaning via sparse (I+λDᵀD) CG (physics.py:440-514)
  S5: the 256³ versions of S4's two stages (the full-pipeline dominators)

Run: python tools/measure_scenarios.py [1 2 3 4 5]   (CPU-only, no jax)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def emit(name, wall, extra=None):
    rec = {"scenario": name, "reference_s": round(wall, 2), "unit": "s"}
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def grid_queries(n, lo=0.0):
    g = np.linspace(lo, lo + n - 1, n)
    Z, Y, X = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)


def porous_problem(n_points, n, seed=0):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + "/benchmarks")
    from scenarios import porous_problem as pp
    return pp(n_points, n, seed)


def sibson_eval(tree, vals, queries, k=50):
    dist, idx = tree.query(queries, k=k, workers=-1)
    eps = 1e-10
    inv = 1.0 / (dist + eps)
    w = inv / inv.sum(1, keepdims=True)
    std = dist.std(1, keepdims=True)
    w = w * np.exp(-dist / (std + eps))
    w /= w.sum(1, keepdims=True)
    return np.einsum("qk,qkc->qc", w, vals[idx])


def scenario_1():
    from ptv_interpolation_tpu.datasets import sphere_pack
    from scipy.spatial import KDTree
    cloud, solid, _ = sphere_pack.generate(n_points=8000, size=64,
                                           voxel_units=True)
    q = grid_queries(64)
    t0 = time.time()
    tree = KDTree(cloud.points.astype(np.float64))
    dist, idx = tree.query(q, k=50, workers=-1)
    w = 1.0 / (dist ** 2.0 + 1e-10)
    w /= w.sum(1, keepdims=True)
    np.einsum("qk,qkc->qc", w, cloud.values[idx])
    emit("1_idw_sphere_pack_64", time.time() - t0)


def scenario_2():
    from ptv_interpolation_tpu.datasets import cylinders
    from scipy.interpolate import RBFInterpolator
    cloud, _, bounds = cylinders.generate(n_points=5000)
    (x0, x1), (y0, y1), (z0, z1) = bounds
    gx = np.linspace(x0, x1 - 1, 64)
    gy = np.linspace(y0, y1 - 1, 32)
    gz = np.linspace(z0, z1 - 1, 16)
    Z, Y, X = np.meshgrid(gz, gy, gx, indexing="ij")
    q = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    t0 = time.time()
    interp = RBFInterpolator(cloud.points.astype(np.float64), cloud.values,
                             kernel="gaussian", epsilon=2.0,
                             smoothing=1e-3, degree=-1)
    interp(q)
    emit("2_global_gaussian_rbf_cholesky", time.time() - t0,
         {"n_points": len(cloud.points)})


def _mad_filter(pts, vals, k=25, threshold=3.0):
    from scipy.spatial import KDTree
    speed = np.sqrt((vals ** 2).sum(-1))
    tree = KDTree(pts)
    dist, idx = tree.query(pts, k=k + 1, workers=-1)
    ns = speed[idx[:, 1:]]
    med = np.median(ns, axis=1)
    mad = np.median(np.abs(ns - med[:, None]), axis=1)
    keep = np.abs(speed - med) / (mad + 1e-6) <= threshold
    return keep


def scenario_3(n_points=500_000, n=128, slab_frac=16):
    from scipy.interpolate import RBFInterpolator
    pts, vals, _ = porous_problem(n_points, n)
    rng = np.random.default_rng(3)
    vd = vals.copy()
    vd[rng.choice(len(pts), 1000, replace=False)] *= 20.0

    t0 = time.time()
    keep = _mad_filter(pts.astype(np.float64), vd, k=25)
    t_filter = time.time() - t0
    log(f"S3 filter: {t_filter:.1f}s kept {keep.sum()}")

    q = grid_queries(n)
    n_slab = len(q) // slab_frac
    t0 = time.time()
    interp = RBFInterpolator(pts[keep].astype(np.float64), vd[keep],
                             neighbors=20, kernel="thin_plate_spline")
    interp(q[:n_slab])
    t_slab = time.time() - t0
    total = t_filter + t_slab * slab_frac
    emit("3_local_rbf_masked_filtered", total,
         {"filter_s": round(t_filter, 2),
          "projected_from_slab": f"1/{slab_frac} of queries"})


def _variational_scipy(u, v, w, mask, lam=200.0, maxiter=2000):
    """The reference variational cleaner timed on its OWN code: sparse
    Dx/Dy/Dz assembly via /root/reference/physics.py:356-438 plus the
    bmat + CG solve of physics.py:463-491, with the sole fix of
    scipy 1.17's cg(tol=) → cg(rtol=) kwarg rename (the reference's
    :485 call crashes otherwise — see tests/test_reference_parity.py)."""
    from scipy.sparse import bmat, eye
    from scipy.sparse.linalg import cg
    sys.path.insert(0, "/root/reference")
    import physics as ref_physics

    # physics.py:452-480, fluid-cell unknowns only
    Dx, Dy, Dz, _ = ref_physics.build_divergence_operators(mask, 1.0, 1.0,
                                                           1.0)
    n_fluid = int(mask.sum())
    I = eye(n_fluid)
    Dxx, Dxy, Dxz = Dx.T @ Dx, Dx.T @ Dy, Dx.T @ Dz
    Dyy, Dyz, Dzz = Dy.T @ Dy, Dy.T @ Dz, Dz.T @ Dz
    A = bmat([
        [I + lam * Dxx, lam * Dxy, lam * Dxz],
        [lam * Dxy.T, I + lam * Dyy, lam * Dyz],
        [lam * Dxz.T, lam * Dyz.T, I + lam * Dzz],
    ], format="csr")
    rhs = np.concatenate([u[mask], v[mask], w[mask]])
    x, info = cg(A, rhs, rtol=1e-8, maxiter=maxiter)
    return x, info


def scenario_4(n_points=500_000, n=128):
    from scipy.spatial import KDTree
    pts, vals, fluid = porous_problem(n_points, n)
    t0 = time.time()
    tree = KDTree(pts.astype(np.float64))
    q = grid_queries(n)
    # slab-projected sibson (uniform per-query work)
    n_slab = len(q) // 8
    t1 = time.time()
    sibson_eval(tree, vals, q[:n_slab], k=50)
    t_interp = (time.time() - t1) * 8 + (t1 - t0)
    log(f"S4 sibson (projected): {t_interp:.1f}s")

    u = np.zeros((n, n, n))
    v = np.zeros((n, n, n))
    w = np.ones((n, n, n)) * fluid
    t0 = time.time()
    _variational_scipy(u, v, w, fluid, lam=200.0)
    t_clean = time.time() - t0
    log(f"S4 variational: {t_clean:.1f}s")
    emit("4_divfree_with_flux_correction", t_interp + t_clean,
         {"interp_s_projected": round(t_interp, 2),
          "cleaning_s": round(t_clean, 2)})


def scenario_5():
    # the cleaning stage at 256³ (the sibson stage is the headline
    # problem's KDTree path, timed with bench.py's problem separately)
    n = 256
    _, _, fluid = porous_problem(1_000_000, n)
    u = np.zeros((n, n, n))
    v = np.zeros((n, n, n))
    w = np.ones((n, n, n)) * fluid
    t0 = time.time()
    _variational_scipy(u, v, w, fluid, lam=200.0)
    t_clean = time.time() - t0
    emit("5_porous_cleaning_256", t_clean, {"cleaning_s": round(t_clean, 2)})


def main():
    which = [int(a) for a in sys.argv[1:]] or [1, 2, 3, 4, 5]
    fns = {1: scenario_1, 2: scenario_2, 3: scenario_3, 4: scenario_4,
           5: scenario_5}
    for i in which:
        log(f"=== reference scenario {i} ===")
        fns[i]()


if __name__ == "__main__":
    main()
