#!/usr/bin/env python
"""Headline benchmark: 1M tracked vectors → 256³ grid sibson interpolation.

Runs on one GPU and refuses any other device. Prints ONE JSON line to
stdout: the median warm wall-clock of three runs, the first call
(compile included) separately, the device it ran on, and the parity of
the result against the f64 scipy reference
(``ptv_interpolation_tpu.reference``) on a 100k-node subsample (relative
L2) and on a 64³ subvolume (finite-volume divergence).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

GRID_N = 256
N_POINTS = 1_000_000
K = 50


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_problem(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, GRID_N, size=(N_POINTS, 3)).astype(np.float32)
    vals = np.stack([
        np.sin(pts[:, 0] * 0.05),
        np.cos(pts[:, 1] * 0.04),
        1.0 + 0.1 * np.sin(pts[:, 2] * 0.03),
    ], axis=-1).astype(np.float32)
    return pts, vals


def make_grid():
    from ptv_interpolation_tpu.grid import create_grid
    return create_grid(((0, GRID_N + 1), (0, GRID_N + 1), (0, GRID_N + 1)),
                       GRID_N)


def parity(out_np, pts, vals, grid, reference):
    """(relative L2 on a 100k-node subsample, mean-|div| relative error on
    the central 64³ subvolume) of ``out_np`` against ``reference(pts,
    vals, queries)``."""
    from ptv_interpolation_tpu.ops.stencils import consistent_divergence

    rng = np.random.default_rng(1)
    iz = rng.integers(1, GRID_N - 1, 100_000)
    iy = rng.integers(1, GRID_N - 1, 100_000)
    ix = rng.integers(1, GRID_N - 1, 100_000)
    # the nodes as the device holds them (f32): the f64 linspace values
    # are not representable, and evaluating the reference half an ulp away
    # shows up as a spurious ~1e-6 L2 gap
    queries = np.stack([grid.x[ix], grid.y[iy], grid.z[iz]],
                       axis=-1).astype(np.float32)
    ref = reference(pts, vals, queries)
    ours = out_np[iz, iy, ix]
    l2 = float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))

    # the reference is evaluated at the MAIN grid's node coordinates
    # (spacing 256/255): a fresh 64-node linspace would displace the
    # samples by up to 0.38 voxels and report a spurious divergence gap
    sl = slice(GRID_N // 2 - 32, GRID_N // 2 + 32)
    gx, gy, gz = (np.asarray(grid.x), np.asarray(grid.y), np.asarray(grid.z))
    ZZ, YY, XX = np.meshgrid(gz[sl], gy[sl], gx[sl], indexing="ij")
    ref_q = np.stack([XX.ravel(), YY.ravel(), ZZ.ravel()], axis=-1)
    ref_field = reference(pts, vals, ref_q).reshape(64, 64, 64, 3)
    ours_sub = out_np[sl, sl, sl]
    mask = np.ones((64, 64, 64), bool)
    div_ours = np.asarray(consistent_divergence(
        ours_sub[..., 0], ours_sub[..., 1], ours_sub[..., 2], mask, 1, 1, 1))
    div_ref = np.asarray(consistent_divergence(
        ref_field[..., 0], ref_field[..., 1], ref_field[..., 2], mask, 1, 1, 1))
    inner = (slice(2, -2),) * 3
    div_err = float(np.abs(div_ours[inner] - div_ref[inner]).mean()
                    / (np.abs(div_ref[inner]).mean() + 1e-30))
    return l2, div_err


def main():
    import jax

    from ptv_interpolation_tpu import reference
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        sibson_grid_interpolate,
    )
    from ptv_interpolation_tpu.utils import (device_stamp,
                                             enable_compilation_cache)

    enable_compilation_cache()
    device = device_stamp("gpu")
    log(f"devices: {jax.devices()}")
    pts, vals = make_problem()
    grid = make_grid()
    kwargs = dict(k=K, tau_mode="bisect", block=(8, 8, 16))

    log("compiling + warmup run...")
    t0 = time.time()
    out = sibson_grid_interpolate(pts, vals, grid, **kwargs)
    jax.block_until_ready(out)
    first = time.time() - t0
    log(f"  first call (cell build + compile + run): {first:.1f}s")

    times = []
    for i in range(3):
        t0 = time.time()
        out = sibson_grid_interpolate(pts, vals, grid, **kwargs)
        jax.block_until_ready(out)
        times.append(time.time() - t0)
        log(f"  run {i + 1}: {times[-1]:.3f}s")
    wall = float(np.median(times))

    log("parity against the f64 scipy reference...")
    l2, div_err = parity(np.asarray(out), pts, vals, grid,
                         lambda p, v, q: reference.sibson_values(p, v, q, K))
    log(f"  relative L2: {l2:.2e}   mean-|div| relative error: {div_err:.2e}")

    print(json.dumps({
        "metric": "1M tracks -> 256^3 sibson(k=50) interpolation wall-clock",
        "value": wall, "unit": "s", "first_call_s": first,
        "l2_parity": l2, "divergence_parity": div_err, "device": device,
    }), flush=True)


if __name__ == "__main__":
    main()
