#!/usr/bin/env python
"""Characterize the headline divergence-parity gap.

Decomposes the bench's 64³-subvolume mean-|div| relative error into:
  * the f32 floor — exact KDTree k-set, weight math replayed in f32 vs the
    f64 reference (neighbor selection identical, only precision differs);
  * the approx-selection term — the block kernel at recall_target 0.9 /
    0.95 / 0.99 and with exact τ (true k-th distance), each vs the f64
    reference;
and records the 256³ wall-clock cost of each config beside its parity.

Reference math: /root/reference/interpolator.py:83-124 (sibson) +
/root/reference/physics.py:6-53 (FV divergence used by the metric).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

GRID_N = 256
N_POINTS = 1_000_000
K = 50
SUB = slice(96, 160)


def log(msg):
    print(msg, flush=True)


def make_problem(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, GRID_N, size=(N_POINTS, 3)).astype(np.float32)
    vals = np.stack([
        np.sin(pts[:, 0] * 0.05),
        np.cos(pts[:, 1] * 0.04),
        1.0 + 0.1 * np.sin(pts[:, 2] * 0.03),
    ], axis=-1).astype(np.float32)
    return pts, vals


def sibson_weights_np(dist, dtype):
    """The reference sibson math (interpolator.py:102-116) at a chosen
    precision. dist: (Q, k)."""
    eps = dtype(1e-10)
    dist = dist.astype(dtype)
    inv = dtype(1.0) / (dist + eps)
    w = inv / inv.sum(1, keepdims=True)
    std = dist.std(1, keepdims=True)
    w = w * np.exp(-dist / (std + eps))
    return w / w.sum(1, keepdims=True)


def div_err(field, ref_field, consistent_divergence):
    mask = np.ones(field.shape[:3], bool)
    d_o = np.asarray(consistent_divergence(
        field[..., 0], field[..., 1], field[..., 2], mask, 1, 1, 1))
    d_r = np.asarray(consistent_divergence(
        ref_field[..., 0], ref_field[..., 1], ref_field[..., 2],
        mask, 1, 1, 1))
    inner = (slice(2, -2),) * 3
    return float(np.abs(d_o[inner] - d_r[inner]).mean()
                 / (np.abs(d_r[inner]).mean() + 1e-30))


def main():
    import jax
    from ptv_interpolation_tpu.utils import enable_compilation_cache
    enable_compilation_cache()

    from ptv_interpolation_tpu.grid import create_grid
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        sibson_grid_interpolate)
    from ptv_interpolation_tpu.ops.stencils import consistent_divergence

    log(f"devices: {jax.devices()}")
    pts, vals = make_problem()
    grid = create_grid(((0, GRID_N + 1),) * 3, GRID_N)
    nsub = SUB.stop - SUB.start
    # evaluate the reference at the MAIN grid's node coordinates — a fresh
    # linspace over the index range displaces the samples by up to 0.38
    # voxels and fabricates an ~8e-2 divergence "gap" (the round-1 bug:
    # exact-tau and recall=0.99 both plateaued at div=0.0467)
    gx, gy, gz = (np.asarray(grid.x), np.asarray(grid.y), np.asarray(grid.z))
    ZZ, YY, XX = np.meshgrid(gz[SUB], gy[SUB], gx[SUB], indexing="ij")
    sub_q = np.stack([XX.ravel(), YY.ravel(), ZZ.ravel()], axis=-1)

    # ---- exact KDTree neighbor sets on the subvolume ----
    log("KDTree exact k-set on the 64^3 subvolume...")
    from scipy.spatial import KDTree
    tree = KDTree(pts.astype(np.float64))
    dist, idx = tree.query(sub_q.astype(np.float64), k=K, workers=-1)
    v64 = vals[idx].astype(np.float64)

    w64 = sibson_weights_np(dist, np.float64)
    ref64 = np.einsum("qk,qkc->qc", w64, v64).reshape(nsub, nsub, nsub, 3)

    # f32 floor: identical (exact) neighbor set, f32 weight math + f32
    # distances recomputed the way the kernel sees them (diff form on f32
    # coordinates)
    d32 = np.sqrt(((sub_q[:, None, :].astype(np.float32)
                    - pts[idx].astype(np.float32)) ** 2).sum(-1,
                  dtype=np.float32))
    w32 = sibson_weights_np(d32, np.float32)
    f32_field = np.einsum("qk,qkc->qc", w32.astype(np.float32),
                          vals[idx]).reshape(nsub, nsub, nsub, 3)
    floor = div_err(f32_field, ref64, consistent_divergence)
    l2_floor = float(np.linalg.norm(f32_field - ref64)
                     / np.linalg.norm(ref64))
    log(f"f32 floor (exact k-set, f32 math): div={floor:.4f}  "
        f"L2={l2_floor:.2e}")

    # ---- kernel configs ----
    rng = np.random.default_rng(1)
    iz = rng.integers(1, GRID_N - 1, 100_000)
    iy = rng.integers(1, GRID_N - 1, 100_000)
    ix = rng.integers(1, GRID_N - 1, 100_000)
    l2_q = np.stack([np.asarray(grid.x)[ix], np.asarray(grid.y)[iy],
                     np.asarray(grid.z)[iz]], -1).astype(np.float64)
    l2_dist, l2_idx = tree.query(l2_q, k=K, workers=-1)
    l2_w = sibson_weights_np(l2_dist, np.float64)
    l2_ref = np.einsum("qk,qkc->qc", l2_w, vals[l2_idx].astype(np.float64))

    configs = [
        ("recall=0.90", dict(recall_target=0.90)),
        ("recall=0.95", dict(recall_target=0.95)),
        ("recall=0.99", dict(recall_target=0.99)),
        ("exact-tau  ", dict(exact_tau=True)),
        ("bisect-tau ", dict(tau_mode="bisect")),
    ]
    if len(sys.argv) > 1:   # select configs by index, e.g. "0 1"
        sel = [int(a) for a in sys.argv[1:]]
        configs = [configs[i] for i in sel]
    rows = []
    for name, extra in configs:
        kw = dict(k=K, group=8, block=(4, 8, 16), **extra)
        out = sibson_grid_interpolate(pts, vals, grid, **kw)
        jax.block_until_ready(out)
        times = []
        for _ in range(2):
            t0 = time.time()
            out = sibson_grid_interpolate(pts, vals, grid, **kw)
            jax.block_until_ready(out)
            times.append(time.time() - t0)
        wall = float(np.median(times))
        o = np.asarray(out)
        de = div_err(o[SUB, SUB, SUB], ref64, consistent_divergence)
        l2 = float(np.linalg.norm(o[iz, iy, ix] - l2_ref)
                   / np.linalg.norm(l2_ref))
        rows.append(dict(config=name.strip(), wall_s=round(wall, 2),
                         l2=l2, div=de))
        log(f"{name}  wall={wall:6.2f}s  L2={l2:.2e}  div={de:.4f}")

    print(json.dumps({"f32_floor_div": floor, "f32_floor_l2": l2_floor,
                      "configs": rows}))


if __name__ == "__main__":
    main()
