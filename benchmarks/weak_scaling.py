#!/usr/bin/env python
"""Multi-GPU scaling of the two sharded hot paths.

Runs the block-centric grid kernel
(`parallel/sharding.py::sharded_grid_interpolate`) and z-slab projection
cleaning (`physics.py::clean_divergence_projection` under GSPMD z-sharding)
on 1, 2 and 4 GPUs (as many as the machine has) on the SAME problem and
reports wall-clock plus the deviation from the single-device result. Refuses
to run without a GPU.

Run:  python benchmarks/weak_scaling.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ptv_interpolation_tpu.grid import create_grid
    from ptv_interpolation_tpu.parallel.mesh import DATA_AXIS
    from ptv_interpolation_tpu.parallel.sharding import sharded_grid_interpolate
    from ptv_interpolation_tpu.physics import clean_divergence_projection
    from ptv_interpolation_tpu.utils import (device_stamp,
                                             enable_compilation_cache)

    enable_compilation_cache()
    device = device_stamp("gpu")
    devices = np.asarray(jax.devices())

    # ---- problem: 60k points -> 64^3 grid, gyroid mask for cleaning ----
    rng = np.random.default_rng(0)
    n = 64
    pts = rng.uniform(0, n, size=(60_000, 3)).astype(np.float32)
    vals = np.stack([
        np.sin(pts[:, 0] * 0.1), np.cos(pts[:, 1] * 0.08),
        1.0 + 0.1 * np.sin(pts[:, 2] * 0.06)], -1).astype(np.float32)
    grid = create_grid(((0, n + 1),) * 3, n)
    ax = np.arange(n) - n / 2
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    fluid = (np.sin(X * 0.1) * np.sin(Y * 0.13) * np.sin(Z * 0.07)) <= 0.55

    rows = []
    ref_interp = None
    ref_clean = None
    for n_dev in (d for d in (1, 2, 4) if d <= len(devices)):
        mesh = Mesh(devices[:n_dev], (DATA_AXIS,))

        # ---- sharded headline kernel ----
        out = sharded_grid_interpolate(pts, vals, grid, mesh, k=30)
        jax.block_until_ready(out)           # compile + warmup
        t0 = time.time()
        out = sharded_grid_interpolate(pts, vals, grid, mesh, k=30)
        jax.block_until_ready(out)
        t_interp = time.time() - t0
        o = np.asarray(out)
        if ref_interp is None:
            ref_interp = o
        interp_dev = float(np.abs(o - ref_interp).max())

        # ---- z-slab projection cleaning ----
        zshard = NamedSharding(mesh, P(DATA_AXIS))
        U = jax.device_put(jnp.asarray(o[..., 0] * fluid), zshard)
        V = jax.device_put(jnp.asarray(o[..., 1] * fluid), zshard)
        W = jax.device_put(jnp.asarray(o[..., 2] * fluid), zshard)
        M = jax.device_put(jnp.asarray(fluid), zshard)
        res = clean_divergence_projection(U, V, W, M, 1.0, 1.0, 1.0,
                                          iterations=1, maxiter=60)
        jax.block_until_ready(res.u)         # compile + warmup
        t0 = time.time()
        res = clean_divergence_projection(U, V, W, M, 1.0, 1.0, 1.0,
                                          iterations=1, maxiter=60)
        jax.block_until_ready(res.u)
        t_clean = time.time() - t0
        c = np.asarray(res.u)
        if ref_clean is None:
            ref_clean = c
        clean_dev = float(np.abs(c - ref_clean).max())

        rows.append(dict(devices=n_dev,
                         interp_s=round(t_interp, 2),
                         interp_overhead=round(t_interp / rows[0]["interp_s"], 2) if rows else 1.0,
                         clean_s=round(t_clean, 2),
                         clean_overhead=round(t_clean / rows[0]["clean_s"], 2) if rows else 1.0,
                         interp_max_dev=interp_dev,
                         clean_max_dev=clean_dev))
        print(f"devices={n_dev}  kernel {t_interp:6.2f}s "
              f"(x{rows[-1]['interp_overhead']:.2f})  cleaning {t_clean:6.2f}s "
              f"(x{rows[-1]['clean_overhead']:.2f})  "
              f"parity dev: {interp_dev:.2e} / {clean_dev:.2e}", flush=True)

    print(json.dumps({"device": device, "rows": rows}))


if __name__ == "__main__":
    main()
