#!/usr/bin/env python
"""256³ Woodbury variational solve on one GPU.

Confirms the batched 8-sublattice parity-MG V-cycle compiles and converges
at production budget (λ=200, tol=1e-8, the reference's CG budget at
`/root/reference/physics.py:485`) at the headline grid size, and prints
the compile + solve walls. The field is the scenario-5-style
porous problem (gyroid mask + smooth analytic velocity with deliberate
divergence).
"""

import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np



def make_field(n):
    ax = np.arange(n, dtype=np.float32) - n / 2
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    solid = (np.sin(X * 0.1) * np.sin(Y * 0.13) * np.sin(Z * 0.07)) > 0.55
    fluid = ~solid
    u = (0.05 * np.sin(X * 0.05) * fluid).astype(np.float32)
    v = (0.05 * np.cos(Y * 0.04) * fluid).astype(np.float32)
    w = ((1.0 + 0.1 * np.sin(Z * 0.03)) * fluid).astype(np.float32)
    return u, v, w, fluid


def main():
    import jax

    from ptv_interpolation_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    from ptv_interpolation_tpu.ops.stencils import consistent_divergence
    from ptv_interpolation_tpu.physics import clean_divergence_variational

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    lam = 200.0
    u, v, w, fluid = make_field(n)
    print(f"[woodbury256] grid {n}^3, porosity {fluid.mean():.3f}, "
          f"lambda={lam}, tol=1e-8", file=sys.stderr, flush=True)

    t0 = time.time()
    res = clean_divergence_variational(u, v, w, fluid, 1.0, 1.0, 1.0,
                                       lambda_reg=lam, tol=1e-8,
                                       maxiter=2000, solver="woodbury")
    jax.block_until_ready(res.u)
    t_first = time.time() - t0

    t0 = time.time()
    res = clean_divergence_variational(u, v, w, fluid, 1.0, 1.0, 1.0,
                                       lambda_reg=lam, tol=1e-8,
                                       maxiter=2000, solver="woodbury")
    jax.block_until_ready(res.u)
    t_warm = time.time() - t0

    div0 = consistent_divergence(u, v, w, fluid, 1.0, 1.0, 1.0)
    div1 = consistent_divergence(res.u, res.v, res.w, fluid, 1.0, 1.0, 1.0)
    m0 = float(np.abs(np.asarray(div0)).mean())
    m1 = float(np.abs(np.asarray(div1)).mean())
    import json
    print(json.dumps({
        "tool": "woodbury_256", "n": n, "lambda": lam,
        "first_s": round(t_first, 2), "warm_s": round(t_warm, 2),
        "iters": int(res.cg_iterations), "converged": bool(res.converged),
        "mean_abs_div_before": m0, "mean_abs_div_after": m1,
        "reduction_x": round(m0 / max(m1, 1e-30), 1)}), flush=True)


if __name__ == "__main__":
    main()
