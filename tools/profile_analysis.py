#!/usr/bin/env python
"""Profile the full analysis pipeline at 256³.

Builds the scenario-5 porous field shape (gyroid mask + smooth analytic
velocity, no interpolation — only the analysis is profiled), runs
``run_analysis`` with the production config (pressure recovery + mesh drag
+ TIFF exports) under StageTimings, and prints the per-stage breakdown.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_field(n=256):
    ax = np.arange(n) - n / 2
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    solid = (np.sin(X * 0.1) * np.sin(Y * 0.13) * np.sin(Z * 0.07)) > 0.55
    fluid = ~solid
    u = 0.05 * np.sin(X * 0.05) * fluid
    v = 0.05 * np.cos(Y * 0.04) * fluid
    w = (1.0 + 0.1 * np.sin(Z * 0.03)) * fluid
    x = y = z = np.arange(n, dtype=np.float64)
    return u, v, w, x, y, z, fluid


def main():
    import jax
    from ptv_interpolation_tpu.utils import enable_compilation_cache
    enable_compilation_cache()

    from ptv_interpolation_tpu.analyze import AnalyzeConfig, run_analysis
    from ptv_interpolation_tpu.io.npz import FieldResult
    from ptv_interpolation_tpu.utils import StageTimings

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    print(f"building {n}^3 field...", flush=True)
    u, v, w, x, y, z, fluid = make_field(n)
    field = FieldResult(x=x, y=y, z=z, u=u, v=v, w=w, mask=fluid)

    # two passes: the first pays per-process tracing + compile-cache
    # reads; the second is the true warm wall of the analysis programs
    for tag in ("first (trace + cache reads)", "warm"):
        timings = StageTimings()
        with tempfile.TemporaryDirectory() as tmp:
            cfg = AnalyzeConfig(input="profile.npz",
                                basename=os.path.join(tmp, "prof"),
                                flow_type=True, verbose=False)
            t0 = time.time()
            run_analysis(cfg, field=field, timings=timings)
            total = time.time() - t0
        print(f"--- {tag} ---")
        print(timings.report())
        print(f"  end-to-end: {total:.2f}s", flush=True)


if __name__ == "__main__":
    main()
