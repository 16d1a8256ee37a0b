#!/usr/bin/env python
"""The reference's PRODUCTION problem shape, end to end.

`run_porous_glass.py:15-17,42` + `interpolate_porous_glass.py:13-16,58-76`:
a 657×657×656 scan cropped to 322×337×486 and downscaled 2× → a
161×168×243 grid, with the production flag set (MAD outlier filter
k=30/thr 4/vmax 5, boundary particles stride 50/thickness 2, sibson
k=50, variational cleaning λ=200). The reference runs this on a
workstation via scipy + a 4-process pool; this script runs the same
configuration through the pipeline on one GPU, over the synthetic
production problem of ``datasets/porous_crop.py`` (the one
``chip_smoke.py`` feeds the CLI), and prints one JSON line with the
stage walls of the second (warm) run.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from ptv_interpolation_tpu.utils import (StageTimings, device_stamp,
                                             enable_compilation_cache)
    enable_compilation_cache()
    device = device_stamp("gpu")
    from ptv_interpolation_tpu.datasets import porous_crop
    from ptv_interpolation_tpu.io.csvio import PointCloud
    from ptv_interpolation_tpu.pipeline import PipelineConfig, run_pipeline

    pts, vals, fluid, _ = porous_crop.generate()
    # examples/porous_glass.py's flags; the mask is generated already
    # cropped to the production crop
    cfg = PipelineConfig(
        method="sibson", downscale=2, sibson_neighbors=50,
        divergence_free=True, cleaning_method="variational",
        cleaning_lambda=200.0, boundary_particles=True, boundary_sampling=50,
        boundary_thickness=2, filter_outliers=True, filter_neighbors=30,
        filter_threshold=4.0, filter_max_speed=5.0, verbose=False)

    def run():
        timings = StageTimings()
        t0 = time.perf_counter()
        res = run_pipeline(cfg, cloud=PointCloud(pts, vals), mask_raw=fluid,
                           timings=timings)
        return res, timings, time.perf_counter() - t0

    run()                                           # compile + warm
    res, timings, wall = run()

    print(json.dumps({
        "scenario": "production_shape_161x168x243",
        "value": wall, "unit": "s",
        "stages_s": timings.stages,
        "n_tracks": int(len(pts)),
        "grid": list(res.u.shape),
        "device": device,
    }), flush=True)


if __name__ == "__main__":
    main()
