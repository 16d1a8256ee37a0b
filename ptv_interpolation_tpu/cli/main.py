"""Interpolation pipeline CLI — flag-compatible with the reference
``python main.py`` (`/root/reference/main.py:22-52`)."""

from __future__ import annotations

import argparse
import os
import sys

from ptv_interpolation_tpu.pipeline import PipelineConfig, run_pipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Interpolate 3D PTV velocity field.")
    p.add_argument("--input", "-i", required=True,
                   help="Input CSV file with columns x, y, z, u, v, w")
    p.add_argument("--mask", "-m",
                   help="Optional 3D mask TIFF file (0=solid, >0=fluid)")
    p.add_argument("--downscale", "-s", type=float, default=1.0,
                   help="Downscale factor relative to mask (default 1.0)")
    p.add_argument("--divergence-free", "-d", action="store_true",
                   help="Apply iterative divergence cleaning.")
    p.add_argument("--iter", type=int, default=3, dest="iterations",
                   help="Number of iterations for divergence cleaning (projection method).")
    p.add_argument("--cleaning-method", default="projection",
                   choices=["projection", "variational"],
                   help="Divergence cleaning method.")
    p.add_argument("--cleaning-lambda", type=float, default=1000.0,
                   help="Regularization for variational cleaning.")
    p.add_argument("--output-tif", "-o", help="Output TIFF filename")
    p.add_argument("--output-npz", help="Output NPZ filename for raw data")
    p.add_argument("--crop", type=int, nargs=6,
                   help="Crop region: xmin xmax ymin ymax zmin zmax")
    p.add_argument("--method", default="linear",
                   choices=["linear", "nearest", "cubic", "rbf", "idw", "sibson"],
                   help="Interpolation method")
    p.add_argument("--rbf-neighbors", type=int, default=20,
                   help="Number of neighbors for local RBF (3D)")
    p.add_argument("--rbf-kernel", default="thin_plate_spline",
                   help="RBF kernel (thin_plate_spline, cubic, quintic, gaussian, ...)")
    p.add_argument("--smoothing", type=float, default=0.0,
                   help="Smoothing parameter for RBF interpolation")
    p.add_argument("--idw-power", type=float, default=2.0,
                   help="Power parameter for IDW")
    p.add_argument("--idw-neighbors", type=int, default=50,
                   help="Number of neighbors for IDW")
    p.add_argument("--sibson-neighbors", type=int, default=30,
                   help="Number of neighbors for Sibson interpolation")
    p.add_argument("--tau-mode", choices=["bisect", "approx", "exact"],
                   default="bisect",
                   help="Grid-kernel k-th-distance selection: 'bisect' "
                        "(exact, default), 'approx' (approx_min_k fast "
                        "mode), 'exact' (top_k oracle)")
    p.add_argument("--cubic-fallback", action="store_true",
                   help="method=cubic is 2D-only in scipy griddata; opt in "
                        "to the documented 3D substitute (rbf kernel=cubic)")
    p.add_argument("--boundary-particles", action="store_true",
                   help="Add virtual zero-velocity particles at the fluid-solid interface.")
    p.add_argument("--boundary-sampling", type=int, default=1,
                   help="Sampling step for boundary particles")
    p.add_argument("--boundary-thickness", type=int, default=1,
                   help="Number of solid voxel layers for boundary particles")
    p.add_argument("--filter-outliers", action="store_true",
                   help="Remove velocity magnitude outliers using k-NN median filter.")
    p.add_argument("--filter-neighbors", type=int, default=25)
    p.add_argument("--filter-threshold", type=float, default=3.0)
    p.add_argument("--filter-max-speed", type=float, default=10.0)
    p.add_argument("--no-plot", action="store_true", help="Don't show the plot.")
    p.add_argument("--invert-mask", action="store_true",
                   help="Invert mask logic (swap fluid/solid)")
    p.add_argument("--data-offset", type=int, nargs=3,
                   help="Offset to align data to mask: x y z")
    p.add_argument("--swap-xy", action="store_true",
                   help="Swap X and Y coordinates and velocities")
    p.add_argument("--mask-transpose", type=int, nargs=3,
                   help="Transpose mask axes: e.g., 2 1 0")
    p.add_argument("--n-jobs", type=int, default=1,
                   help="Accepted for reference-script compatibility; "
                        "parallelism is the device mesh here")
    p.add_argument("--tri-cache-dir", default=None,
                   help="Directory to persist Delaunay triangulations "
                        "(method=linear) across runs; repeated runs on the "
                        "same point cloud skip the Qhull build (~43 s at "
                        "1M points). Also honors $PTV_TRI_CACHE_DIR.")
    p.add_argument("--daemon", "-D", action="store_true",
                   help="Run through the persistent serving daemon "
                        "(ptv-daemon): the first request warms the process "
                        "once, later invocations skip the fresh-process "
                        "compile/load cost entirely. Also enabled by "
                        "PTV_DAEMON=1. Implies --no-plot.")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ptv_interpolation_tpu import daemon
    if daemon.wants_daemon(args.daemon) and not os.environ.get("PTV_IN_DAEMON"):
        fwd = [a for a in (argv if argv is not None else sys.argv[1:])
               if a not in ("--daemon", "-D")]
        if not args.no_plot:
            fwd.append("--no-plot")  # the daemon cannot open a viewer here
        rc = daemon.dispatch("interpolate", fwd)
        if rc is not None:
            return rc
        print("daemon unavailable; running inline", file=sys.stderr)
    if daemon.inline_blocked():
        return 1
    from ptv_interpolation_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    config = PipelineConfig(
        input=args.input, mask=args.mask, downscale=args.downscale,
        divergence_free=args.divergence_free, iterations=args.iterations,
        cleaning_method=args.cleaning_method,
        cleaning_lambda=args.cleaning_lambda, output_tif=args.output_tif,
        output_npz=args.output_npz, crop=args.crop, method=args.method,
        rbf_neighbors=args.rbf_neighbors, rbf_kernel=args.rbf_kernel,
        smoothing=args.smoothing, idw_power=args.idw_power,
        idw_neighbors=args.idw_neighbors,
        sibson_neighbors=args.sibson_neighbors,
        cubic_fallback=args.cubic_fallback, tau_mode=args.tau_mode,
        boundary_particles=args.boundary_particles,
        boundary_sampling=args.boundary_sampling,
        boundary_thickness=args.boundary_thickness,
        filter_outliers=args.filter_outliers,
        filter_neighbors=args.filter_neighbors,
        filter_threshold=args.filter_threshold,
        filter_max_speed=args.filter_max_speed, no_plot=args.no_plot,
        invert_mask=args.invert_mask,
        data_offset=tuple(args.data_offset) if args.data_offset else None,
        swap_xy=args.swap_xy,
        mask_transpose=tuple(args.mask_transpose) if args.mask_transpose else None,
        tri_cache_dir=args.tri_cache_dir,
    )
    result = run_pipeline(config)

    if not args.no_plot:
        print("Opening visualizer (interactive)...")
        from ptv_interpolation_tpu.viz import show
        u = (result.u, result.u_init) if result.has_dual else result.u
        v = (result.v, result.v_init) if result.has_dual else result.v
        w = (result.w, result.w_init) if result.has_dual else result.w
        show(u, v, w, result.x, result.y, result.z, mask=result.mask)
    print("Done.")


if __name__ == "__main__":
    main()
