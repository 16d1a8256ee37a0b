#!/usr/bin/env python
"""Smoke test of the system on one NVIDIA GPU, through its normal entry
points, at the production configuration.

    python chip_smoke.py            # one card: phases 1-3
    python chip_smoke.py --multi    # four cards: the multi-device path only

Phases (any failed check exits non-zero and prints no result line):

1. Device: the card's name and power limit (``nvidia-smi``, run before JAX
   starts), the JAX devices and the compile-cache directory. Anything but
   a GPU is an error — there is no CPU fallback.
2. Kernels at real widths: 1M tracks → 256³ sibson and IDW (k=50) through
   the compiled Triton kernel, against the f64 scipy reference (relative
   L2 on 100k nodes, finite-volume divergence on a 64³ subvolume) and
   against the plain XLA form on the same card; the fused MAD filter on
   the production cloud against the exact f64 decision.
3. Main path: the porous-glass production configuration
   (``examples/porous_glass.py``) through ``ptv-interpolate`` and
   ``ptv-analyze`` on a synthetic problem of the production shape
   (``datasets/porous_crop.py``), the device mesh-drag pipeline against
   the host extractor, and one ``--method linear`` pass on the 64³ sphere
   pack.

``--multi`` runs only the z-slab-sharded grid kernel (1M → 256³ over a
1-D mesh of four GPUs) and the z-slab-sharded variational solve, each
against the single-device result from the same process.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CARD = "?"


def say(label, value):
    """One measured number on its own line, labelled with the card."""
    print(f"{label}: {value}   [{CARD}]", flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_lines():
    """``nvidia-smi`` name and power limit of every card, from a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    check(lines, "nvidia-smi listed no card")
    return lines


class _Tee(io.TextIOBase):
    """stdout that is also kept, so the CLI's own report can be read."""

    def __init__(self, stream):
        self.stream = stream
        self.kept = io.StringIO()

    def write(self, s):
        self.stream.write(s)
        self.kept.write(s)
        return len(s)

    def flush(self):
        self.stream.flush()


def run_cli(main, argv, cwd):
    """Run a CLI entry point in-process from ``cwd`` (the CLIs write
    side files there); returns (its stdout, wall seconds)."""
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee), contextlib.chdir(cwd):
        rc = main(argv)
    check(rc in (None, 0), f"{main.__module__} returned {rc}")
    return tee.kept.getvalue(), time.perf_counter() - t0


def timed(fn):
    import jax
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def max_rel(a, b):
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------

def phase_device(n_cards):
    import jax

    from ptv_interpolation_tpu.utils import (device_stamp,
                                             enable_compilation_cache)
    cache = enable_compilation_cache()
    print(f"jax {jax.__version__}  devices: {jax.devices()}", flush=True)
    stamp = device_stamp("gpu")
    print(f"platform: {stamp['platform']}  device_kind: {stamp['kind']}  "
          f"count: {stamp['count']}", flush=True)
    print(f"compile cache: {cache}", flush=True)
    check(stamp["count"] >= n_cards,
          f"needs {n_cards} GPUs, JAX sees {stamp['count']}")
    return stamp


# ---------------------------------------------------------------------------
# Phase 2: kernels at real widths
# ---------------------------------------------------------------------------

def lowered_kernels(fn, *args):
    """Names of the Triton kernels in ``fn``'s lowering for this device —
    proof that the route is the compiled kernel and not interpret mode
    (the interpreter lowers to plain HLO loops, with no Triton call)."""
    import jax
    text = jax.jit(fn).lower(*args).as_text()
    if "__gpu$xla.gpu.triton" not in text:
        return []
    return sorted(set(re.findall(r'name = "([A-Za-z_0-9]+)"', text)))


def phase_kernels():
    import jax.numpy as jnp
    import numpy as np

    from bench import K, make_grid, make_problem, parity
    from ptv_interpolation_tpu import reference
    from ptv_interpolation_tpu.datasets import porous_crop
    from ptv_interpolation_tpu.filtering import knn_mad_mask_scatter
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        idw_grid_interpolate, sibson_grid_interpolate)
    from ptv_interpolation_tpu.ops import fused_grid_knn as fg
    from ptv_interpolation_tpu.ops import fused_mad as fm
    from ptv_interpolation_tpu.ops.kernels import select_kernels

    route = select_kernels()
    print(f"kernel route selected for this platform: {route}", flush=True)
    check(route == "triton", f"route {route!r} on a GPU")
    c = fg._CC * 2
    knn_names = lowered_kernels(
        lambda m2, cand, q: fg._fused_eval(m2, cand, q, q, q, (4, 4, 8), 50,
                                           3, c, "sibson", 2.0),
        jnp.ones((1,)), jnp.ones((8, 2 * c)), jnp.ones((4, fg._TQ)))
    mad_names = lowered_kernels(
        lambda m2, cand, q: fm._mad_eval(m2, cand, q, q, q, q, 30, 4.0, c),
        jnp.ones((1,)), jnp.ones((8, 2 * c)), jnp.ones((2, fg._TQ)))
    print(f"compiled Triton kernels (interpret=False): sibson/idw "
          f"{knn_names}, MAD {mad_names}", flush=True)
    check(knn_names == ["fused_grid_knn"], "kNN kernel not lowered to Triton")
    check(mad_names == ["fused_mad"], "MAD kernel not lowered to Triton")

    pts, vals = make_problem()
    grid = make_grid()
    cases = {
        "sibson": (sibson_grid_interpolate, {},
                   lambda p, v, q: reference.sibson_values(p, v, q, K)),
        "idw": (idw_grid_interpolate, {"power": 2.0},
                lambda p, v, q: reference.idw_values(p, v, q, K, 2.0)),
    }
    for mode, (fn, extra, ref) in cases.items():
        out, t_first = timed(lambda: fn(pts, vals, grid, k=K, tau_mode="bisect",
                                        backend="triton", **extra))
        _, t_warm = timed(lambda: fn(pts, vals, grid, k=K, tau_mode="bisect",
                                     backend="triton", **extra))
        say(f"{mode} 1M->256^3 k={K} triton first call (compile incl.) s",
            f"{t_first:.3f}")
        say(f"{mode} 1M->256^3 k={K} triton warm s", f"{t_warm:.3f}")
        out = np.asarray(out)
        check(out.shape == grid.shape + (3,) and np.isfinite(out).all(),
              f"{mode}: output shape/finite")
        l2, div_err = parity(out, pts, vals, grid, ref)
        say(f"{mode} relative L2 vs f64 scipy (100k nodes)", f"{l2:.3e}")
        say(f"{mode} mean-|div| relative error vs f64 scipy (64^3)",
            f"{div_err:.3e}")
        xla, t_xla = timed(lambda: fn(pts, vals, grid, k=K, tau_mode="bisect",
                                      backend="xla", **extra))
        say(f"{mode} plain XLA form first call s", f"{t_xla:.3f}")
        d_xla = max_rel(out, xla)
        say(f"{mode} max relative difference triton vs XLA", f"{d_xla:.3e}")
        check(l2 <= 1e-6, f"{mode} L2 {l2:.3e} > 1e-6")
        check(div_err <= 1e-5, f"{mode} divergence error {div_err:.3e} > 1e-5")
        check(d_xla <= 1e-5, f"{mode} triton vs XLA {d_xla:.3e} > 1e-5")
        del out, xla

    # MAD filter on the production cloud (k=30, threshold 4)
    ppts, pvals, _, planted = porous_crop.generate()
    speed = np.sqrt((pvals.astype(np.float32) ** 2).sum(axis=1))
    res = fm.fused_mad_filter(ppts, speed, 30, 4.0)
    check(res is not None, "MAD kernel refused the production cloud")
    _, covered, _, _ = res
    (keep, _), t_mad = timed(lambda: knn_mad_mask_scatter(ppts, pvals, k=30,
                                                          threshold=4.0))
    keep = np.asarray(keep)
    rng = np.random.default_rng(2)
    sub = np.sort(rng.choice(len(ppts), 20_000, replace=False))
    keep_ref = reference.mad_keep(ppts, pvals, 30, 4.0, idx=sub)
    n_diff = int((keep[sub] != keep_ref).sum())
    agree = 1.0 - n_diff / len(sub)
    say("MAD k=30 thr=4 on 650k tracks: knn_mad_mask_scatter s",
        f"{t_mad:.3f}")
    say("MAD decisions uncertain in the kernel, re-decided exactly",
        int((~covered).sum()))
    say("MAD decisions differing from f64 on 20k subsample", n_diff)
    say("MAD decision agreement", f"{agree:.6f}")
    say("MAD planted outliers removed",
        f"{int((~keep[planted]).sum())}/{len(planted)}")
    check(agree >= 0.9999, f"MAD agreement {agree:.6f} < 0.9999")
    print("precision: kernel arithmetic is f32 subtract/multiply/compare/"
          "count, sqrt and exp, with no matrix contraction; the references "
          "are f64 scipy on the host, and every device-side contraction "
          "runs at Precision.HIGHEST", flush=True)


# ---------------------------------------------------------------------------
# Phase 3: main path through the CLIs
# ---------------------------------------------------------------------------

def _report(text, pattern, what):
    m = re.search(pattern, text, re.MULTILINE)
    check(m is not None, f"CLI printed no {what}")
    return m.group(1)


def phase_main_path(work):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ptv_interpolation_tpu import drag
    from ptv_interpolation_tpu.cli import analyze_flow
    from ptv_interpolation_tpu.cli import main as interp_cli
    from ptv_interpolation_tpu.datasets import porous_crop, sphere_pack
    from ptv_interpolation_tpu.io import load_velocity_field

    os.environ.pop("PTV_DAEMON", None)       # run inline, one process
    csv = os.path.join(work, "porous_tracks.csv")
    tif = os.path.join(work, "porous_mask.tif")
    npz = os.path.join(work, "porous_field.npz")
    t0 = time.perf_counter()
    _, _, fluid_raw, _ = porous_crop.write(csv, tif)
    say("set-up: synthetic production problem written s",
        f"{time.perf_counter() - t0:.3f}")

    # examples/porous_glass.py's flags; the mask is written already cropped
    # to the production crop, so the lab scan's --crop/--data-offset
    # alignment is not needed (same 161x168x243 grid)
    argv = ["--input", csv, "--mask", tif, "--method", "sibson",
            "--downscale", "2", "--rbf-neighbors", "20", "--smoothing", "5",
            "--idw-power", "2", "--idw-neighbors", "40",
            "--sibson-neighbors", "50", "--divergence-free",
            "--cleaning-method", "variational", "--cleaning-lambda", "200",
            "--iter", "5", "--boundary-particles", "--boundary-sampling", "50",
            "--boundary-thickness", "2", "--filter-outliers",
            "--filter-neighbors", "30", "--filter-threshold", "4",
            "--filter-max-speed", "5", "--no-plot", "--output-npz", npz,
            "--output-tif", os.path.join(work, "porous_field.tif")]
    text, wall = run_cli(interp_cli.main, argv, work)
    say("ptv-interpolate production wall s (compile incl.)", f"{wall:.3f}")
    stages = re.findall(r"^\s+(\w+)\s+([\d.]+)s \(", text.split(
        "--- Stage timings ---")[-1], re.MULTILINE)
    check(stages, "no stage timings printed")
    for name, dt in stages:
        say(f"stage {name} s", dt)
    iters = int(_report(text, r"CG iterations:\s+(\d+)", "CG iterations"))
    reduction = float(_report(text, r"Total Reduction:\s+([\d.einf+]+)x",
                              "divergence reduction"))
    converged = "did not converge" not in text
    say("variational CG iterations", iters)
    say("variational CG converged", converged)
    say("mean-|div| reduction (x)", f"{reduction:.2f}")
    check(converged, "variational CG did not converge")
    check(reduction > 1.0, "cleaning did not reduce the divergence")

    field = load_velocity_field(npz)
    nz, ny, nx = (s // 2 for s in fluid_raw.shape)
    check(field.u.shape == (nz, ny, nx), f"field shape {field.u.shape}")
    for a in (field.u, field.v, field.w, field.u_init):
        check(np.isfinite(a).all(), "non-finite field values")
    check(not field.u[~field.mask].any(), "solid voxels not zeroed")
    fl = field.mask
    say("fluid-voxel mean w", f"{float(field.w[fl].mean()):.5f}")
    check(0.5 < float(field.w[fl].mean()) < 1.5, "implausible mean w")

    text, wall = run_cli(analyze_flow.main,
                         ["--input", npz, "--no-interactive", "--no-tiffs",
                          "--output-npz", os.path.join(work, "analysis.npz")],
                         work)
    say("ptv-analyze wall s (compile incl., mesh drag)", f"{wall:.3f}")
    check("Grain/Phase Label" in text, "analysis reported no drag")
    stats = jax.devices()[0].memory_stats() or {}
    say("device peak_bytes_in_use", stats.get("peak_bytes_in_use", "n/a"))

    # the device mesh pipeline against the host marching-tetrahedra
    # extractor, on the same field (label 1 = the fluid phase, as the
    # analysis labels it)
    dx, dy, dz = (float(a[1] - a[0]) for a in (field.x, field.y, field.z))
    u, v, w = (jnp.asarray(a, jnp.float32) for a in (field.u, field.v,
                                                     field.w))
    zero = jnp.zeros(u.shape, jnp.float32)
    label_vol = fl.astype(np.float64)
    forces = {}
    for on_device in (True, False):
        t0 = time.perf_counter()
        out = jax.device_get(drag._label_tractions(
            label_vol, u, v, w, zero, zero, False, dx, dy, dz, 1e-3, 1,
            on_device))
        forces[on_device] = {k: float(val) for k, val in out.items()}
        say(f"mesh drag label 1 {'device' if on_device else 'host'} "
            f"pipeline s", f"{time.perf_counter() - t0:.3f}")
    keys = [k for k in forces[False] if k.startswith("F")]
    scale = max(abs(forces[False][k]) for k in keys)
    d_drag = max(abs(forces[True][k] - forces[False][k]) for k in keys) / scale
    say("mesh drag label 1 device vs host max force difference (rel)",
        f"{d_drag:.3e}")
    check(d_drag <= 1e-3, f"device mesh drag differs by {d_drag:.3e}")

    # the default --method linear on the 64^3 sphere pack
    scsv = os.path.join(work, "spheres.csv")
    stif = os.path.join(work, "spheres_mask.tif")
    snpz = os.path.join(work, "spheres.npz")
    sphere_pack.generate(size=64, voxel_units=True, filename=scsv,
                         maskname=stif)
    _, wall = run_cli(interp_cli.main,
                      ["--input", scsv, "--mask", stif, "--invert-mask",
                       "--method", "linear", "--no-plot",
                       "--output-npz", snpz], work)
    say("ptv-interpolate --method linear 64^3 sphere pack wall s",
        f"{wall:.3f}")
    lin = load_velocity_field(snpz)
    check(lin.w.shape == (64, 64, 64) and np.isfinite(lin.w).all(),
          "linear pass output")
    say("linear sphere pack fluid mean w",
        f"{float(lin.w[lin.mask].mean()):.5f}")


# ---------------------------------------------------------------------------
# --multi: four cards
# ---------------------------------------------------------------------------

def phase_multi(n_dev):
    import jax
    import numpy as np

    from bench import K, make_grid, make_problem
    from ptv_interpolation_tpu.grid import create_grid
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        sibson_grid_interpolate)
    from ptv_interpolation_tpu.parallel.mesh import make_mesh, shard_fields
    from ptv_interpolation_tpu.parallel.sharding import (
        sharded_grid_interpolate)
    from ptv_interpolation_tpu.physics import clean_divergence_variational

    mesh = make_mesh(n_dev)
    pts, vals = make_problem()
    grid = make_grid()
    single, t1 = timed(lambda: sibson_grid_interpolate(
        pts, vals, grid, k=K, tau_mode="bisect"))
    say("1M->256^3 sibson single device s (compile incl.)", f"{t1:.3f}")
    _, t1_warm = timed(lambda: sibson_grid_interpolate(
        pts, vals, grid, k=K, tau_mode="bisect"))
    say("1M->256^3 sibson single device warm s", f"{t1_warm:.3f}")
    sharded, tn = timed(lambda: sharded_grid_interpolate(
        pts, vals, grid, mesh, method="sibson", k=K))
    say(f"1M->256^3 sibson z-slab sharded over {n_dev} GPUs s "
        f"(compile incl.)", f"{tn:.3f}")
    _, tn_warm = timed(lambda: sharded_grid_interpolate(
        pts, vals, grid, mesh, method="sibson", k=K))
    say(f"1M->256^3 sibson sharded over {n_dev} GPUs warm s",
        f"{tn_warm:.3f}")
    d = max_rel(sharded, single)
    say("sharded vs single-device max relative difference", f"{d:.3e}")
    check(np.isfinite(np.asarray(sharded)).all(), "sharded output finite")
    check(d <= 1e-6, f"sharded vs single {d:.3e} > 1e-6")

    # z-slab-sharded variational solve on a porous field of half the
    # headline grid's edge (128^3)
    n = make_grid().nx // 2
    g = create_grid(((0, n), (0, n), (0, n)), n)
    ax = np.arange(n) - n / 2
    fluid = (np.sin(ax * 0.11)[:, None, None] * np.sin(ax * 0.14)[None, :, None]
             * np.sin(ax * 0.08)[None, None, :]) <= 0.1
    rng = np.random.default_rng(3)
    u, v, w = (np.where(fluid, rng.normal(0, 0.1, fluid.shape) + c, 0.0)
               .astype(np.float32) for c in (0.0, 0.0, 1.0))
    um, vm, wm, mm = shard_fields(mesh, u, v, w, fluid)
    solves = {}
    for name, args in (("single device", (u, v, w, fluid)),
                       (f"sharded over {n_dev} GPUs", (um, vm, wm, mm))):
        solves[name], t_first = timed(lambda: clean_divergence_variational(
            *args, *g.spacing, lambda_reg=200.0))
        _, t_warm = timed(lambda: clean_divergence_variational(
            *args, *g.spacing, lambda_reg=200.0))
        say(f"variational {n}^3 {name} s (compile incl.)", f"{t_first:.3f}")
        say(f"variational {n}^3 {name} warm s", f"{t_warm:.3f}")
    ref, res = solves.values()
    say("variational solve sharded CG iterations / single",
        f"{int(res.cg_iterations)} / {int(ref.cg_iterations)}")
    check(bool(res.converged) and bool(ref.converged), "CG converged")

    def field(r):
        return np.stack([np.asarray(a, np.float64) for a in (r.u, r.v, r.w)])

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # the sharded f32 CG sums in another order, so single voxels differ by
    # a few f32 ulps. The same problem mirrored in z (w negated) is the
    # same arithmetic in another order on one device: its spread is the
    # floor the sharded solve is read against.
    def flip(a):
        return np.ascontiguousarray(np.asarray(a)[::-1])

    mir = clean_divergence_variational(flip(u), flip(v), -flip(w),
                                       flip(fluid), *g.spacing,
                                       lambda_reg=200.0)
    mir = mir._replace(u=flip(mir.u), v=flip(mir.v), w=-flip(mir.w))
    for name, a in (("sharded", res), ("z-mirrored single-device", mir)):
        per = " ".join(f"{c} {max_rel(getattr(a, c), getattr(ref, c)):.3e}"
                       for c in "uvw")
        say(f"variational {name} vs single device max relative difference "
            f"per component", per)
    dv = rel_l2(field(res), field(ref))
    say("variational sharded vs single-device relative L2", f"{dv:.3e}")
    check(dv <= 1e-6, f"sharded variational differs by {dv:.3e}")


def main(argv=None):
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded paths")
    args = ap.parse_args(argv)
    n_cards = 4 if args.multi else 1

    cards = card_lines()
    for line in cards:
        print(line, flush=True)
    CARD = cards[0]
    if not args.multi:
        subprocess.run(["sh", os.path.join(HERE, "native", "build.sh")],
                       check=True)
    stamp = phase_device(n_cards)
    if args.multi:
        phase_multi(n_cards)
    else:
        phase_kernels()
        work = tempfile.mkdtemp(prefix="ptv_smoke_")
        try:
            phase_main_path(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": stamp["platform"], "kind": stamp["kind"],
        "count": stamp["count"]}}), flush=True)


if __name__ == "__main__":
    main()
