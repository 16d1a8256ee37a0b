"""Synthetic stand-in for the reference's porous-glass production run.

The reference's production launcher (`run_porous_glass.py:15-17,42`,
`interpolate_porous_glass.py:58-76`) crops the sintered-glass scan to
322×337×486 voxels (x, y, z), interpolates at downscale 2 (a 161×168×243
grid), and seeds it with ~650k tracks (1M tracks per 657³ scan). This
module generates a problem of that shape and seeding from a seed: a
porous fluid mask at the crop's full resolution, tracks in mask-voxel
coordinates inside the pore space, a smooth velocity field, and a small
fraction of gross speed outliers for the MAD filter to remove (all below
the production ``--filter-max-speed 5`` so only the MAD stage can catch
them).
"""

from __future__ import annotations

import numpy as np

CROP_SHAPE = (486, 337, 322)       # (z, y, x) mask voxels of the crop
N_TRACKS = 650_000


def generate(n_tracks: int = N_TRACKS, shape=CROP_SHAPE, seed: int = 0,
             outlier_frac: float = 0.002):
    """Return ``(points, values, fluid, outliers)``: (N, 3) f32 track
    positions (x, y, z in mask voxels), (N, 3) f32 velocities, the
    (z, y, x) bool fluid mask, and the indices of the planted outliers.

    ``shape`` other than :data:`CROP_SHAPE` scales the geometry with it
    (small problems for tests); the track density follows ``n_tracks``."""
    nz, ny, nx = shape
    # pore geometry: a product of sines thresholded to ~30% solid, its
    # wavelengths scaled with the crop so smaller test crops keep the same
    # pore count per axis
    fz, fy, fx = (0.04 * 486 / nz, 0.07 * 337 / ny, 0.055 * 322 / nx)
    sz = np.sin((np.arange(nz) - nz / 2) * fz)[:, None, None]
    sy = np.sin((np.arange(ny) - ny / 2) * fy)[None, :, None]
    sx = np.sin((np.arange(nx) - nx / 2) * fx)[None, None, :]
    fluid = (sz * sy * sx) <= 0.1

    rng = np.random.default_rng(seed)
    n_draw = int(n_tracks / max(fluid.mean(), 1e-3) * 1.1) + 64
    pts = rng.uniform((0, 0, 0), (nx, ny, nz),
                      size=(n_draw, 3)).astype(np.float32)
    idx = np.minimum(pts.astype(np.int64), (nx - 1, ny - 1, nz - 1))
    pts = pts[fluid[idx[:, 2], idx[:, 1], idx[:, 0]]][:n_tracks]
    vals = np.stack([
        0.05 * np.sin(pts[:, 0] * 0.025),
        0.05 * np.cos(pts[:, 1] * 0.02),
        1.0 + 0.1 * np.sin(pts[:, 2] * 0.015),
    ], axis=-1).astype(np.float32)
    outliers = rng.choice(len(pts), int(len(pts) * outlier_frac),
                          replace=False)
    vals[outliers] *= 3.5
    return pts, vals, fluid, np.sort(outliers)


def write(csv_path: str, mask_path: str, **kwargs):
    """Write the problem as the CLI's inputs: a ``x,y,z,u,v,w`` CSV and a
    uint8 (z, y, x) mask TIFF (nonzero = fluid). Returns ``generate``'s
    tuple."""
    from ptv_interpolation_tpu.io.csvio import PointCloud, save_ptv_data
    from ptv_interpolation_tpu.io.tiff import write_tiff

    pts, vals, fluid, outliers = generate(**kwargs)
    save_ptv_data(csv_path, PointCloud(pts, vals))
    write_tiff(mask_path, fluid.astype(np.uint8))
    return pts, vals, fluid, outliers
