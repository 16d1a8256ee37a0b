"""On-card parity of the compiled Triton kernels (``-m gpu``; these skip
without an NVIDIA GPU). Run on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernels.py

Each kernel is compared with the f64 scipy reference and with the plain
XLA form of the same math on the same card."""

import numpy as np
import pytest

from ptv_interpolation_tpu import reference
from ptv_interpolation_tpu.grid import create_grid

pytestmark = pytest.mark.gpu


def _problem(n_pts=200_000, n=96, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, n, size=(n_pts, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.1), np.cos(pts[:, 1] * 0.08),
                     1.0 + 0.1 * np.sin(pts[:, 2] * 0.06)],
                    axis=-1).astype(np.float32)
    grid = create_grid(((0, n + 1), (0, n + 1), (0, n + 1)), n)
    return pts, vals, grid


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_triton_kernel_matches_reference_and_xla(gpu, mode):
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        idw_grid_interpolate, sibson_grid_interpolate)
    pts, vals, grid = _problem()
    fn = sibson_grid_interpolate if mode == "sibson" else idw_grid_interpolate
    got = np.asarray(fn(pts, vals, grid, k=50, backend="triton"))
    xla = np.asarray(fn(pts, vals, grid, k=50, backend="xla"))
    rng = np.random.default_rng(1)
    idx = rng.integers(1, grid.nx - 1, size=(20_000, 3))
    q = np.stack([grid.x[idx[:, 2]], grid.y[idx[:, 1]], grid.z[idx[:, 0]]],
                 axis=-1).astype(np.float32)       # the nodes as computed
    ref = (reference.sibson_values(pts, vals, q, 50) if mode == "sibson"
           else reference.idw_values(pts, vals, q, 50))
    ours = got[idx[:, 0], idx[:, 1], idx[:, 2]]
    assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) <= 1e-6
    assert np.abs(got - xla).max() / np.abs(xla).max() <= 1e-5


def test_triton_mad_matches_reference(gpu):
    from ptv_interpolation_tpu.filtering import knn_mad_mask_scatter
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 40, size=(100_000, 3)).astype(np.float32)
    vals = np.stack([0.1 * np.sin(pts[:, 0]), 0.1 * np.cos(pts[:, 1]),
                     np.ones(len(pts))], axis=-1).astype(np.float32)
    out = rng.choice(len(pts), 200, replace=False)
    vals[out] *= 4.0
    keep, _ = knn_mad_mask_scatter(pts, vals, k=30, threshold=4.0)
    keep = np.asarray(keep)
    sub = rng.choice(len(pts), 10_000, replace=False)
    ref = reference.mad_keep(pts, vals, 30, 4.0, idx=sub)
    assert (keep[sub] == ref).mean() >= 0.9999
    assert not keep[out].any()
