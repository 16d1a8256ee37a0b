"""Parity tests for the fused two-phase grid kernel (XLA compact gather +
streaming Triton τ-bisect) against the exact gather-based oracle and the
streaming XLA τ-threshold path. Runs in Pallas interpret mode on CPU."""

import numpy as np
import pytest

from ptv_interpolation_tpu.grid import create_grid
from ptv_interpolation_tpu.interpolate.knn_weights import (
    idw_grid_interpolate,
    sibson_grid_interpolate,
)
from ptv_interpolation_tpu.ops.fused_grid_knn import (
    fused_grid_weighted_interpolate,
)


def _problem(n_pts=4000, n=24, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, n, size=(n_pts, 3)).astype(np.float32)
    vals = np.stack([
        np.sin(pts[:, 0] * 0.3),
        np.cos(pts[:, 1] * 0.2),
        1.0 + 0.1 * pts[:, 2] / n,
    ], axis=-1).astype(np.float32)
    grid = create_grid(((0, n + 1), (0, n + 1), (0, n + 1)), n)
    return pts, vals, grid


@pytest.mark.parametrize("mode", ["sibson", "idw"])
def test_fused_matches_exact_oracle(mode):
    pts, vals, grid = _problem()
    k = 12
    block = (2, 4, 8)
    if mode == "sibson":
        want = sibson_grid_interpolate(pts, vals, grid, k=k,
                                       exact_topk=True, block=block)
    else:
        want = idw_grid_interpolate(pts, vals, grid, k=k,
                                    exact_topk=True, block=block)
    got = fused_grid_weighted_interpolate(pts, vals, grid, k=k, mode=mode,
                                          block=block, interpret=True)
    got = np.asarray(got)
    want = np.asarray(want)
    assert np.isfinite(got).all()
    # τ-threshold selection is parity-equivalent to exact top-k; weights and
    # reductions are the same f32 formulas (order differences only)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.999, f"{mode}: {1 - close.mean():.2e} mismatch"
    # the handful of disagreeing nodes are domain corners where the
    # gather-based oracle has no repair stage and its candidate region can
    # miss true neighbors — there the FUSED result must match brute force
    bad = np.argwhere(~close.all(axis=-1))
    if len(bad):
        from ptv_interpolation_tpu.interpolate.knn_weights import (
            idw_interpolate, sibson_interpolate)
        q = np.stack([grid.x[bad[:, 2]], grid.y[bad[:, 1]],
                      grid.z[bad[:, 0]]], axis=-1).astype(np.float32)
        if mode == "sibson":
            truth = np.asarray(sibson_interpolate(pts, vals, q, k=k))
        else:
            truth = np.asarray(idw_interpolate(pts, vals, q, k=k))
        np.testing.assert_allclose(got[bad[:, 0], bad[:, 1], bad[:, 2]],
                                   truth, rtol=1e-4, atol=1e-5)


def test_fused_matches_streaming_xla_path():
    """The fused kernel and the streaming bisect-τ XLA path implement the
    same selection + weights — fields must agree to reduction-order noise."""
    from ptv_interpolation_tpu.ops.grid_knn import grid_weighted_interpolate
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        _sibson_panel_weights)
    pts, vals, grid = _problem(seed=5)
    k = 10
    block = (2, 4, 8)
    want = np.asarray(grid_weighted_interpolate(
        pts, vals, grid, k, _sibson_panel_weights(), mode="sibson",
        block=block, tau_mode="bisect"))
    got = np.asarray(fused_grid_weighted_interpolate(
        pts, vals, grid, k=k, mode="sibson", block=block, interpret=True))
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.999


def test_fused_void_region_repair():
    """Nodes without coverage (cloud confined to the lower half) must be
    repaired exactly — the den==0 sentinel contract shared with the
    streaming path."""
    rng = np.random.default_rng(11)
    pts = rng.uniform([0, 0, 0], [16, 16, 5], size=(800, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0]), np.cos(pts[:, 1]),
                     np.ones(len(pts))], axis=-1).astype(np.float32)
    grid = create_grid(((0, 17), (0, 17), (0, 17)), 16)
    got = np.asarray(fused_grid_weighted_interpolate(
        pts, vals, grid, k=8, mode="sibson", block=(2, 4, 8),
        interpret=True))
    # comparator: the streaming path WITH repair (the gather oracle has no
    # repair stage and returns zeros in the void)
    want = np.asarray(sibson_grid_interpolate(pts, vals, grid, k=8,
                                              block=(2, 4, 8)))
    assert np.isfinite(got).all()
    # constant-1 w channel must survive everywhere incl. the void
    assert got[..., 2].min() > 0.5
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.999


def test_fused_skip_mask_skips_repair():
    """skip_mask nodes are excluded from repair (they are overwritten by
    mask zeroing downstream) — same semantics as the streaming path."""
    rng = np.random.default_rng(13)
    pts = rng.uniform([0, 0, 0], [16, 16, 5], size=(800, 3)).astype(np.float32)
    vals = np.ones((len(pts), 3), np.float32)
    grid = create_grid(((0, 17), (0, 17), (0, 17)), 16)
    skip = np.zeros((16, 16, 16), bool)
    skip[8:] = True  # the void region
    got = np.asarray(fused_grid_weighted_interpolate(
        pts, vals, grid, k=8, mode="idw", block=(2, 4, 8), skip_mask=skip,
        interpret=True))
    assert np.isfinite(got).all()
    # covered nodes interpolate the constant field exactly
    assert abs(got[:4, ..., 0].mean() - 1.0) < 1e-3


def test_auto_backend_falls_back_on_clustered_cloud(monkeypatch):
    """backend='auto' must degrade to the streaming path when the
    compacted panel exceeds its capacity bound (FusedCapacityError), and
    backend='triton' must surface the error."""
    from ptv_interpolation_tpu.ops import fused_grid_knn as fg
    from ptv_interpolation_tpu.ops import grid_knn as gk
    from ptv_interpolation_tpu.ops.grid_knn import grid_weighted_interpolate
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        _sibson_panel_weights)

    pts, vals, grid = _problem(n_pts=2000, n=16)
    # the capacity guard itself
    with pytest.raises(fg.FusedCapacityError):
        fg.fused_grid_weighted_interpolate(pts, vals, grid, 8,
                                           mode="sibson", max_panel=1)

    # auto route: make the selection point pick the Triton kernels, make
    # the fused attempt refuse, and keep the repair stage off its kernel
    # path — the call must degrade to the streaming kernel and still
    # produce a finite field
    monkeypatch.setattr(gk, "select_kernels", lambda interpret=False: "triton")

    def refuse(*a, **k):
        raise fg.FusedCapacityError("forced")

    monkeypatch.setattr(fg, "fused_grid_weighted_interpolate", refuse)
    monkeypatch.setattr(fg, "fused_subset_weighted_sum",
                        lambda *a, **k: None)
    monkeypatch.setattr(fg, "fused_repair", lambda *a, **k: None)
    out = grid_weighted_interpolate(pts, vals, grid, 8,
                                    _sibson_panel_weights(), mode="sibson")
    assert np.isfinite(np.asarray(out)).all()


def test_fused_backend_rejects_custom_weight_fn():
    from ptv_interpolation_tpu.ops.grid_knn import grid_weighted_interpolate

    pts, vals, grid = _problem(n_pts=1000, n=12)
    with pytest.raises(ValueError, match="custom weight_fn"):
        grid_weighted_interpolate(pts, vals, grid, 8,
                                  lambda d, m, s: 1.0 / (d + 1e-6),
                                  mode="sibson", backend="triton")


def test_fused_clustered_cloud_matches_oracle():
    """Strongly clustered cloud (gaussian blobs + sparse background):
    non-uniform density stresses the compaction capacity planning and
    leaves void regions for the repair stage — the fused path must still
    match the exact gather-based oracle."""
    rng = np.random.default_rng(9)
    n = 24
    blobs = [rng.normal(loc=c, scale=1.5, size=(1200, 3))
             for c in ((6, 6, 6), (18, 16, 8), (10, 18, 18))]
    bg = rng.uniform(0, n, size=(300, 3))
    pts = np.clip(np.concatenate(blobs + [bg]), 0, n).astype(np.float32)
    vals = np.stack([
        np.sin(pts[:, 0] * 0.4), np.cos(pts[:, 1] * 0.3),
        1.0 + 0.05 * pts[:, 2]], axis=-1).astype(np.float32)
    grid = create_grid(((0, n + 1), (0, n + 1), (0, n + 1)), n)

    want = np.asarray(sibson_grid_interpolate(pts, vals, grid, k=10,
                                              exact_topk=True,
                                              block=(2, 4, 8)))
    got = np.asarray(fused_grid_weighted_interpolate(
        pts, vals, grid, k=10, mode="sibson", block=(2, 4, 8),
        interpret=True))
    assert np.isfinite(got).all()
    # on a clustered cloud ~half the nodes sit in sparse regions where
    # the ORACLE's fixed candidate region misses true neighbors (it has
    # no repair stage); the fused path routes those through exact repair.
    # Wherever the two disagree, brute force must side with FUSED.
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    bad = np.argwhere(~close)
    rng2 = np.random.default_rng(1)
    sub = (bad[rng2.choice(len(bad), 200, replace=False)]
           if len(bad) > 200 else bad)
    if len(sub):
        from ptv_interpolation_tpu.interpolate.knn_weights import (
            sibson_interpolate)
        q = np.stack([grid.x[sub[:, 2]], grid.y[sub[:, 1]],
                      grid.z[sub[:, 0]]], axis=-1).astype(np.float32)
        truth = np.asarray(sibson_interpolate(pts, vals, q, k=10))
        np.testing.assert_allclose(got[sub[:, 0], sub[:, 1], sub[:, 2]],
                                   truth, rtol=1e-4, atol=1e-5)


def test_single_dispatch_repair_matches_legacy_ladder():
    """The single-dispatch device repair (fused_grid_knn.fused_repair) must
    produce the same repaired field as the legacy host-mediated ladder
    (grid_knn.repair_empty_nodes) — same certification (widened-margin
    coverage sentinel), same values on certified nodes, and the same
    brute-force tail population."""
    import jax.numpy as jnp

    from ptv_interpolation_tpu.ops import grid_knn as gk
    from ptv_interpolation_tpu.ops.fused_grid_knn import (
        _block_total_capacity, _build_queries, _compact_gather,
        _fused_eval, _panel_width, _query_tile, _reassemble, fused_repair)

    rng = np.random.default_rng(21)
    n = 24
    # cloud confined to a corner slab → coverage fails near the far faces
    pts = rng.uniform([0, 0, 0], [n, n, 9], size=(2500, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.3), np.cos(pts[:, 1] * 0.2),
                     1.0 + 0.02 * pts[:, 2]], axis=-1).astype(np.float32)
    grid = create_grid(((0, n + 1), (0, n + 1), (0, n + 1)), n)
    k, block = 10, (2, 4, 8)

    setup = gk._host_setup(pts, vals, grid, k, None, None, block, 1.45,
                           cell_divisor=3.0)
    (cells, values_sorted, axes, margin, mc, _row_len, values_dev) = setup
    axes_np = tuple(np.asarray(a) for a in axes)
    C = _panel_width(_block_total_capacity(cells, axes_np, margin, block,
                                           grid.shape, mc))
    dims = tuple((s + b - 1) // b for s, b in zip(grid.shape, block))
    tq = _query_tile(block[0] * block[1] * block[2])
    cand = _compact_gather(cells, values_sorted, axes, jnp.float32(margin),
                           block, grid.shape, mc, C, 8)
    m2 = jnp.asarray([margin * margin], jnp.float32)
    qx, qy, qz = _build_queries(axes, block, dims, tq)
    out = _fused_eval(m2, cand, qx, qy, qz, block, k, vals.shape[1], C,
                      "sibson", 2.0, interpret=True)
    out = _reassemble(out, block, dims, grid.shape)
    field, den = out[..., :3], out[..., 3]
    n_uncovered = int((np.asarray(den) == 0).sum())
    assert n_uncovered > 50, "fixture must exercise repair"

    legacy = np.asarray(gk.repair_empty_nodes(
        field, den, pts, values_dev, grid, k, "sibson", 2.0, cells=cells,
        margin=margin, values_sorted=values_sorted, block=block))

    res = fused_repair(field, den, None, cells, values_sorted, grid, k,
                       "sibson", 2.0, block, float(margin), interpret=True)
    assert res is not None
    fast, den2, n_left = res
    fast = np.asarray(fast)
    if n_left:
        fast = np.asarray(gk.repair_empty_nodes(
            jnp.asarray(fast), den2, pts, values_dev, grid, k, "sibson", 2.0))
    assert np.isfinite(fast).all()
    np.testing.assert_allclose(fast, legacy, rtol=1e-5, atol=1e-6)
