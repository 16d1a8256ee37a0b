"""Block-centric grid kNN kernel: parity with the generic tiled path."""

import numpy as np
import pytest

from ptv_interpolation_tpu.grid import create_grid
from ptv_interpolation_tpu.interpolate import idw_interpolate, sibson_interpolate
from ptv_interpolation_tpu.interpolate.knn_weights import (
    idw_grid_interpolate, sibson_grid_interpolate,
)
from ptv_interpolation_tpu.ops.grid_knn import grid_knn_apply


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    pts = rng.uniform(0, 32, size=(6000, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0] * 0.3), np.cos(pts[:, 1] * 0.2),
                     np.ones(len(pts))], -1).astype(np.float32)
    grid = create_grid(((0, 33), (0, 33), (0, 33)), 32)
    return pts, vals, grid


def _assert_almost_all_close(got, want, rtol=1e-3, atol=1e-4, frac=0.9999):
    """Elementwise closeness for ≥ frac of entries — kNN ties at equal
    distances may legally resolve differently between formulations."""
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    assert close.mean() >= frac, (
        f"only {close.mean():.6f} close; worst "
        f"{np.abs(got - want).max():.4g}")


def test_idw_grid_matches_tile_path(problem):
    pts, vals, grid = problem
    got = np.asarray(idw_grid_interpolate(pts, vals, grid, k=20,
                                          exact_topk=True)).reshape(-1, 3)
    want = np.asarray(idw_interpolate(pts, vals, grid.flat_coords(), k=20))
    _assert_almost_all_close(got, want)


def test_sibson_grid_matches_tile_path(problem):
    pts, vals, grid = problem
    got = np.asarray(sibson_grid_interpolate(pts, vals, grid, k=20,
                                             exact_topk=True)).reshape(-1, 3)
    want = np.asarray(sibson_interpolate(pts, vals, grid.flat_coords(), k=20))
    _assert_almost_all_close(got, want)


def test_sibson_grid_exact_tau_matches_tile_path(problem):
    """exact_tau replaces the approx_min_k τ estimate with the true k-th
    distance: the τ-mask equals the exact k-set (bar ties) and the sibson
    std/min statistics match the reference's k-set statistics."""
    pts, vals, grid = problem
    got = np.asarray(sibson_grid_interpolate(
        pts, vals, grid, k=20, exact_tau=True)).reshape(-1, 3)
    want = np.asarray(sibson_interpolate(pts, vals, grid.flat_coords(), k=20))
    _assert_almost_all_close(got, want)


def test_grid_approx_mode_stays_close(problem):
    """tau_mode='approx' (the opt-in fast mode since bisect became the
    default) must stay within its documented accuracy envelope."""
    pts, vals, grid = problem
    got = np.asarray(sibson_grid_interpolate(
        pts, vals, grid, k=20, tau_mode="approx",
        recall_target=0.9)).reshape(-1, 3)
    want = np.asarray(sibson_interpolate(pts, vals, grid.flat_coords(), k=20))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, f"approx-mode relative L2 {rel:.3e}"


def test_grid_knn_nonuniform_spacing_and_odd_shape():
    rng = np.random.default_rng(22)
    pts = rng.uniform(0, 20, size=(3000, 3)).astype(np.float32)
    pts[:, 2] *= 0.5  # anisotropic cloud
    vals = pts[:, :1].repeat(3, axis=1).astype(np.float32)
    grid = create_grid(((0, 21), (0, 21), (0, 11)), (19, 13, 7))
    got = np.asarray(idw_grid_interpolate(pts, vals, grid, k=12,
                                          exact_topk=True))
    assert got.shape == (7, 13, 19, 3)
    want = np.asarray(idw_interpolate(pts, vals, grid.flat_coords(),
                                      k=12)).reshape(7, 13, 19, 3)
    _assert_almost_all_close(got, want)


def test_grid_knn_custom_consumer(problem):
    """A consumer that uses neighbor positions (mean neighbor offset)."""
    import jax.numpy as jnp
    pts, vals, grid = problem

    def consume(sq, n_pos, n_val, ok, q):
        okf = ok.astype(jnp.float32)[..., None]
        mean_pos = jnp.sum(n_pos * okf, axis=1) / jnp.sum(okf, axis=1)
        return mean_pos - q

    out = np.asarray(grid_knn_apply(pts, vals, grid, 8, consume, 3,
                                    exact_topk=True))
    # mean neighbor offset should be small in the cloud interior
    inner = out[8:-8, 8:-8, 8:-8]
    assert np.abs(inner).mean() < 1.0


def test_rbf_local_grid_matches_tile_path(problem):
    from ptv_interpolation_tpu.interpolate import rbf_local_interpolate
    from ptv_interpolation_tpu.interpolate.rbf_local import (
        rbf_local_grid_interpolate,
    )
    pts, vals, grid = problem
    got = np.asarray(rbf_local_grid_interpolate(
        pts, vals, grid, k=16, exact_topk=True)).reshape(-1, 3)
    want = np.asarray(rbf_local_interpolate(pts, vals, grid.flat_coords(),
                                            k=16))
    _assert_almost_all_close(got, want, rtol=2e-3, atol=2e-3, frac=0.999)


def test_dispatch_routes_grid_fastpath(problem):
    from ptv_interpolation_tpu.interpolate import interpolate_field
    pts, vals, grid = problem
    # force the fast path and compare against the generic path
    U1, V1, W1 = interpolate_field(pts, vals, grid, method="idw",
                                   idw_neighbors=16,
                                   use_grid_kernel="always")
    U2, V2, W2 = interpolate_field(pts, vals, grid, method="idw",
                                   idw_neighbors=16,
                                   use_grid_kernel="never")
    _assert_almost_all_close(np.asarray(U1).ravel(), np.asarray(U2).ravel(),
                             rtol=2e-3, atol=1e-4, frac=0.999)


def test_constant_field_is_exact():
    """Any normalized weighting of a constant field must return it exactly
    (regression: a default-precision matmul injected ~3.5e-4 error)."""
    rng = np.random.default_rng(30)
    pts = rng.uniform(0, 32, size=(5000, 3)).astype(np.float32)
    vals = np.full((5000, 3), 7.0, np.float32)
    grid = create_grid(((0, 33), (0, 33), (0, 33)), 16)
    out = np.asarray(sibson_grid_interpolate(pts, vals, grid, k=20))
    np.testing.assert_allclose(out, 7.0, rtol=1e-6)
    out = np.asarray(idw_grid_interpolate(pts, vals, grid, k=20))
    np.testing.assert_allclose(out, 7.0, rtol=1e-6)


def test_far_field_nodes_fall_back_to_exact_knn():
    """Grid nodes whose candidate region is empty must use the generic kNN
    path, not silently return zero (regression)."""
    rng = np.random.default_rng(31)
    pts = rng.uniform(0, 25, size=(20000, 3)).astype(np.float32)
    vals = np.full((20000, 3), 7.0, np.float32)
    grid = create_grid(((0, 101), (0, 101), (0, 101)), 32)
    out = np.asarray(idw_grid_interpolate(pts, vals, grid, k=20))
    np.testing.assert_allclose(out, 7.0, rtol=1e-5)


def test_coverage_sentinel_is_recall_independent():
    """Regression: the sentinel that routes nodes to the exact repair path
    must count candidates inside the kNN margin (exact regardless of
    approx_min_k recall), not compare the approx k-th distance to the
    margin — the approx τ overshoots at recall<1 and falsely flagged ~10%
    of the 256³/1M bench nodes, flooding the repair path."""
    import jax.numpy as jnp
    from ptv_interpolation_tpu.ops.grid_knn import (
        _grid_block_weighted_sum, _host_setup)
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        _sibson_panel_weights)
    rng = np.random.default_rng(33)
    pts = rng.uniform(0, 48, size=(60000, 3)).astype(np.float32)
    vals = np.ones((60000, 3), np.float32)
    grid = create_grid(((0, 49), (0, 49), (0, 49)), 48)
    setup = _host_setup(pts, vals, grid, 50, None, None, (4, 8, 16), 1.45)
    cells, values_sorted, axes, margin, mc, row_len, _ = setup
    _, den = _grid_block_weighted_sum(
        cells, values_sorted, axes, jnp.float32(margin), 50, (4, 8, 16),
        grid.shape, mc, row_len, _sibson_panel_weights(),
        0.9, 8, False)
    uncovered = float(np.mean(np.asarray(den) == 0.0))
    # on a uniform cloud only domain-edge/corner nodes may be uncovered
    assert uncovered < 0.02, f"{uncovered:.3f} of nodes flagged uncovered"


def test_sparse_neighborhoods_finite_and_exact():
    """k > available candidates in a cell-list neighborhood: weights must
    renormalize over the valid slots (regression: inf for IDW, bias for
    sibson)."""
    from ptv_interpolation_tpu.interpolate import idw_interpolate
    from ptv_interpolation_tpu.ops.neighbors import build_cell_list
    rng = np.random.default_rng(32)
    pts = rng.uniform(0, 1, size=(50, 3)).astype(np.float32)
    vals = np.full((50, 3), 5.0, np.float32)
    cells = build_cell_list(pts, cell_size=0.08)
    q = np.asarray([[0.5, 0.5, 0.5]], np.float32)
    out = np.asarray(idw_interpolate(pts, vals, q, k=30, cells=cells))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, 5.0, rtol=1e-5)
    out_s = np.asarray(sibson_interpolate(pts, vals, q, k=30, cells=cells))
    np.testing.assert_allclose(out_s, 5.0, rtol=1e-5)


def test_skip_mask_skips_repair_but_preserves_kept_nodes():
    """skip_mask excludes nodes from exact repair (they will be
    overwritten by the caller); nodes outside the mask must still match
    the exact oracle, including repaired far-field ones."""
    rng = np.random.default_rng(40)
    pts = rng.uniform(0, 20, size=(15000, 3)).astype(np.float32)
    vals = np.full((15000, 3), 3.0, np.float32)
    grid = create_grid(((0, 65), (0, 65), (0, 65)), 32)
    # nodes beyond x≈20 are far-field; mark the top half as discarded
    skip = np.zeros(grid.shape, bool)
    skip[:, :, 20:] = True
    out = np.asarray(idw_grid_interpolate(pts, vals, grid, k=15,
                                          skip_mask=skip))
    # kept nodes (incl. repaired far-field columns 10..19) are exact
    np.testing.assert_allclose(out[:, :, :20], 3.0, rtol=1e-5)
    assert np.isfinite(out).all()


def test_bisect_sparse_k_exceeds_coverage():
    """k close to the cloud size: most nodes are uncovered (count < k
    inside the margin) and must be repaired to match the generic oracle."""
    rng = np.random.default_rng(41)
    pts = rng.uniform(0, 16, size=(300, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0]), np.cos(pts[:, 1]),
                     np.ones(300)], -1).astype(np.float32)
    grid = create_grid(((0, 17),) * 3, 16)
    got = np.asarray(sibson_grid_interpolate(pts, vals, grid,
                                             k=100)).reshape(-1, 3)
    want = np.asarray(sibson_interpolate(pts, vals, grid.flat_coords(),
                                         k=100))
    _assert_almost_all_close(got, want)


def test_clustered_cloud_refines_instead_of_failing():
    """Round-1 weak item: >1024 points in one candidate row used to raise
    ValueError. Near-wall PTV clustering must auto-refine the cell list."""
    rng = np.random.default_rng(7)
    # 4000 points crammed into a thin near-wall sheet + a sparse bulk:
    # the auto cell size (set by mean density) massively overflows the
    # row capacity inside the sheet
    sheet = rng.uniform([0, 0, 0], [16, 16, 0.05], size=(4000, 3))
    bulk = rng.uniform([0, 0, 0], [16, 16, 16], size=(200, 3))
    points = np.concatenate([sheet, bulk]).astype(np.float32)
    values = np.stack([np.sin(points[:, 0]), np.cos(points[:, 1]),
                       np.ones(len(points))], axis=-1).astype(np.float32)
    grid = create_grid(((0, 17), (0, 17), (0, 17)), 8)
    out = np.asarray(sibson_grid_interpolate(points, values, grid, k=12))
    assert np.isfinite(out).all()
    want = np.asarray(sibson_interpolate(
        points, values, np.asarray(grid.flat_coords()), k=12))
    close = np.isclose(out.reshape(-1, 3), want, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.99


def test_coincident_points_route_through_generic_path():
    """>1024 coincident points: no cell refinement can help — the driver
    must fall back to the generic kNN path, not crash."""
    rng = np.random.default_rng(8)
    dup = np.tile(np.float32([[4.0, 4.0, 4.0]]), (1500, 1))
    bulk = rng.uniform(0, 8, size=(300, 3)).astype(np.float32)
    points = np.concatenate([dup, bulk])
    values = np.stack([points[:, 0], points[:, 1],
                       np.ones(len(points), np.float32)], axis=-1)
    grid = create_grid(((0, 9), (0, 9), (0, 9)), 8)
    out = np.asarray(sibson_grid_interpolate(points, values, grid, k=8))
    assert out.shape == grid.shape + (3,)
    assert np.isfinite(out).all()


def test_scatter_filter_survives_clustered_cloud():
    from ptv_interpolation_tpu.filtering import knn_mad_mask_scatter
    rng = np.random.default_rng(9)
    sheet = rng.uniform([0, 0, 0], [16, 16, 0.05], size=(4000, 3))
    bulk = rng.uniform([0, 0, 0], [16, 16, 16], size=(200, 3))
    points = np.concatenate([sheet, bulk]).astype(np.float32)
    values = np.stack([np.sin(points[:, 0]), np.cos(points[:, 1]),
                       np.ones(len(points))], axis=-1).astype(np.float32)
    keep, radius = knn_mad_mask_scatter(points, values, k=8)
    assert keep.shape == (len(points),)
    assert np.isfinite(radius)
