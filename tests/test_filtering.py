"""Outlier-filter parity vs the reference numpy/KDTree formulation."""

import numpy as np

from ptv_interpolation_tpu.filtering import (
    FilterConfig, apply_filters, knn_mad_mask, remove_outliers_knn,
    remove_outliers_threshold, speed_threshold_mask,
)
from ptv_interpolation_tpu.io.csvio import PointCloud


def _make_cloud(n=2000, n_outliers=25, seed=5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, size=(n, 3))
    vals = np.stack([
        0.1 * np.sin(pts[:, 0]), 0.1 * np.cos(pts[:, 1]),
        np.ones(n)], axis=-1)
    out_idx = rng.choice(n, n_outliers, replace=False)
    vals[out_idx] *= 8.0  # gross speed outliers
    return PointCloud(pts, vals), out_idx


def _reference_knn_mask(points, values, k, threshold):
    from scipy.spatial import KDTree
    u, v, w = values.T
    speed = np.sqrt(u ** 2 + v ** 2 + w ** 2)
    tree = KDTree(points)
    dist, idx = tree.query(points, k=k + 1)
    neighbor_speeds = speed[idx[:, 1:]]
    med = np.median(neighbor_speeds, axis=1)
    mad = np.median(np.abs(neighbor_speeds - med[:, None]), axis=1)
    z = np.abs(speed - med) / (mad + 1e-6)
    return z <= threshold


def test_threshold_filter():
    cloud, out_idx = _make_cloud()
    keep = np.asarray(speed_threshold_mask(cloud.values, 4.0))
    assert not keep[out_idx].any()
    assert keep.sum() == len(cloud) - len(out_idx)
    filtered = remove_outliers_threshold(cloud, 4.0, verbose=False)
    assert len(filtered) == keep.sum()


def test_knn_mad_parity_with_reference():
    cloud, out_idx = _make_cloud()
    keep_got, _ = knn_mad_mask(cloud.points, cloud.values, k=25, threshold=3.0)
    keep_got = np.asarray(keep_got)
    keep_ref = _reference_knn_mask(cloud.points.astype(np.float64),
                                   cloud.values.astype(np.float64), 25, 3.0)
    # agreement on >99.5% of decisions (f32 median ties at the margin)
    assert (keep_got == keep_ref).mean() > 0.995
    # and every planted outlier is removed
    assert not keep_got[out_idx].any()


def test_knn_filter_small_cloud_skips():
    cloud, _ = _make_cloud(n=10, n_outliers=0)
    out = remove_outliers_knn(cloud, k=25, verbose=False)
    assert len(out) == 10


def test_apply_filters_pipeline():
    cloud, out_idx = _make_cloud()
    cfg = FilterConfig(filter_outliers=True, filter_neighbors=25,
                       filter_threshold=3.0, filter_max_speed=10.0)
    filtered = apply_filters(cloud, cfg, verbose=False)
    assert len(filtered) < len(cloud)
    cfg_off = FilterConfig(filter_outliers=False)
    assert len(apply_filters(cloud, cfg_off, verbose=False)) == len(cloud)


def test_scatter_filter_matches_bruteforce():
    cloud, _ = _make_cloud(n=3000)
    a = remove_outliers_knn(cloud, k=20, use_celllist=False, verbose=False)
    b = remove_outliers_knn(cloud, k=20, use_celllist=True, verbose=False)
    assert abs(len(a) - len(b)) <= max(2, int(0.002 * len(cloud)))


def test_scatter_mad_recall_vs_exact_decisions():
    """The approx top-k recall target is a binary-decision knob here: a
    wrong neighbor set could silently delete good tracks. Characterize it:
    at recall_target=0.95 the keep/drop decisions must match exact_topk on
    >=99.9% of points, and every planted gross outlier must drop in both."""
    from ptv_interpolation_tpu.filtering import knn_mad_mask_scatter
    cloud, out_idx = _make_cloud(n=60_000, n_outliers=300, seed=11)
    keep_a, _ = knn_mad_mask_scatter(cloud.points, cloud.values, k=25,
                                     recall_target=0.95)
    keep_e, _ = knn_mad_mask_scatter(cloud.points, cloud.values, k=25,
                                     exact_topk=True)
    agree = (keep_a == keep_e).mean()
    assert agree >= 0.999, f"decision agreement {agree:.5f}"
    assert not keep_a[out_idx].any()
    assert not keep_e[out_idx].any()


def test_scatter_mad_mask_parity():
    from ptv_interpolation_tpu.filtering import knn_mad_mask_scatter
    cloud, out_idx = _make_cloud(n=4000)
    keep_s, rad_s = knn_mad_mask_scatter(cloud.points, cloud.values, k=25)
    keep_ref = _reference_knn_mask(cloud.points.astype(np.float64),
                                   cloud.values.astype(np.float64), 25, 3.0)
    assert (keep_s == keep_ref).mean() > 0.995
    assert not keep_s[out_idx].any()


def test_fused_mad_extreme_outlier_near_threshold():
    """One planted extreme-speed outlier (the exact thing the filter
    removes) must not silently flip its neighbors' near-threshold
    decisions: the kernel bounds each bisection by
    the per-panel selected max, and flags decisions within the bisection
    error bound as uncovered so the driver re-decides them exactly.
    Drive the full scatter path and require 100% decision parity vs the
    f64 reference on this cloud."""
    from ptv_interpolation_tpu.filtering import knn_mad_mask_scatter

    cloud, out_idx = _make_cloud(n=5000, n_outliers=0, seed=13)
    vals = cloud.values.copy()
    # near-threshold structure: a mild speed gradient so many z-scores sit
    # close to the 3.0 cut, plus ONE extreme outlier (1e6x typical speed)
    rng = np.random.default_rng(13)
    vals[:, 2] += 0.02 * rng.standard_normal(len(vals))
    extreme = int(rng.integers(len(vals)))
    vals[extreme] *= 1e6
    keep, _ = knn_mad_mask_scatter(cloud.points, vals, k=25, threshold=3.0)
    keep_ref = _reference_knn_mask(cloud.points.astype(np.float64),
                                   vals.astype(np.float64), 25, 3.0)
    assert not keep[extreme]
    # neighbors of the extreme point see smax_q ~ 1e6: their bisection
    # resolution collapses, so parity there MUST come from the exact
    # re-decide fallback, not luck. Demand full agreement.
    agree = (keep == keep_ref).mean()
    assert agree == 1.0, f"decision agreement {agree:.5f}"


def test_fused_mad_interpret_parity():
    """The fused panel MAD kernel (ops/fused_mad.py) finds every filter
    statistic by counting bisection; covered decisions must match the
    reference KDTree formulation, and the kth-distance diagnostic must
    match the true k-th neighbor distance to bisection precision."""
    from scipy.spatial import KDTree

    from ptv_interpolation_tpu.ops.fused_mad import fused_mad_filter

    cloud, out_idx = _make_cloud(n=5000, n_outliers=40, seed=7)
    speed = np.sqrt((cloud.values ** 2).sum(axis=1))
    res = fused_mad_filter(cloud.points, speed, k=25, threshold=3.0,
                           interpret=True, want_kth=True)
    assert res is not None
    keep, covered, radius, kth = res
    assert covered.mean() > 0.9  # bulk certified at margin_factor 1.9

    keep_ref = _reference_knn_mask(cloud.points.astype(np.float64),
                                   cloud.values.astype(np.float64), 25, 3.0)
    agree = (keep[covered] == keep_ref[covered]).mean()
    assert agree > 0.998, f"covered-decision agreement {agree:.5f}"
    # every planted gross outlier that is covered must drop
    cov_out = covered[out_idx]
    assert not keep[out_idx][cov_out].any()

    tree = KDTree(cloud.points)
    dist, _ = tree.query(cloud.points, k=26)
    err = np.abs(kth[covered] - dist[covered, -1])
    assert err.max() < 1e-3


def test_scatter_filter_kernel_route_matches_reference():
    """The filter's kernel route (what the GPU takes: fused MAD kernel,
    then the exact re-decide of uncertain points), run interpreted on
    the CPU, must reproduce the reference decisions."""
    from ptv_interpolation_tpu.filtering import knn_mad_mask_scatter
    cloud, out_idx = _make_cloud(n=4000, n_outliers=30, seed=17)
    keep, radius = knn_mad_mask_scatter(cloud.points, cloud.values, k=25,
                                        threshold=3.0, interpret=True)
    keep_ref = _reference_knn_mask(cloud.points.astype(np.float64),
                                   cloud.values.astype(np.float64), 25, 3.0)
    assert (np.asarray(keep) == keep_ref).mean() >= 0.999
    assert not np.asarray(keep)[out_idx].any()
    assert radius > 0
