"""Multi-chip sharding on the 8-device virtual CPU mesh: parity with
single-device results + the driver dry-run entry points."""

import jax
import numpy as np
import pytest

from ptv_interpolation_tpu.grid import create_grid
from ptv_interpolation_tpu.interpolate import idw_interpolate, sibson_interpolate
from ptv_interpolation_tpu.parallel import (
    make_mesh, make_pipeline_step, shard_fields, sharded_interpolate_values,
)
from ptv_interpolation_tpu.physics import (
    clean_divergence_projection, clean_divergence_variational,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    points = rng.uniform(0, 16, size=(800, 3)).astype(np.float32)
    values = np.stack([np.sin(points[:, 0]), np.cos(points[:, 1]),
                       np.ones(800)], axis=-1).astype(np.float32)
    queries = rng.uniform(1, 15, size=(700, 3)).astype(np.float32)
    return points, values, queries


def test_sharded_idw_matches_single_device(problem):
    points, values, queries = problem
    mesh = make_mesh(8)
    got = np.asarray(sharded_interpolate_values(
        points, values, queries, mesh, method="idw", k=12, query_tile=32))
    want = np.asarray(idw_interpolate(points, values, queries, k=12))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_sibson_matches_single_device(problem):
    points, values, queries = problem
    mesh = make_mesh(8)
    got = np.asarray(sharded_interpolate_values(
        points, values, queries, mesh, method="sibson", k=12, query_tile=32))
    want = np.asarray(sibson_interpolate(points, values, queries, k=12))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_zsharded_cleaning_matches_single_device():
    rng = np.random.default_rng(12)
    n = 16
    mask = np.ones((n, n, n), bool)
    mask[:, :4, :4] = False
    u, v, w = (rng.normal(size=(n, n, n)).astype(np.float32) * mask
               for _ in range(3))
    mesh = make_mesh(8)

    want = clean_divergence_projection(u, v, w, mask, 1., 1., 1., iterations=2)
    um, vm, wm, mm = shard_fields(mesh, u, v, w, mask)
    got = clean_divergence_projection(um, vm, wm, mm, 1., 1., 1., iterations=2)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               rtol=1e-3, atol=1e-5)

    want_v = clean_divergence_variational(u, v, w, mask, 1., 1., 1.,
                                          lambda_reg=50.0)
    got_v = clean_divergence_variational(um, vm, wm, mm, 1., 1., 1.,
                                         lambda_reg=50.0)
    np.testing.assert_allclose(np.asarray(got_v.u), np.asarray(want_v.u),
                               rtol=1e-3, atol=1e-5)


def test_pipeline_step_mesh_runs():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_entry_compiles_single_chip():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = fn(*args)
    assert np.asarray(out[0]).shape == (16, 16, 16)
    assert np.isfinite(float(out[3]))


def test_sharded_grid_kernel_matches_single_device(problem):
    from ptv_interpolation_tpu.grid import create_grid
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        sibson_grid_interpolate,
    )
    from ptv_interpolation_tpu.parallel.sharding import sharded_grid_interpolate
    points, values, _ = problem
    grid = create_grid(((0, 17), (0, 17), (0, 17)), 16)
    mesh = make_mesh(8)
    got = np.asarray(sharded_grid_interpolate(
        points, values, grid, mesh, method="sibson", k=12, block=(2, 8, 8)))
    want = np.asarray(sibson_grid_interpolate(
        points, values, grid, k=12, block=(2, 8, 8)))
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.999


def test_sharded_grid_kernel_void_region_matches_single_device():
    """Far-field fallback multi-chip: a cloud confined to the lower half of
    the domain leaves the upper grid slabs with empty candidate regions —
    those nodes must be repaired identically to the single-chip driver
    (round-1 advisor finding: the sharded path dropped the weight sums)."""
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        sibson_grid_interpolate,
    )
    from ptv_interpolation_tpu.parallel.sharding import sharded_grid_interpolate

    rng = np.random.default_rng(21)
    # points only in z < 5 of a 16-voxel domain: big void above
    points = rng.uniform([0, 0, 0], [16, 16, 5], size=(600, 3)).astype(np.float32)
    values = np.stack([np.sin(points[:, 0]), np.cos(points[:, 1]),
                       np.ones(600)], axis=-1).astype(np.float32)
    grid = create_grid(((0, 17), (0, 17), (0, 17)), 16)
    mesh = make_mesh(8)
    got = np.asarray(sharded_grid_interpolate(
        points, values, grid, mesh, method="sibson", k=12, block=(2, 8, 8)))
    want = np.asarray(sibson_grid_interpolate(
        points, values, grid, k=12, block=(2, 8, 8)))
    assert np.isfinite(got).all()
    # the void nodes must not be zero (constant-1 w channel everywhere)
    assert got[..., 2].min() > 0.5
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.999


def test_initialize_distributed_noop_single_process(monkeypatch):
    """Multi-host bootstrap (`parallel.initialize_distributed`): with no
    coordinator arguments and no cluster environment it must be a no-op
    (single-process short-circuit) and must never call
    jax.distributed.initialize; with explicit arguments it forwards them."""
    import jax

    from ptv_interpolation_tpu.parallel import mesh as mesh_mod

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(mesh_mod, "_DISTRIBUTED_INITIALIZED", False)
    assert mesh_mod.initialize_distributed() is False
    assert calls == []
    # explicit arguments forward to jax.distributed.initialize
    assert mesh_mod.initialize_distributed(
        coordinator_address="10.0.0.1:1234", num_processes=2,
        process_id=0) is True
    assert calls == [{"coordinator_address": "10.0.0.1:1234",
                      "num_processes": 2, "process_id": 0}]
    # second call is a no-op once initialized
    assert mesh_mod.initialize_distributed(
        coordinator_address="10.0.0.1:1234") is False
    assert len(calls) == 1


def test_sharded_fused_kernel_matches_single_device(problem):
    """The fused (Triton) slab path inside shard_map — interpret mode on
    the CPU mesh — must match the single-chip streaming kernel. This is
    the multi-device form of the headline kernel; on GPU meshes
    backend='auto' selects it."""
    from ptv_interpolation_tpu.grid import create_grid
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        sibson_grid_interpolate,
    )
    from ptv_interpolation_tpu.parallel.sharding import sharded_grid_interpolate
    points, values, _ = problem
    grid = create_grid(((0, 17), (0, 17), (0, 17)), 16)
    mesh = make_mesh(8)
    got = np.asarray(sharded_grid_interpolate(
        points, values, grid, mesh, method="sibson", k=12, block=(2, 8, 8),
        backend="triton", interpret=True))
    want = np.asarray(sibson_grid_interpolate(
        points, values, grid, k=12, block=(2, 8, 8)))
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.999


def test_slab_store_shards_memory():
    """The candidate store is genuinely sharded by z-slab ownership: each
    device's window holds ≈ total/n_dev + halo rows, not the full cloud
    (the store used to be replicated)."""
    from ptv_interpolation_tpu.ops.grid_knn import _host_setup
    from ptv_interpolation_tpu.parallel.slab_store import build_slab_store

    rng = np.random.default_rng(7)
    n = 20_000
    # tall domain so slabs are thin relative to the halo
    points = rng.uniform([0, 0, 0], [16, 16, 128], size=(n, 3)).astype(
        np.float32)
    values = np.stack([np.sin(points[:, 0]), np.cos(points[:, 1]),
                       np.ones(n)], axis=-1).astype(np.float32)
    grid = create_grid(((0, 17), (0, 17), (0, 129)), (16, 16, 128))
    block = (8, 8, 8)
    (cells, values_sorted, axes, margin, mc, row_len, _vd) = _host_setup(
        points, values, grid, 12, None, None, block, 1.45)
    n_dev, slab = 8, 16
    z_slabs = np.asarray(grid.z, np.float32).reshape(n_dev, slab)
    store = build_slab_store(cells, values_sorted, z_slabs, block[0],
                             grid.spacing[2], margin)
    # every window ≤ owned fraction + halo (physical bound), ≪ full cloud
    halo_frac = 2 * store.halo / 128.0
    bound = n * (1 / n_dev + halo_frac) * 1.35   # ±35% density fluctuation
    assert store.n_loc_np.max() < bound, (store.n_loc_np, bound)
    assert store.n_loc_np.max() < 0.6 * n
    # windows jointly cover every point (sum ≥ n; overlap from halos)
    assert store.n_loc_np.sum() >= n
    # per-device candidate bytes ≈ total/n_dev + halo
    repl_bytes = (cells.points_sorted.shape[0] * 3 +
                  values_sorted.shape[0] * values_sorted.shape[1]) * 4
    assert store.per_device_bytes() < 0.5 * repl_bytes


def test_sharded_fused_void_region_matches_single_device():
    """Fused slab path on a void-dominated cloud: slabs whose repair is
    ineligible (uncovered nodes across most blocks) must fall back to the
    global exact ladder and still match single-chip."""
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        sibson_grid_interpolate,
    )
    from ptv_interpolation_tpu.parallel.sharding import sharded_grid_interpolate

    rng = np.random.default_rng(23)
    points = rng.uniform([0, 0, 0], [16, 16, 5], size=(600, 3)).astype(np.float32)
    values = np.stack([np.sin(points[:, 0]), np.cos(points[:, 1]),
                       np.ones(600)], axis=-1).astype(np.float32)
    grid = create_grid(((0, 17), (0, 17), (0, 17)), 16)
    mesh = make_mesh(8)
    got = np.asarray(sharded_grid_interpolate(
        points, values, grid, mesh, method="sibson", k=12, block=(2, 8, 8),
        backend="triton", interpret=True))
    want = np.asarray(sibson_grid_interpolate(
        points, values, grid, k=12, block=(2, 8, 8)))
    assert np.isfinite(got).all()
    assert got[..., 2].min() > 0.5
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.999


def test_checkpoint_sharded_restore(tmp_path):
    """`io/checkpoint.load_checkpoint(shardings=...)` must place restored
    3D fields directly onto the mesh sharding without a host gather
    (not only the plain roundtrip)."""
    pytest.importorskip("orbax.checkpoint")
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ptv_interpolation_tpu.io.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from ptv_interpolation_tpu.io.npz import FieldResult

    rng = np.random.default_rng(3)
    shape = (8, 4, 4)
    res = FieldResult(
        x=np.arange(4.0), y=np.arange(4.0), z=np.arange(8.0),
        u=rng.normal(size=shape).astype(np.float32),
        v=rng.normal(size=shape).astype(np.float32),
        w=rng.normal(size=shape).astype(np.float32),
        mask=rng.random(shape) > 0.3,
    )
    p = str(tmp_path / "ckpt_sharded")
    save_checkpoint(p, res)

    mesh = make_mesh(8)
    sharding = NamedSharding(mesh, P("data", None, None))
    back = load_checkpoint(p, shardings={"field": sharding})
    # restored arrays are device arrays already laid out on the mesh
    for name in ("u", "v", "w"):
        arr = getattr(back, name)
        assert isinstance(arr, jax.Array)
        assert arr.sharding.is_equivalent_to(sharding, ndim=3)
        np.testing.assert_allclose(np.asarray(arr), getattr(res, name))
    np.testing.assert_array_equal(np.asarray(back.mask), res.mask)
    # 1D coordinate vectors come back unsharded and exact
    np.testing.assert_allclose(back.x, res.x)
