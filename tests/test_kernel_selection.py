"""What surrounds the Triton kernels, on the CPU: the platform selection
point, the kernel wrappers' tiling, padding and capacity logic, their
lowering for CUDA, the precision of every device contraction, the compile
cache path, and the device stamp of the measurement scripts."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ptv_interpolation_tpu.grid import create_grid
from ptv_interpolation_tpu.ops import fused_grid_knn as fg
from ptv_interpolation_tpu.ops import fused_mad as fm
from ptv_interpolation_tpu.ops import kernels


@pytest.mark.parametrize("platform,interpret,want", [
    ("gpu", False, "triton"),
    ("cpu", False, "xla"),
    ("cpu", True, "triton"),
    ("rocm", True, "triton"),
])
def test_select_kernels_by_platform(monkeypatch, platform, interpret, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert kernels.select_kernels(interpret) == want


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_select_kernels_unknown_platform_is_an_error(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="no kernels for platform"):
        kernels.select_kernels()


def test_cpu_default_route_is_xla():
    assert jax.default_backend() == "cpu"
    assert kernels.select_kernels() == "xla"


@pytest.mark.parametrize("B,tq", [(1024, fg._TQ), (512, fg._TQ), (32, 32),
                                  (1, 1)])
def test_query_tile(B, tq):
    assert fg._query_tile(B) == tq


@pytest.mark.parametrize("B", [3, 96, 640])
def test_query_tile_rejects_non_power_of_two(B):
    with pytest.raises(ValueError, match="power of two"):
        fg._query_tile(B)


@pytest.mark.parametrize("c_raw,want", [
    (0, fg._CC), (1, fg._CC), (fg._CC, fg._CC), (fg._CC + 1, 2 * fg._CC),
    (1000, -(-1000 // fg._CC) * fg._CC)])
def test_panel_width_pads_to_whole_chunks(c_raw, want):
    assert fg._panel_width(c_raw) == want


@pytest.mark.parametrize("block", [(2, 4, 8), (4, 8, 16), (8, 8, 16)])
def test_query_tiles_reassemble_to_grid_order(block):
    """Tiles of ``tq`` queries, cut from each block's local (z, y, x)
    order, must land back on their own nodes: feeding the query
    coordinates through the output layout reproduces the grid."""
    from ptv_interpolation_tpu.ops.grid_knn import _pad_axis
    grid = create_grid(((0, 21), (0, 18), (0, 13)), (20, 17, 12))
    bz, by, bx = block
    axes = (_pad_axis(grid.x, bx), _pad_axis(grid.y, by),
            _pad_axis(grid.z, bz))
    dims = tuple(-(-s // b) for s, b in zip(grid.shape, block))
    tq = fg._query_tile(bz * by * bx)
    qx, qy, qz = fg._build_queries(axes, block, dims, tq)
    n_blocks = dims[0] * dims[1] * dims[2]
    n_sub = bz * by * bx // tq
    rows = jnp.stack([qx, qy, qz] + [jnp.zeros_like(qx)] * 5, axis=1)
    out = rows.reshape(n_blocks, n_sub, 8, tq)
    got = np.asarray(fg._reassemble(out, block, dims, grid.shape))
    Z, Y, X = np.meshgrid(*(np.asarray(a, np.float32)
                            for a in (grid.z, grid.y, grid.x)), indexing="ij")
    np.testing.assert_array_equal(got[..., 0], X)
    np.testing.assert_array_equal(got[..., 1], Y)
    np.testing.assert_array_equal(got[..., 2], Z)


def _cloud(n=3000, seed=3):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 12, size=(n, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0]), np.cos(pts[:, 1]),
                     np.ones(n)], axis=-1).astype(np.float32)
    return pts, vals


def test_mad_capacity_bounds_refuse():
    """The MAD wrapper refuses (returns None, so the caller takes the
    selection path) when the panel width or a block's population exceeds
    its bound — never a kernel error."""
    pts, vals = _cloud()
    speed = np.sqrt((vals ** 2).sum(1))
    assert fm.fused_mad_filter(pts, speed, 10, 3.0, max_panel=fg._CC,
                               interpret=True) is None
    assert fm.fused_mad_filter(pts, speed, 10, 3.0, max_bt=1,
                               interpret=True) is None


def test_fused_capacity_error_only_for_capacity():
    pts, vals = _cloud()
    grid = create_grid(((0, 13), (0, 13), (0, 13)), 12)
    with pytest.raises(fg.FusedCapacityError):
        fg.fused_grid_weighted_interpolate(pts, vals, grid, 8,
                                           max_panel=fg._CC - 1,
                                           interpret=True)


@pytest.mark.parametrize("mode,power", [("sibson", 2.0), ("idw", 2.0),
                                        ("idw", 1.5)])
def test_knn_kernel_lowers_to_triton_for_cuda(mode, power):
    """The kNN kernel's Triton lowering for CUDA runs on the CPU through
    ``jax.export``: an operation the Triton route cannot lower fails
    here, before any card is involved."""
    from jax import export
    c = 2 * fg._CC

    def f(m2, cand, q):
        return fg._fused_eval(m2, cand, q, q, q, (4, 4, 8), 12, 3, c, mode,
                              power)
    exp = export.export(
        jax.jit(f), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(
        jnp.ones((1,)), jnp.ones((8, 2 * c)), jnp.ones((4, fg._TQ)))
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert 'name = "fused_grid_knn"' in text


def test_mad_kernel_lowers_to_triton_for_cuda():
    from jax import export
    c = 2 * fg._CC

    def f(m2, cand, q):
        return fm._mad_eval(m2, cand, q, q, q, q, 30, 4.0, c)
    exp = export.export(
        jax.jit(f), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(
        jnp.ones((1,)), jnp.ones((8, 2 * c)), jnp.ones((2, fg._TQ)))
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    assert 'name = "fused_mad"' in text


@pytest.mark.parametrize("method", ["linear", "rbf", "sibson"])
def test_contractions_run_at_highest_precision(monkeypatch, method):
    """Every dot_general traced by ``interpolate_field`` asks for
    Precision.HIGHEST: a default-precision f32 contraction may run in
    TF32 (about three decimal digits) on a GPU's tensor cores."""
    from jax._src.lax.lax import dot_general_p

    from ptv_interpolation_tpu.interpolate import interpolate_field

    seen = []
    bind = dot_general_p.bind

    def spy(*args, **params):
        seen.append(params.get("precision"))
        return bind(*args, **params)

    jax.clear_caches()
    monkeypatch.setattr(dot_general_p, "bind", spy)
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 10, size=(400, 3)).astype(np.float32)
    vals = np.stack([np.sin(pts[:, 0]), pts[:, 1] * 0.1,
                     np.ones(400)], axis=-1).astype(np.float32)
    grid = create_grid(((0, 10), (0, 10), (0, 10)), 8)
    U, V, W = interpolate_field(pts, vals, grid, method=method,
                                sibson_neighbors=12, rbf_neighbors=12,
                                verbose=False)
    assert np.isfinite(np.asarray(U)).all()
    hi = jax.lax.Precision.HIGHEST
    bad = [p for p in seen
           if p is None or any(x != hi for x in p)]
    assert not bad, f"{len(bad)}/{len(seen)} contractions below HIGHEST"


def test_compilation_cache_dir_follows_env(monkeypatch, tmp_path):
    from ptv_interpolation_tpu import utils
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert utils.compilation_cache_dir() == str(tmp_path)


def test_compilation_cache_dir_defaults_to_checkout(monkeypatch):
    import os

    from ptv_interpolation_tpu import utils
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        utils.__file__)))
    assert utils.compilation_cache_dir() == os.path.join(checkout,
                                                         ".jax_cache")


def test_enable_compilation_cache_sets_jax_config(monkeypatch, tmp_path):
    from ptv_interpolation_tpu import utils
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert utils.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_device_stamp_refuses_other_platforms():
    from ptv_interpolation_tpu.utils import device_stamp
    with pytest.raises(RuntimeError, match="needs a gpu device"):
        device_stamp("gpu")
    stamp = device_stamp(None)
    assert stamp["platform"] == "cpu" and stamp["count"] == len(jax.devices())


def test_csv_numpy_fallback(monkeypatch, tmp_path):
    """Without the native parser the loader is plain numpy: aliases,
    quoted headers and extra columns are honoured, and a malformed file
    still raises the IOError contract."""
    from ptv_interpolation_tpu.io import csvio
    monkeypatch.setattr(csvio, "_load_native", lambda path: None)
    p = tmp_path / "pts.csv"
    p.write_text('"id","x","y","z","vx","vy","vz"\n'
                 '7,1,2,3,0.1,0.2,0.3\n8,4,5,6,0.4,0.5,0.6\n')
    cloud = csvio.load_ptv_data(str(p))
    np.testing.assert_allclose(cloud.points, [[1, 2, 3], [4, 5, 6]])
    np.testing.assert_allclose(cloud.values, [[.1, .2, .3], [.4, .5, .6]],
                               rtol=1e-6)
    p.write_text("x,y,z,u,v,w\n1,2,3,oops,5,6\n")
    with pytest.raises(IOError):
        csvio.load_ptv_data(str(p))
    p.write_text("x,y,u,v,w\n1,2,3,4,5\n")
    with pytest.raises(IOError):
        csvio.load_ptv_data(str(p))
