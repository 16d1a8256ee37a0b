"""SPMD execution of the hot paths over a device mesh.

Three sharding patterns cover the whole framework:

* **Query sharding** (generic kNN interpolation, filtering): grid points /
  particles are embarrassingly parallel over queries — ``shard_map`` runs
  the tiled neighbor+weights loop on each device's query shard with the
  particle set replicated (small-problem path). This is the device
  equivalent of the reference's process pool (`interpolator.py:173-182`),
  except the "pickle+fork" is one broadcast to every device.

* **Z-slab sharding of grid + candidate store** (the at-scale grid
  kernels, :func:`sharded_grid_interpolate`): the grid is cut into one
  z-slab per device AND the cell-sorted particle store is cut into
  slab+halo windows (`parallel/slab_store.py`) — per-device memory for the
  O(N) candidate arrays is ≈ total/n_dev + halo, so the particle store can
  outgrow one chip's HBM. Uncovered-node repair also runs per-slab inside
  ``shard_map`` from the same local windows (the halo is sized for the
  repair stage's widened margin).

* **Z-slab sharding of fields** (physics): fields are sharded along z; the
  stencil operators (``jnp.roll`` + masked where) compile under ``jit``
  with GSPMD inserting one-voxel halo exchanges, and the CG dot products
  become ``psum`` collectives. No code changes to the solvers — the same
  jitted functions run on one device or a mesh depending on input
  shardings.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ptv_interpolation_tpu.grid import Grid
from ptv_interpolation_tpu.interpolate.knn_weights import (
    _idw_weights,
    _sibson_weights,
    _weighted_tile,
)
from ptv_interpolation_tpu.ops.neighbors import (
    CellList,
    bruteforce_tile_fn,
    celllist_tile_fn,
    map_query_tiles,
)
from ptv_interpolation_tpu.parallel.mesh import DATA_AXIS


def _pad_to(n: int, multiple: int) -> int:
    return (n + multiple - 1) // multiple * multiple


def _bcount(n: int, b: int) -> int:
    return (n + b - 1) // b


def _slab_repair(out8, surveys, store, cells, grid: Grid, z_slabs, x_ax,
                 y_ax, margin: float, block, dims_slab, slab_shape,
                 nz_pad: int, z_pad, k: int, V: int, tq: int, method: str,
                 power: float, mesh: Mesh, axis_name: str, group: int,
                 interpret: bool, skip_slabs, store_specs, store_args,
                 _rebase, max_panel: int = 8192):
    """Per-slab uncovered-node repair inside ``shard_map`` — the sharded
    form of ``fused_grid_knn.fused_repair``. Each device re-evaluates just
    its own uncovered blocks at the 1.6× widened margin from its LOCAL
    slab+halo candidate store (the halo was sized for exactly this margin,
    so no cross-device candidates are needed), certifies via the coverage
    sentinel, and scatters into its slab. Host control flow mirrors the
    single-chip driver: one survey pull (already produced by the main
    dispatch), one repair dispatch, one repaired-count pull.

    Returns ``(out8', n_left)`` — slabs with repaired nodes marked served
    in the den channel; ``n_left`` nodes (far-field voids + slabs whose
    repair was ineligible) remain for the global exact ladder."""
    import math

    from ptv_interpolation_tpu.ops import fused_grid_knn as fg
    from ptv_interpolation_tpu.ops.neighbors import cell_meta_np
    from ptv_interpolation_tpu.parallel.slab_store import (
        REPAIR_MARGIN_FACTOR)

    surveys_np = np.asarray(surveys)                 # (n_dev, 2 + nblk_cap)
    n_dev = surveys_np.shape[0]
    nblk_cap = surveys_np.shape[1] - 2
    n_fix_d = surveys_np[:, 0].astype(np.int64)
    n_bad_d = surveys_np[:, 1].astype(np.int64)
    n_fix_total = int(n_fix_d.sum())
    if n_fix_total == 0:
        return out8, 0
    bz, by, bx = block
    B = bz * by * bx
    # per-device eligibility (mirrors fused_repair): the survey ids must
    # have fit, and void-dominated slabs (uncovered nodes scattered over
    # most blocks) go straight to the global brute-force ladder
    eligible = ((n_bad_d > 0) & (n_bad_d <= nblk_cap)
                & (n_bad_d * B <= np.maximum(32 * n_fix_d, 64 * B)))
    if not eligible.any():
        return out8, n_fix_total

    cell_size = 1.0 / cell_meta_np(cells)[1]
    margin2 = REPAIR_MARGIN_FACTOR * float(margin)
    dx, dy, dz = grid.spacing
    mc2 = tuple(int(math.ceil((ext + 2.0 * margin2) / cell_size)) + 1
                for ext in (bx * dx, by * dy, bz * dz))[::-1]
    # widened-margin panel width over the FULL padded grid → one static C2
    # shared by every slab (a per-slab C2 would retrace per device count)
    axes2_np = (np.asarray(x_ax), np.asarray(y_ax), z_pad)
    C2 = fg._panel_width(fg._block_total_capacity(
        cells, axes2_np, margin2, tuple(block), (nz_pad, grid.ny, grid.nx),
        mc2))
    if C2 > max_panel:
        return out8, n_fix_total

    nb_eff = np.where(eligible, n_bad_d, 0)
    NBLK = 1 << int(max(int(nb_eff.max()) - 1, 31)).bit_length()
    ids_np = np.zeros((n_dev, NBLK), np.int32)
    for d in range(n_dev):
        nb = int(nb_eff[d])
        if nb:
            ids_np[d, :nb] = surveys_np[d, 2:2 + nb]
            ids_np[d, nb:] = ids_np[d, nb - 1]
    ids_dev = jnp.asarray(ids_np)
    nbad_dev = jnp.asarray(nb_eff[:, None].astype(np.int32))

    def local(starts_g, origin, inv_c, ps_l, vs_l, row0, n_loc, out8_l,
              ids, nbad, x_l, y_l, z_slab, skip_l):
        cells_l = _rebase(starts_g, origin, inv_c, ps_l, row0, n_loc)
        field = out8_l[0][..., :V]
        den = out8_l[0][..., V]
        axes2_l = (x_l, y_l, z_slab[0])
        f2, d2, nrep = fg._fused_repair_apply(
            field, den, skip_l[0], cells_l, vs_l[0], axes2_l,
            jnp.float32(margin2), ids[0], nbad[0, 0], tuple(block),
            dims_slab, tq, int(k), V, C2, method, float(power), slab_shape,
            mc2, group, interpret=interpret)
        out_new = jnp.concatenate(
            [f2, d2[..., None], out8_l[0][..., V + 1:]], axis=-1)
        return out_new[None], nrep[None]

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=store_specs + (P(axis_name), P(axis_name), P(axis_name),
                                P(), P(), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(axis_name)), check_vma=False)
    out8_new, n_rep = jax.jit(fn)(*store_args, out8, ids_dev, nbad_dev,
                                  x_ax, y_ax, z_slabs, skip_slabs)
    n_left = n_fix_total - int(np.asarray(n_rep).sum())
    return out8_new, n_left


def sharded_interpolate_values(points, values, queries, mesh: Mesh,
                               method: str = "idw", k: int = 50,
                               power: float = 2.0,
                               cells: Optional[CellList] = None,
                               rings: int = 1, query_tile: int = 1024,
                               point_chunk: int = 4096,
                               axis_name: str = DATA_AXIS):
    """Interpolate with queries sharded over ``mesh`` (kNN methods).

    Points/values (and the cell list, if given) are replicated; each device
    runs the fused neighbor+weights tile loop over its query shard; results
    concatenate along the query axis with no cross-device traffic beyond
    the initial broadcast.
    """
    points = jnp.asarray(points, jnp.float32)
    values = jnp.asarray(values, jnp.float32)
    queries = jnp.asarray(queries, jnp.float32)
    n_dev = mesh.devices.size
    n_q = queries.shape[0]
    padded = _pad_to(n_q, n_dev * query_tile)
    queries_p = jnp.pad(queries, ((0, padded - n_q), (0, 0)))

    def local(pts, vals, cell_arg, q_shard):
        if cell_arg is not None:
            neighbor = celllist_tile_fn(cell_arg, k, rings)
        else:
            neighbor = bruteforce_tile_fn(pts, k, point_chunk)
        if method == "idw":
            weight_fn = lambda d, ok: _idw_weights(d, power, ok)  # noqa: E731
        elif method == "sibson":
            weight_fn = _sibson_weights
        else:
            raise ValueError(f"sharded interpolation supports kNN methods, "
                             f"got {method!r}")
        tile = _weighted_tile(neighbor, vals, weight_fn)
        return map_query_tiles(tile, q_shard, query_tile)

    cell_specs = (jax.tree_util.tree_map(lambda _: P(), cells)
                  if cells is not None else None)
    # check_vma=False: the tile loop's top-k scan carry is initialized from
    # replicated constants, which the varying-axes checker rejects; there
    # are no collectives inside the local function, so the check is moot.
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), cell_specs, P(axis_name)),
        out_specs=P(axis_name), check_vma=False)
    out = jax.jit(fn)(points, values, cells, queries_p)
    return out[:n_q]


def sharded_interpolate_field(points, values, grid: Grid, mesh: Mesh,
                              **kwargs):
    """Grid-output variant (→ (U, V, W) like ``interpolate_field``)."""
    queries = grid.flat_coords()
    out = sharded_interpolate_values(points, values, queries, mesh, **kwargs)
    out = out.reshape(grid.shape + (out.shape[-1],))
    return out[..., 0], out[..., 1], out[..., 2]


def sharded_grid_interpolate(points, values, grid: Grid, mesh: Mesh,
                             method: str = "sibson", k: int = 50,
                             power: float = 2.0,
                             block=(8, 8, 16), recall_target: float = 0.9,
                             group: int = 8, margin_factor: float = 1.45,
                             tau_mode: str = "bisect", skip_mask=None,
                             backend: str = "auto", interpret: bool = False,
                             axis_name: str = DATA_AXIS):
    """The block-centric τ-threshold kernel sharded over the mesh, with
    the candidate store sharded by z-slab ownership (NOT replicated).

    The grid's z-axis is cut into one slab per device (padded to equal
    slabs). Each device holds only the slab+halo window of the cell-sorted
    particle store (`parallel/slab_store.py`): the global ``starts``
    offsets are rebased into the window on-device (one clip — index
    arithmetic stays bit-identical to single-chip) and the O(N) sorted
    point/value stores are contiguous slices ≈ ``total/n_dev + halo``
    bytes per device. The halo covers the repair stage's 1.6× widened
    margin, so uncovered-node repair also runs per-slab inside
    ``shard_map`` (a second sharded dispatch); only genuine far-field
    voids fall back to the global exact ladder after the slabs recombine.
    This is the multi-chip form of the headline 1M→256³ kernel — the
    memory-scaling axis SURVEY.md §2.2 prescribes. Returns (nz, ny, nx, V).

    ``backend``: 'auto' (the route of ``ops.kernels.select_kernels``:
    the fused two-phase Triton kernel per slab on the GPU with
    ``tau_mode='bisect'``, the streaming XLA kernel on the CPU), 'triton',
    or 'xla'. The panel width C is planned once on the host over the full
    padded grid, so every slab compiles the same static shapes.
    ``interpret=True`` runs the Triton kernels in the Pallas interpreter
    (the CPU-mesh parity tests).
    """
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        _idw_panel_weights, _sibson_panel_weights)
    from ptv_interpolation_tpu.ops.grid_knn import (
        _grid_block_weighted_sum, _host_setup, repair_empty_nodes)
    from ptv_interpolation_tpu.parallel.slab_store import (
        build_slab_store, rebase_cells)

    if method == "idw":
        weight_fn = _idw_panel_weights(float(power))
    elif method == "sibson":
        weight_fn = _sibson_panel_weights()
    else:
        raise ValueError(f"sharded grid kernel supports idw/sibson, got {method!r}")

    from ptv_interpolation_tpu.ops.kernels import select_kernels

    if backend not in ("auto", "triton", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    use_fused = backend == "triton" or (
        backend == "auto" and tau_mode == "bisect"
        and select_kernels(interpret) == "triton")

    n_dev = mesh.devices.size
    bz = block[0]
    # z-slab size: equal slabs, each a multiple of the block z-extent
    slab = -(-grid.nz // n_dev)
    slab = -(-slab // bz) * bz
    nz_pad = slab * n_dev

    (cells, values_sorted, axes, margin, mc, row_len, values_dev) = _host_setup(
        points, values, grid, k, None, None, block, margin_factor,
        cell_divisor=3.0 if use_fused else 2.0)
    x_ax, y_ax, _ = axes
    # padded z axis, one slab per device (each slab keeps real spacing)
    z_full = np.asarray(grid.z, np.float32)
    step = float(z_full[1] - z_full[0]) if len(z_full) > 1 else 1.0
    z_pad = np.concatenate([
        z_full, z_full[-1] + step * np.arange(1, nz_pad - grid.nz + 1,
                                              dtype=np.float32)])
    z_slabs_np = z_pad.reshape(n_dev, slab)
    z_slabs = jnp.asarray(z_slabs_np)

    slab_shape = (slab, grid.ny, grid.nx)
    dims_slab = (slab // bz, _bcount(grid.ny, block[1]),
                 _bcount(grid.nx, block[2]))

    # the sharded candidate store: slab+halo windows of the sorted arrays
    store = build_slab_store(cells, values_sorted, z_slabs_np, bz,
                             grid.spacing[2], margin)
    dims_c, cap_c, capW = cells.dims, cells.cap, store.capW

    def _rebase(starts_g, origin, inv_c, ps_l, row0, n_loc):
        return rebase_cells(starts_g, origin, inv_c, ps_l[0], row0[0, 0],
                            n_loc[0, 0], dims_c, cap_c, capW)

    store_specs = (P(), P(), P(), P(axis_name), P(axis_name), P(axis_name),
                   P(axis_name))
    store_args = (cells.starts, cells.origin, cells.inv_cell, store.points_l,
                  store.values_l, store.row0, store.n_loc)

    if use_fused:
        from ptv_interpolation_tpu.ops import fused_grid_knn as fg

        # panel width planned over the FULL padded grid → every slab
        # shares one static C (the max over all slabs' blocks)
        axes_np = (np.asarray(x_ax), np.asarray(y_ax), z_pad)
        C = fg._panel_width(fg._block_total_capacity(
            cells, axes_np, margin, tuple(block),
            (nz_pad, grid.ny, grid.nx), mc))
        V = values_sorted.shape[1]
        tq = fg._query_tile(block[0] * block[1] * block[2])
        n_blocks_slab = dims_slab[0] * dims_slab[1] * dims_slab[2]
        nblk_cap = min(fg._NBLK_MAX, n_blocks_slab)
        m2 = jnp.asarray([margin * margin], jnp.float32)

        # survey skip: the caller's skip mask plus the padded z rows (they
        # are sliced away after recombination — repairing them would flood
        # the last device's survey)
        skipfull = np.zeros((nz_pad, grid.ny, grid.nx), bool)
        skipfull[grid.nz:] = True
        if skip_mask is not None:
            skipfull[: grid.nz] = np.asarray(skip_mask, bool)
        skip_slabs = jnp.asarray(
            skipfull.reshape(n_dev, slab, grid.ny, grid.nx))

        def local(starts_g, origin, inv_c, ps_l, vs_l, row0, n_loc, m2_l,
                  x_l, y_l, z_slab, skip_l):
            cells_l = _rebase(starts_g, origin, inv_c, ps_l, row0, n_loc)
            pts8_l = fg._build_pts8(cells_l.points_sorted, vs_l[0])
            axes_l = (x_l, y_l, z_slab[0])
            cand = fg._compact_gather(
                cells_l, None, axes_l, jnp.float32(margin), tuple(block),
                slab_shape, mc, C, group, pts8=pts8_l)
            qx, qy, qz = fg._build_queries(axes_l, tuple(block), dims_slab,
                                           tq)
            out = fg._fused_eval(m2_l, cand, qx, qy, qz, tuple(block),
                                 int(k), V, C, method, float(power),
                                 interpret=interpret)
            out = fg._reassemble(out, tuple(block), dims_slab, slab_shape)
            survey = fg._repair_survey(out[..., V], skip_l[0], tuple(block),
                                       dims_slab, nblk_cap)
            return out[None], survey[None]       # (1, slab, ny, nx, 8)

        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=store_specs + (P(), P(), P(), P(axis_name),
                                    P(axis_name)),
            out_specs=(P(axis_name), P(axis_name)), check_vma=False)
        out8, surveys = jax.jit(fn)(*store_args, m2, x_ax, y_ax, z_slabs,
                                    skip_slabs)
        out8, n_left = _slab_repair(
            out8, surveys, store, cells, grid, z_slabs, x_ax, y_ax, margin,
            tuple(block), dims_slab, slab_shape, nz_pad, z_pad, k, V, tq,
            method, float(power), mesh, axis_name, group, interpret,
            skip_slabs, store_specs, store_args, _rebase)
        out8 = out8.reshape(nz_pad, grid.ny, grid.nx, 8)[: grid.nz]
        out, den = out8[..., :V], out8[..., V]
        if n_left == 0:
            return out
        # far-field remainder (and any slab whose repair was ineligible):
        # the global exact ladder — per-query CSR panel, then brute force.
        # No ``block`` argument, so this cannot re-enter the fused repair.
        return repair_empty_nodes(out, den, points, values_dev, grid, k,
                                  method, power, cells=cells, margin=margin,
                                  skip_mask=skip_mask,
                                  values_sorted=values_sorted)

    def local(starts_g, origin, inv_c, ps_l, vs_l, row0, n_loc, x_l, y_l,
              z_slab):
        cells_l = _rebase(starts_g, origin, inv_c, ps_l, row0, n_loc)
        out, den = _grid_block_weighted_sum(
            cells_l, vs_l[0], (x_l, y_l, z_slab[0]), jnp.float32(margin),
            k, tuple(block), slab_shape, mc, row_len, weight_fn,
            recall_target, group, False, tau_mode)
        # carry the weight sums along so the far-field fallback (nodes
        # with an empty candidate region) can run after the slabs
        # recombine — multi-chip must match single-chip on clouds with
        # void regions
        return jnp.concatenate([out, den[..., None]], axis=-1)[None]

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=store_specs + (P(), P(), P(axis_name)),
        out_specs=P(axis_name), check_vma=False)
    out = jax.jit(fn)(*store_args, x_ax, y_ax, z_slabs)
    out = out.reshape(nz_pad, grid.ny, grid.nx, -1)[: grid.nz]
    out, den = out[..., :-1], out[..., -1]
    return repair_empty_nodes(out, den, points, values_dev,
                              grid, k, method, power, cells=cells,
                              margin=margin, skip_mask=skip_mask,
                              values_sorted=values_sorted, block=tuple(block))


# ---------------------------------------------------------------------------
# Full sharded pipeline step (the "training step" of this framework)
# ---------------------------------------------------------------------------

def make_pipeline_step(grid: Grid, mesh: Optional[Mesh] = None, k: int = 16,
                       power: float = 2.0, iterations: int = 1,
                       query_tile: int = 512, axis_name: str = DATA_AXIS):
    """Build a jitted end-to-end step: scattered vectors + fluid mask →
    divergence-cleaned grid field.

    The returned function is pure and shape-static: IDW interpolation onto
    the grid (queries sharded over the mesh when one is given), hard mask
    zeroing, and ``iterations`` of projection cleaning (fields z-sharded).
    This is the unit the driver compile-checks single-chip and dry-runs
    multi-chip.
    """
    from ptv_interpolation_tpu.physics import clean_divergence_projection

    dx, dy, dz = grid.spacing
    queries = np.asarray(grid.flat_coords())
    n_q = queries.shape[0]
    shape = grid.shape

    if mesh is not None:
        n_dev = mesh.devices.size
        padded = _pad_to(n_q, n_dev * query_tile)
        queries = np.pad(queries, ((0, padded - n_q), (0, 0)))

    def interp_local(pts, vals, q_shard):
        neighbor = bruteforce_tile_fn(pts, k)
        tile = _weighted_tile(neighbor, vals,
                              lambda d, ok: _idw_weights(d, power, ok))
        return map_query_tiles(tile, q_shard, query_tile)

    def step(points, values, fluid_mask):
        q = jnp.asarray(queries)
        if mesh is not None:
            out = jax.shard_map(
                interp_local, mesh=mesh,
                in_specs=(P(), P(), P(axis_name)),
                out_specs=P(axis_name), check_vma=False)(points, values, q)
        else:
            out = interp_local(points, values, q)
        out = out[:n_q].reshape(shape + (3,))
        maskf = fluid_mask.astype(jnp.float32)
        U = out[..., 0] * maskf
        V = out[..., 1] * maskf
        W = out[..., 2] * maskf
        res = clean_divergence_projection(U, V, W, fluid_mask, dx, dy, dz,
                                          iterations=iterations, maxiter=50)
        return res.u, res.v, res.w, res.mean_abs_div_final

    if mesh is None:
        return jax.jit(step)
    from jax.sharding import NamedSharding
    repl = NamedSharding(mesh, P())
    zshard = NamedSharding(mesh, P(axis_name))
    return jax.jit(step, in_shardings=(repl, repl, zshard),
                   out_shardings=(zshard, zshard, zshard, repl))
