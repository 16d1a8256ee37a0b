"""Block-centric kNN evaluation over regular grids — the at-scale kernel.

The naive cell-list query gathers a candidate set *per query point*
(≈1.7k indices × 16.7M queries at the 256³/1M benchmark scale — hundreds
of GB of scattered gather traffic, which bounds throughput long before
the arithmetic does). This kernel exploits the structure of the target:
queries form a **regular grid**, so neighboring queries share almost all
of their candidates.

Strategy (per grid block of ``bz×by×bx`` query points):

1. gather the candidate point/value rows for the *whole block* once —
   all cells overlapping the block's bounding box dilated by the kNN
   radius (static count per compile);
2. score every query in the block against the shared candidates densely
   (a (B, C) distance panel, elementwise f32 work);
3. per-query k-th-distance threshold τ — by default bisected exactly from
   the monotone count ``#{d² ≤ t}`` (no sort; selection parity equals
   exact top-k), or via ``approx_min_k`` (fast mode) / exact ``top_k``
   (oracle);
4. consume neighbors *locally*: weights (IDW/sibson) or small solves
   (local RBF) read candidate positions/values with a per-block
   ``take_along_axis`` — no global (Q, k) value gather ever happens.

This is the moral equivalent of the reference's only parallel path (the
``ProcessPoolExecutor`` chunking of RBF evaluation,
`/root/reference/interpolator.py:173-182`) redesigned around shared
candidate gathers. On the GPU the weighted-sum form runs as the fused
Triton kernel of ``ops/fused_grid_knn.py``; the XLA forms here serve the
CPU and every mode that kernel does not implement.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ptv_interpolation_tpu.grid import Grid
from ptv_interpolation_tpu.ops.kernels import select_kernels
from ptv_interpolation_tpu.ops.neighbors import (CellList, build_cell_list,
                                                 cell_meta_np)

_BIG = jnp.float32(3.4e38)


def _block_counts(n: int, b: int) -> int:
    return (n + b - 1) // b


def _pad_axis(ax, b: int):
    """Axis coordinates padded to a block multiple (the padded tail
    continues the grid spacing; out-of-range query results are sliced
    away after reassembly). Shared by the main kernel's host setup and
    the repair subset evaluator — the two MUST agree so repair blocks
    see the same query coordinates as the main pass.

    Returns HOST numpy: every consumer is a jitted function (tiny H2D
    enqueue per call), while the host capacity planners read the values
    directly — a device array here would cost one blocking device-to-host
    pull per ``np.asarray(axis)`` in the fused driver."""
    ax = np.asarray(ax, np.float32)
    n_ax = len(ax)
    target = _block_counts(n_ax, b) * b
    if target == n_ax:
        return ax
    step = ax[1] - ax[0] if n_ax > 1 else 1.0
    extra = ax[-1] + step * np.arange(1, target - n_ax + 1)
    return np.concatenate([ax, extra]).astype(np.float32)


@functools.partial(jax.jit, static_argnames=(
    "k", "block", "grid_shape", "mc", "row_len", "out_dim", "consume_fn",
    "exact_topk", "recall_target", "group", "needs_positions"))
def _grid_block_eval(cells: CellList, values_sorted, axes, margin, k: int,
                     block: Tuple[int, int, int],
                     grid_shape: Tuple[int, int, int],
                     mc: Tuple[int, int, int], row_len: int, out_dim: int,
                     consume_fn: Callable, exact_topk: bool,
                     recall_target: float, group: int,
                     needs_positions: bool = True):
    bz, by, bx = block
    nz, ny, nx = grid_shape
    nbz, nby, nbx = (_block_counts(nz, bz), _block_counts(ny, by),
                     _block_counts(nx, bx))
    mcz, mcy, mcx = mc
    ncx, ncy, ncz = cells.dims
    n_rows = mcz * mcy
    C = n_rows * row_len
    x_ax, y_ax, z_ax = axes  # padded to block multiples

    # local query offsets within a block (in index space)
    liz = jax.lax.broadcasted_iota(jnp.int32, (bz, by, bx), 0).ravel()
    liy = jax.lax.broadcasted_iota(jnp.int32, (bz, by, bx), 1).ravel()
    lix = jax.lax.broadcasted_iota(jnp.int32, (bz, by, bx), 2).ravel()

    # (z, y) cell-row lattice of the candidate region
    roz = jax.lax.broadcasted_iota(jnp.int32, (mcz, mcy), 0).ravel()
    roy = jax.lax.broadcasted_iota(jnp.int32, (mcz, mcy), 1).ravel()

    def one_block(flat_idx):
        ibz = flat_idx // (nby * nbx)
        iby = (flat_idx // nbx) % nby
        ibx = flat_idx % nbx

        gz = ibz * bz + liz
        gy = iby * by + liy
        gx = ibx * bx + lix
        q = jnp.stack([x_ax[gx], y_ax[gy], z_ax[gz]], axis=-1)   # (B, 3)

        # block bounding box (physical) dilated by the kNN margin
        lo = jnp.stack([x_ax[ibx * bx], y_ax[iby * by], z_ax[ibz * bz]])
        base = jnp.floor(
            (lo - margin - cells.origin) * cells.inv_cell).astype(jnp.int32)

        # contiguous x-runs of cells: one CSR range per (z, y) row
        cz = base[2] + roz
        cy = base[1] + roy
        row_ok = (cz >= 0) & (cz < ncz) & (cy >= 0) & (cy < ncy)
        x0 = jnp.clip(base[0], 0, ncx)
        x1 = jnp.clip(base[0] + mcx, 0, ncx)
        rid = (cz * ncy + cy) * ncx
        start = jnp.where(row_ok, cells.starts[rid + x0], 0)
        end = jnp.where(row_ok, cells.starts[rid + x1], 0)
        cnt = end - start

        def slice_row(s):
            p = jax.lax.dynamic_slice(cells.points_sorted, (s, 0),
                                      (row_len, 3))
            v = jax.lax.dynamic_slice(values_sorted, (s, 0),
                                      (row_len, values_sorted.shape[1]))
            return p, v

        cand_pts, cand_vals = jax.vmap(slice_row)(start)          # (R, L, ·)
        lane = jax.lax.broadcasted_iota(jnp.int32, (n_rows, row_len), 1)
        valid_c = (lane < cnt[:, None]).reshape(C)
        cand_pts = cand_pts.reshape(C, 3)
        cand_vals = cand_vals.reshape(C, values_sorted.shape[1])

        # dense distance panel — diff form, f32 exact
        d2 = jnp.sum((q[:, None, :] - cand_pts[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(valid_c[None, :], d2, _BIG)

        kk = min(k, C)
        if exact_topk:
            neg, args = jax.lax.top_k(-d2, kk)
            sq = -neg
        else:
            sq, args = jax.lax.approx_min_k(d2, kk,
                                            recall_target=recall_target)
        n_val = cand_vals[args]                                   # (B, k, V) local
        n_ok = valid_c[args] & (sq < _BIG)
        # weight-only consumers (IDW/sibson) skip the position gather
        n_pos = cand_pts[args] if needs_positions else None
        return consume_fn(sq, n_pos, n_val, n_ok, q)              # (B, out)

    n_blocks = nbz * nby * nbx
    # batch blocks through vmap so each loop step is a large fused kernel —
    # a bare map over tens of thousands of small blocks is launch-overhead
    # bound
    g = group
    while n_blocks % g:
        g //= 2
    ids = jnp.arange(n_blocks, dtype=jnp.int32).reshape(-1, g)
    out = jax.lax.map(jax.vmap(one_block), ids)
    out = out.reshape(nbz, nby, nbx, bz, by, bx, out_dim)
    out = out.transpose(0, 3, 1, 4, 2, 5, 6)
    out = out.reshape(nbz * bz, nby * by, nbx * bx, out_dim)
    return out[:nz, :ny, :nx]


def _snap_kth(d2, k: int, lo, hi):
    """The k-th smallest ``d2`` per row from a bisection bracket [lo, hi]
    (``(B, 1)`` each): when exactly k-1 values lie at or below ``lo``, the
    smallest value above it is the k-th; otherwise ``hi`` stands. Without
    it a (k+1)-th distance within the final bracket's width would be
    selected too. Same rule as ``fused_grid_knn._exact_kth``."""
    above = d2 > lo
    c_lo = jnp.sum((~above).astype(jnp.int32), axis=1, keepdims=True)
    m = jnp.min(jnp.where(above, d2, _BIG), axis=1, keepdims=True)
    return jnp.where((c_lo == k - 1) & (m <= hi), m, hi)


def _weighted_block_fn(cells: CellList, values_sorted, axes, margin,
                       k: int, block: Tuple[int, int, int],
                       nb: Tuple[int, int, int], mc: Tuple[int, int, int],
                       row_len: int, weight_fn: Callable,
                       recall_target: float, exact_tau: bool,
                       tau_mode: str) -> Callable:
    """Build the per-block closure of the weighted-sum path:
    ``one_block(flat_block_idx) -> (B, V+1)`` — shared by the full-grid
    evaluator and the subset (repair) evaluator."""
    bz, by, bx = block
    nbz, nby, nbx = nb
    mcz, mcy, mcx = mc
    ncx, ncy, ncz = cells.dims
    n_rows = mcz * mcy
    C = n_rows * row_len
    x_ax, y_ax, z_ax = axes
    V = values_sorted.shape[1]

    liz = jax.lax.broadcasted_iota(jnp.int32, (bz, by, bx), 0).ravel()
    liy = jax.lax.broadcasted_iota(jnp.int32, (bz, by, bx), 1).ravel()
    lix = jax.lax.broadcasted_iota(jnp.int32, (bz, by, bx), 2).ravel()
    roz = jax.lax.broadcasted_iota(jnp.int32, (mcz, mcy), 0).ravel()
    roy = jax.lax.broadcasted_iota(jnp.int32, (mcz, mcy), 1).ravel()

    def one_block(flat_idx):
        ibz = flat_idx // (nby * nbx)
        iby = (flat_idx // nbx) % nby
        ibx = flat_idx % nbx
        gz = ibz * bz + liz
        gy = iby * by + liy
        gx = ibx * bx + lix
        q = jnp.stack([x_ax[gx], y_ax[gy], z_ax[gz]], axis=-1)

        lo = jnp.stack([x_ax[ibx * bx], y_ax[iby * by], z_ax[ibz * bz]])
        base = jnp.floor(
            (lo - margin - cells.origin) * cells.inv_cell).astype(jnp.int32)
        cz = base[2] + roz
        cy = base[1] + roy
        row_ok = (cz >= 0) & (cz < ncz) & (cy >= 0) & (cy < ncy)
        x0 = jnp.clip(base[0], 0, ncx)
        x1 = jnp.clip(base[0] + mcx, 0, ncx)
        rid = (cz * ncy + cy) * ncx
        start = jnp.where(row_ok, cells.starts[rid + x0], 0)
        end = jnp.where(row_ok, cells.starts[rid + x1], 0)
        cnt = end - start

        def slice_row(s):
            p = jax.lax.dynamic_slice(cells.points_sorted, (s, 0),
                                      (row_len, 3))
            v = jax.lax.dynamic_slice(values_sorted, (s, 0), (row_len, V))
            return p, v

        cand_pts, cand_vals = jax.vmap(slice_row)(start)
        lane = jax.lax.broadcasted_iota(jnp.int32, (n_rows, row_len), 1)
        valid_c = (lane < cnt[:, None]).reshape(C)
        cand_pts = cand_pts.reshape(C, 3)
        cand_vals = cand_vals.reshape(C, V)

        d2 = jnp.sum((q[:, None, :] - cand_pts[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(valid_c[None, :], d2, _BIG)

        kk = min(k, C)
        # exact coverage sentinel: the candidate region contains every cloud
        # point within `margin` of any query in the block (guaranteed-radius
        # property), so counting candidates inside the margin counts ALL
        # cloud points inside it — covered ⟺ true k-th distance ≤ margin,
        # independent of the τ estimator. (A τ-based sentinel is wrong
        # at recall<1: the approx k-th distance overshoots the true one and
        # falsely flagged ~10% of the 256³/1M bench nodes, flooding
        # repair_empty_nodes with brute-force work.)
        m2 = margin * margin
        covered = (jnp.sum((d2 <= m2).astype(jnp.int32), axis=1,
                           keepdims=True) >= kk)
        mode = "exact" if exact_tau else tau_mode
        if mode == "bisect":
            # exact τ without any sort: c(t) = #{d² ≤ t} is monotone, so
            # 24 bisections on [0, margin²] pin the k-th distance to about
            # one f32 spacing, and _snap_kth takes the k-th d² itself.
            # Covered queries converge to the true τ; uncovered ones drive
            # hi → margin² and are repaired via the sentinel anyway.
            # a fori_loop, not an unrolled Python loop: 24 unrolled
            # compare+reduce passes inflate the HLO ~10× and the compile
            # time with it (each pass streams the stored panel either way)
            sq_topk = None

            def bisect_body(_, carry):
                lo, hi = carry
                mid = 0.5 * (lo + hi)
                c = jnp.sum((d2 <= mid).astype(jnp.int32), axis=1,
                            keepdims=True)
                short = c < kk
                return jnp.where(short, mid, lo), jnp.where(short, hi, mid)

            lo = jnp.zeros((d2.shape[0], 1), d2.dtype)
            hi = jnp.full((d2.shape[0], 1), m2, d2.dtype)
            lo, tau2 = jax.lax.fori_loop(0, 24, bisect_body, (lo, hi))
            tau2 = _snap_kth(d2, kk, lo, tau2)
        else:
            if mode == "exact":
                # exact k-th distance: the τ-mask becomes exactly the true
                # k-set (bar ties) and the sibson std/min stats match the
                # reference's k-set statistics
                sq_topk = -jax.lax.top_k(-d2, kk)[0]
            else:
                sq_topk, _ = jax.lax.approx_min_k(
                    d2, kk, recall_target=recall_target)
            # when covered, the true k-th distance ≤ margin, so clamping
            # the (overshooting) approx τ to the margin keeps every true
            # neighbor while cutting the spurious far tail out of the mask
            tau2 = jnp.minimum(sq_topk[:, -1:], jnp.where(covered, m2, _BIG))
        mask = (d2 <= tau2) & valid_c[None, :]
        d = jnp.sqrt(jnp.maximum(d2, 0.0))
        w = jnp.where(mask, weight_fn(d, mask, sq_topk), 0.0)
        # per-channel elementwise reductions: exact f32 without a matmul
        # (a default-precision contraction rounds its inputs — bf16 or
        # TF32 — which is visible at the 1e-4 level even on constant
        # fields)
        num = jnp.stack([jnp.sum(w * cand_vals[None, :, c], axis=1)
                         for c in range(V)], axis=1)
        den = jnp.sum(w, axis=1, keepdims=True)
        # zero the den channel for uncovered queries — sparse/void
        # neighborhoods on non-uniform clouds and domain edge/corner nodes
        # (~0.1% on uniform clouds) — so repair_empty_nodes recomputes them
        # through the exact path.
        return jnp.concatenate(
            [num / jnp.maximum(den, 1e-37),
             jnp.where(covered, den, 0.0)], axis=1)

    return one_block


@functools.partial(jax.jit, static_argnames=(
    "k", "block", "grid_shape", "mc", "row_len", "weight_fn",
    "recall_target", "group", "exact_tau", "tau_mode"))
def _grid_block_weighted_sum(cells: CellList, values_sorted, axes, margin,
                             k: int, block: Tuple[int, int, int],
                             grid_shape: Tuple[int, int, int],
                             mc: Tuple[int, int, int], row_len: int,
                             weight_fn: Callable, recall_target: float,
                             group: int, exact_tau: bool = False,
                             tau_mode: str = "approx"):
    """Weighted-sum fast path (IDW / sibson): selection-free reduction.

    A per-query k-th-distance threshold τ is found, then the weights are
    evaluated over the *whole* candidate panel masked by ``d ≤ τ`` and
    reduced with per-channel elementwise sums. Identical math to
    gather-the-k-neighbors (bar exact-τ ties), but the entire
    post-selection pipeline (index gathers, (B,k) value takes) disappears.

    ``tau_mode`` picks how τ is found:

    * ``'approx'`` — ``jax.lax.approx_min_k`` at ``recall_target``; the
      cheapest selection pass, with recall-dependent selection error.
    * ``'bisect'`` — exact τ by monotone counting: c(t) = #{d² ≤ t} is
      bisected on [0, margin²] (24 fused compare+reduce passes — no sort,
      no PartialReduce). Exact to ~margin²·2⁻²⁴, i.e. parity-equivalent
      to exact top-k, usually cheaper than recall ≥0.99 approx selection.
    * ``'exact'`` — full ``lax.top_k`` (the reference oracle; slowest).

    ``exact_tau=True`` is back-compat for ``tau_mode='exact'``.

    ``weight_fn(d, mask, sq_topk) -> (B, C) unnormalized weights``
    (``sq_topk`` is None in bisect mode — sibson statistics then come from
    masked panel reductions instead of the gathered top-k distances).
    """
    bz, by, bx = block
    nz, ny, nx = grid_shape
    nbz, nby, nbx = (_block_counts(nz, bz), _block_counts(ny, by),
                     _block_counts(nx, bx))
    V = values_sorted.shape[1]
    one_block = _weighted_block_fn(cells, values_sorted, axes, margin, k,
                                   block, (nbz, nby, nbx), mc, row_len,
                                   weight_fn, recall_target, exact_tau,
                                   tau_mode)
    n_blocks = nbz * nby * nbx
    g = group
    while n_blocks % g:
        g //= 2
    ids = jnp.arange(n_blocks, dtype=jnp.int32).reshape(-1, g)
    out = jax.lax.map(jax.vmap(one_block), ids)
    out = out.reshape(nbz, nby, nbx, bz, by, bx, V + 1)
    out = out.transpose(0, 3, 1, 4, 2, 5, 6)
    out = out.reshape(nbz * bz, nby * by, nbx * bx, V + 1)
    out = out[:nz, :ny, :nx]
    return out[..., :V], out[..., V]


@functools.partial(jax.jit, static_argnames=(
    "k", "block", "grid_shape", "mc", "row_len", "weight_fn", "group"))
def _grid_block_weighted_sum_subset(cells: CellList, values_sorted, axes,
                                    margin, ids, k: int,
                                    block: Tuple[int, int, int],
                                    grid_shape: Tuple[int, int, int],
                                    mc: Tuple[int, int, int], row_len: int,
                                    weight_fn: Callable, group: int):
    """Bisect-τ weighted sum over a *subset* of grid blocks (``ids``: flat
    block indices, padded to a multiple of ``group``). Returns
    ``(n_ids, B, V+1)`` in ``ids`` order — the repair stage's shared-
    candidate evaluator (each block gathers its candidate region once for
    all its queries, unlike the per-query CSR panel it replaces)."""
    bz, by, bx = block
    nz, ny, nx = grid_shape
    nb = (_block_counts(nz, bz), _block_counts(ny, by), _block_counts(nx, bx))
    one_block = _weighted_block_fn(cells, values_sorted, axes, margin, k,
                                   block, nb, mc, row_len, weight_fn,
                                   recall_target=1.0, exact_tau=False,
                                   tau_mode="bisect")
    n_ids = ids.shape[0]
    g = group
    while n_ids % g:
        g //= 2
    out = jax.lax.map(jax.vmap(one_block), ids.reshape(-1, g))
    return out.reshape(n_ids, bz * by * bx, values_sorted.shape[1] + 1)


def _generic_knn_fallback(points, values, queries, mode: str, power: float,
                          k: int):
    """Exact per-query interpolation through the generic kNN path — the
    escape hatch for nodes (or whole clouds) the block kernel can't serve.
    Honors the caller's ``k`` (a hardcoded fallback k silently changed the
    neighbor count, regression)."""
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        idw_interpolate, sibson_interpolate)
    k = min(k, np.shape(points)[0])
    if mode == "idw":
        return idw_interpolate(points, values, queries, k=k, power=power)
    return sibson_interpolate(points, values, queries, k=k)


@functools.partial(jax.jit, static_argnames=("k", "rings", "mode", "power",
                                              "query_tile"))
def _celllist_repair_eval(cells: CellList, values, queries, k: int,
                          rings: int, mode: str, power: float,
                          guard_radius, query_tile: int = 512):
    """Exact kNN weighting through the cell-list neighborhood, plus a
    per-query guarantee flag: ``good`` is True iff the returned k-th
    neighbor lies within ``guard_radius`` (= rings·cell_size), in which
    case the candidate neighborhood provably contains the true k-set."""
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        _idw_weights, _sibson_weights)
    from ptv_interpolation_tpu.ops.neighbors import (
        celllist_tile_fn, map_query_tiles)
    values = jnp.asarray(values, jnp.float32)
    neighbor = celllist_tile_fn(cells, k, rings, exact_topk=True)

    def tile(q_tile):
        sq, idx = neighbor(q_tile)
        ok = idx >= 0
        dist = jnp.sqrt(jnp.maximum(jnp.where(ok, sq, 1.0), 0.0))
        good = ok[:, -1] & (dist[:, -1] <= guard_radius)
        if mode == "idw":
            w = _idw_weights(dist, power, ok)
        else:
            w = _sibson_weights(dist, ok)
        vals = values[jnp.clip(idx, 0, None)]
        return (jnp.einsum("tk,tkc->tc", w, vals,
                           precision=jax.lax.Precision.HIGHEST), good)

    return map_query_tiles(tile, queries, query_tile)


@functools.partial(jax.jit, static_argnames=("k", "rings", "mode", "power",
                                              "query_tile"))
def _celllist_repair_eval_csr(cells: CellList, values_sorted, queries, k: int,
                              rings: int, mode: str, power: float,
                              guard_radius, query_tile: int = 512):
    """:func:`_celllist_repair_eval` through the CSR layout only — used when
    the cell list was built with ``build_table=False`` (the grid kernels'
    default, which skips ~28 MB of dense-table device transfer at 1M
    points). ``values_sorted`` is the cell-sorted values array from
    :func:`_host_setup` (sentinel rows are zero, far coordinates).

    Selection is bisected-τ over the candidate panel — the same monotone
    counting the block kernels use (``tau_mode='bisect'``), NOT
    ``lax.top_k``: at the headline geometry (64 tiles × (256, 11664)
    panels) the exact top-k sort was 1.15 s of the 1.52 s warm repair
    wall, while the 24 counting passes re-stream a ~12 MB panel from HBM
    in milliseconds. The coverage certificate is the exact in-guard count
    (≥ k candidates within ``guard_radius``), independent of τ."""
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        _idw_panel_weights, _sibson_panel_weights)
    from ptv_interpolation_tpu.ops.neighbors import (
        csr_candidate_panel, map_query_tiles)
    cap = cells.cap
    n_offsets = (2 * rings + 1) ** 3
    weight_fn = (_idw_panel_weights(power) if mode == "idw"
                 else _sibson_panel_weights())
    g2 = jnp.float32(guard_radius) ** 2

    def tile(q_tile):
        T = q_tile.shape[0]
        cand, d2 = csr_candidate_panel(cells, q_tile, rings)

        kk = jnp.int32(min(k, n_offsets * cap))
        good = jnp.sum((d2 <= g2).astype(jnp.int32), axis=1) >= kk

        def bisect_body(_, carry):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            c = jnp.sum((d2 <= mid).astype(jnp.int32), axis=1, keepdims=True)
            short = c < kk
            return jnp.where(short, mid, lo), jnp.where(short, hi, mid)

        lo = jnp.zeros((T, 1), d2.dtype)
        hi = jnp.full((T, 1), 1.0, d2.dtype) * g2
        _, tau2 = jax.lax.fori_loop(0, 24, bisect_body, (lo, hi))

        mask = d2 <= tau2
        d = jnp.sqrt(jnp.maximum(d2, 0.0))
        w = jnp.where(mask, weight_fn(d, mask, None), 0.0)
        vals = values_sorted[cand]          # sentinel rows gather zeros
        num = jnp.stack([jnp.sum(w * vals[..., c], axis=1)
                         for c in range(values_sorted.shape[1])], axis=1)
        den = jnp.sum(w, axis=1, keepdims=True)
        return num / jnp.maximum(den, 1e-37), good

    return map_query_tiles(tile, queries, query_tile)


def _pad_pow2(q: np.ndarray) -> tuple[np.ndarray, int]:
    """Pad rows to the next power of two (replicating the last row) so the
    jit cache sees a handful of shapes across calls."""
    m = len(q)
    padded = 1 << max(m - 1, 1).bit_length()
    if padded > m:
        q = np.concatenate([q, np.broadcast_to(q[-1:], (padded - m, 3))])
    return q, m


def repair_empty_nodes(out, den, points, values, grid: Grid, k: int,
                       mode: str, power: float = 2.0,
                       cells: CellList | None = None,
                       margin: float | None = None,
                       skip_mask=None, values_sorted=None, block=None,
                       interpret: bool = False):
    """Escape hatch for nodes the block kernel cannot serve exactly:
    empty candidate regions (void regions of non-uniform clouds) and
    uncovered neighborhoods (k-th candidate beyond the kNN margin —
    domain edges/corners, sparse pockets). Both arrive with ``den == 0``
    (the kernel's coverage sentinel) and are recomputed exactly in two
    stages:

    1. a rerun of the block kernel at 1.6× the margin over just the blocks
       containing uncovered nodes (``block`` given — the corner geometry
       bound: a domain-corner node's k-th neighbor sits at ~2× the bulk
       k-th radius, since only an octant of its neighborhood exists).
       Shared candidate gathers make this ~10× cheaper than the per-query
       cell-list panel it replaced (1.15 s → ~0.1 s at the 1M→256³ bench,
       where the per-query path gathered 190M candidate rows for 14k
       repair nodes). Queries self-certify via the coverage sentinel at
       the widened margin. Without ``block``, the per-query cell-list kNN
       panel (``_celllist_repair_eval[_csr]``) serves this stage instead.
    2. brute force against the full cloud for whatever stage 1 could not
       certify (genuine far-field voids) — chunked and shape-bucketed so
       no input can produce an unboundedly large device program.

    ``out``: (nz, ny, nx, V), ``den``: (nz, ny, nx) weight sums from
    :func:`_grid_block_weighted_sum`. Shared by the single-chip driver and
    the sharded slab path so multi-chip results match single-chip on
    clouds with void regions.

    Transfer discipline: the full field NEVER crosses the device boundary
    here — only a scalar count, the uncovered flat indices, and the
    repaired rows move.

    ``skip_mask`` (optional, (nz,ny,nx) bool, True = skip): nodes the
    caller will overwrite anyway — e.g. solid voxels that get zeroed right
    after interpolation (`/root/reference/main.py:201-207`) — are excluded
    from repair. On porous geometries the solid interior is exactly where
    coverage fails (no particles live there), so without this ~25% of a
    256³ grid would be repaired only to be discarded.

    ``interpret``: run the fused kernels of the Triton route in interpret
    mode (see ``ops/kernels.py``)."""
    use_kernels = (cells is not None and margin is not None
                   and block is not None and values_sorted is not None
                   and select_kernels(interpret) == "triton")
    if use_kernels:
        # single-dispatch device repair: survey pull → one traced program
        # (widened-margin panel + certification + scatter) → n_rep pull,
        # in place of the host-mediated ladder below; ineligible/void-
        # dominated clouds fall through.
        from ptv_interpolation_tpu.ops.fused_grid_knn import fused_repair
        res = fused_repair(out, den, skip_mask, cells, values_sorted, grid,
                           k, mode, power, tuple(block), float(margin),
                           interpret=interpret)
        if res is not None:
            out, den2, n_left = res
            if n_left == 0:
                return out
            # rare tail: genuine far-field voids the widened margin cannot
            # certify — recurse into the exact brute-force ladder with the
            # repaired nodes already marked served in den2
            return repair_empty_nodes(out, den2, points, values, grid, k,
                                      mode, power, skip_mask=skip_mask)
    den_zero = den == 0.0                       # stays on device
    if skip_mask is not None:
        den_zero = den_zero & ~jnp.asarray(skip_mask, bool)
    n_fix = int(jnp.sum(den_zero))              # scalar pull
    if n_fix == 0:
        return out
    from ptv_interpolation_tpu.interpolate.knn_weights import (
        idw_interpolate, sibson_interpolate)
    flat = jnp.nonzero(den_zero.ravel(), size=n_fix)[0]
    flat_np = np.asarray(flat)                  # (n_fix,) index pull
    iz, iy, ix = np.unravel_index(flat_np, np.shape(den))
    queries = np.stack([np.asarray(grid.x)[ix], np.asarray(grid.y)[iy],
                        np.asarray(grid.z)[iz]], axis=-1).astype(np.float32)
    kk = min(k, np.shape(points)[0])
    fixed = np.empty((n_fix, np.shape(values)[1]), np.float32)
    todo = np.arange(n_fix)
    ran_subset = False

    if (cells is not None and margin is not None and block is not None
            and values_sorted is not None and len(todo)):
        # stage 1 (shared-candidate form): rerun the block kernel at 1.6×
        # margin over just the uncovered blocks
        from ptv_interpolation_tpu.interpolate.knn_weights import (
            _idw_panel_weights, _sibson_panel_weights)
        bz, by, bx = block
        nzs, nys, nxs = np.shape(den)
        nbz, nby, nbx = (_block_counts(nzs, bz), _block_counts(nys, by),
                         _block_counts(nxs, bx))
        blk = ((iz // bz) * nby + (iy // by)) * nbx + (ix // bx)
        uniq, inv = np.unique(blk, return_inverse=True)
        cell_size = 1.0 / cell_meta_np(cells)[1]
        margin2 = 1.6 * float(margin)
        dx, dy, dz = grid.spacing
        mc2 = tuple(
            int(math.ceil((ext + 2.0 * margin2) / cell_size)) + 1
            for ext in (bx * dx, by * dy, bz * dz))[::-1]
        row_len2 = _row_capacity(cells, mc2[2])
        B = bz * by * bx
        # skip when the padded subset dwarfs the repair population (void-
        # dominated clouds scatter den==0 over most blocks — certification
        # would fail there anyway and brute force does the real work)
        if len(uniq) * B <= max(32 * n_fix, 64 * B):
            axes2 = (_pad_axis(grid.x, bx), _pad_axis(grid.y, by),
                     _pad_axis(grid.z, bz))
            V1 = np.shape(values)[1]
            sub_rows = None
            if use_kernels:
                # fused subset kernel (compacted panel, streamed)
                from ptv_interpolation_tpu.ops.fused_grid_knn import (
                    fused_subset_weighted_sum)
                sub_rows = fused_subset_weighted_sum(
                    cells, values_sorted, axes2, margin2, uniq, kk,
                    tuple(block), (nzs, nys, nxs), mc2, mode, float(power),
                    V1, interpret=interpret)
            if sub_rows is None and row_len2 <= 1024:
                weight_fn = (_idw_panel_weights(float(power))
                             if mode == "idw" else _sibson_panel_weights())
                n_pad = 1 << max(len(uniq) - 1, 1).bit_length()
                ids = np.concatenate(
                    [uniq, np.broadcast_to(uniq[-1:], (n_pad - len(uniq),))])
                sub = _grid_block_weighted_sum_subset(
                    cells, values_sorted, axes2, jnp.float32(margin2),
                    jnp.asarray(ids, jnp.int32), kk, tuple(block),
                    (nzs, nys, nxs), mc2, row_len2, weight_fn, 8)
                sub_rows = sub.reshape(-1, V1 + 1)[:len(uniq) * B].reshape(
                    len(uniq), B, V1 + 1)
            if sub_rows is not None:
                local = ((iz % bz) * by + (iy % by)) * bx + (ix % bx)
                rows = inv.astype(np.int64) * B + local
                picked = np.asarray(
                    sub_rows.reshape(-1, V1 + 1)[jnp.asarray(rows)])
                good = picked[:, V1] > 0.0
                fixed[good] = picked[good, :V1]
                todo = todo[~good]
                ran_subset = True

    if (not ran_subset and cells is not None and margin is not None
            and len(todo)):
        cell_size = 1.0 / cell_meta_np(cells)[1]
        # corners need ~2× the bulk k-th radius (octant geometry);
        # margin = 1.45·r_k, so 1.6·margin ≈ 2.3·r_k covers it with slack
        rings = int(math.ceil(1.6 * float(margin) / cell_size))
        n_cand = (2 * rings + 1) ** 3 * cells.cap
        # eligibility bound: the per-tile candidate gather materializes
        # (tile·n_cand)-row intermediates, and clustered boundary particles
        # inflate cells.cap (a global max) without bound. 16384 × tile 256
        # caps them at a few hundred MB; bigger neighborhoods fall through
        # to the chunked brute-force stage, which streams points instead.
        has_table = cells.table.shape[0] > 1
        if rings <= 6 and n_cand <= 16384 and (values_sorted is not None
                                               or has_table):
            qp, m = _pad_pow2(queries)
            if values_sorted is not None:
                # CSR path: no dense table needed (grid kernels build their
                # cell lists with build_table=False)
                vals_s1, good = _celllist_repair_eval_csr(
                    cells, values_sorted, qp, kk, rings, mode, float(power),
                    jnp.float32(rings * cell_size), query_tile=256)
            else:
                vals_s1, good = _celllist_repair_eval(
                    cells, values, qp, kk, rings, mode, float(power),
                    jnp.float32(rings * cell_size), query_tile=256)
            good = np.asarray(good)[:m]
            fixed[good] = np.asarray(vals_s1)[:m][good]
            todo = todo[~good]

    if len(todo):
        n_nodes = int(np.prod(np.shape(den)))
        if len(todo) > 0.01 * n_nodes:
            print(f"[grid_knn] repairing {len(todo)}/{n_nodes} uncovered "
                  f"grid nodes ({100.0 * len(todo) / n_nodes:.1f}%) "
                  f"through the exact brute-force path — the point cloud "
                  f"has large voids relative to the kNN margin")
        CHUNK = 131072
        for s in range(0, len(todo), CHUNK):
            sel = todo[s:s + CHUNK]
            qc, m = _pad_pow2(queries[sel])
            if mode == "idw":
                part = idw_interpolate(points, values, qc, k=kk, power=power)
            else:
                part = sibson_interpolate(points, values, qc, k=kk)
            fixed[sel] = np.asarray(part)[:m]

    # device-side scatter of the repaired rows (out keeps (nz,ny,nx,V)
    # C-order, so the flat den index addresses the same node).
    # ``flat`` is from nonzero → ascending + unique; declaring that lets
    # XLA lower an in-place sorted scatter instead of the generic
    # serialized form (~0.4 s for 14k rows at 256³ without the hints)
    V = out.shape[-1]
    out = out.reshape(-1, V).at[flat].set(jnp.asarray(fixed),
                                          indices_are_sorted=True,
                                          unique_indices=True)
    return out.reshape(np.shape(den) + (V,))


def grid_weighted_interpolate(points, values, grid: Grid, k: int,
                              weight_fn: Callable,
                              cells: CellList | None = None,
                              cell_size: float | None = None,
                              block: Tuple[int, int, int] | None = None,
                              margin_factor: float = 1.45,
                              recall_target: float = 0.9, group: int = 8,
                              backend: str = "auto", mode: str = "sibson",
                              power: float = 2.0, exact_tau: bool = False,
                              tau_mode: str = "bisect", skip_mask=None,
                              interpret: bool = False):
    """Driver for the weighted-sum fast path (shares host setup with
    :func:`grid_knn_apply`).

    ``backend`` selects the kernel formulation:

    * ``'auto'`` (default): the route of ``ops.kernels.select_kernels`` —
      on the GPU with ``tau_mode='bisect'``, the fused two-phase Triton
      kernel (``ops/fused_grid_knn.py`` — compact XLA gather + streaming
      τ-bisect; identical selection math), falling back to ``'xla'`` when
      the compacted panel exceeds its capacity bound; on the CPU,
      ``'xla'``.
    * ``'triton'``: the fused kernel, no fallback (``interpret=True`` runs
      it in the Pallas interpreter on any platform).
    * ``'xla'``: the streaming one-phase XLA kernel (every platform, every
      selection mode).

    The default ``tau_mode='bisect'`` gives exact-selection parity with
    the f64 scipy reference (the f32 floor); ``tau_mode='approx'`` with
    ``recall_target=0.9`` trades accuracy (L2 ~5e-3) for a cheaper
    selection pass in the XLA kernel.

    Degrades gracefully on pathologically clustered clouds: if no cell
    resolution satisfies the block kernel's row-capacity bound (e.g. >1024
    coincident points), the whole call routes through the exact generic
    kNN path instead of failing (`RowCapacityError`)."""
    if block is None:
        # (8,8,16) on uniform clouds (1024-query blocks amortize the
        # candidate fetch), flatter z-blocks on masked/porous geometries: a
        # solid mask means taller blocks span more occupancy variation,
        # inflating the shared region's capacity. The skip_mask is the
        # porosity signal the caller already provides.
        block = (4, 8, 16) if skip_mask is not None else (8, 8, 16)
    if backend not in ("auto", "triton", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    # the fused kernel derives its weights from mode/power internally —
    # it must only serve calls whose weight_fn IS the canned formula for
    # that mode (tagged by knn_weights' factories); a custom weight_fn
    # would otherwise be silently dropped on one platform and honored on
    # another
    canned = getattr(weight_fn, "canned_mode", None) == mode
    if backend == "triton" and not canned:
        raise ValueError(
            "backend='triton' computes its own idw/sibson weights and "
            "cannot honor a custom weight_fn; use backend='xla'")
    if backend == "triton" and (exact_tau or tau_mode != "bisect"):
        raise ValueError(
            "backend='triton' implements tau_mode='bisect' only; use "
            "backend='xla' for approx/exact selection modes")
    if backend == "triton" or (
            backend == "auto" and canned and tau_mode == "bisect"
            and not exact_tau and cells is None
            and mode in ("idw", "sibson")
            and select_kernels(interpret) == "triton"):
        from ptv_interpolation_tpu.ops.fused_grid_knn import (
            FusedCapacityError, fused_grid_weighted_interpolate)
        try:
            return fused_grid_weighted_interpolate(
                points, values, grid, k, mode=mode, power=power,
                block=block, margin_factor=margin_factor, group=group,
                skip_mask=skip_mask, interpret=interpret)
        except (FusedCapacityError, RowCapacityError):
            if backend == "triton":
                raise
            # auto: panel too wide (or no feasible cell size) — fall
            # through to the streaming path / generic fallback
    try:
        setup = _host_setup(points, values, grid, k, cells, cell_size, block,
                            margin_factor)
    except RowCapacityError:
        queries = np.asarray(grid.flat_coords())
        out = _generic_knn_fallback(points, values, queries, mode, power, k)
        return jnp.asarray(out).reshape(grid.shape + (-1,))
    (cells, values_sorted, axes, margin, mc, row_len, values_dev) = setup
    out, den = _grid_block_weighted_sum(cells, values_sorted, axes,
                                        jnp.float32(margin), k, tuple(block),
                                        grid.shape, mc, row_len, weight_fn,
                                        recall_target, group, exact_tau,
                                        tau_mode)
    return repair_empty_nodes(out, den, points, values_dev, grid, k, mode,
                              power, cells=cells, margin=margin,
                              skip_mask=skip_mask, values_sorted=values_sorted,
                              block=tuple(block), interpret=interpret)


def grid_knn_apply(points, values, grid: Grid, k: int, consume_fn: Callable,
                   out_dim: int, cells: CellList | None = None,
                   cell_size: float | None = None,
                   block: Tuple[int, int, int] = (8, 8, 8),
                   margin_factor: float = 1.45, exact_topk: bool = False,
                   recall_target: float = 0.99, group: int = 8,
                   needs_positions: bool = True):
    """Evaluate ``consume_fn`` on the k nearest ``points`` of every grid
    node. ``consume_fn(sq_dists, neighbor_pos, neighbor_vals, valid, q)``
    maps a (B, k[,·]) neighborhood batch to (B, out_dim).

    Host-side setup picks the cell size so the candidate region covers the
    expected k-th-neighbor radius times ``margin_factor``; the static
    cell-row count and row capacity follow from the block's physical
    extent and the observed occupancy.
    """
    (cells, values_sorted, axes, margin, mc, row_len, _) = _host_setup(
        points, values, grid, k, cells, cell_size, block, margin_factor)
    return _grid_block_eval(cells, values_sorted, axes, jnp.float32(margin),
                            k, tuple(block), grid.shape, mc, row_len,
                            out_dim, consume_fn, exact_topk, recall_target,
                            group, needs_positions)


class RowCapacityError(ValueError):
    """No cell resolution can satisfy the block kernel's 1024-point
    row-capacity bound (pathologically clustered / coincident points);
    callers should route through the generic kNN path."""


@functools.partial(jax.jit, static_argnames=("dims", "w"))
def _row_capacity_device(starts, dims, w: int):
    """Device form of :func:`_row_capacity` — runs where ``starts`` lives
    (device-side CSR builds keep no host copy) and returns one i32 scalar."""
    ncx, ncy, ncz = dims
    counts = jnp.diff(starts).reshape(ncz * ncy, ncx)
    csum = jnp.concatenate(
        [jnp.zeros((ncz * ncy, 1), jnp.int32), jnp.cumsum(counts, axis=1)],
        axis=1)
    windows = csum[:, w:] - csum[:, :-w] if ncx > w else csum[:, -1:]
    return jnp.maximum(jnp.max(windows), 1)


def _row_capacity(cells: CellList, mcx: int) -> int:
    """Static row capacity: max points in any ``mcx``-wide x-run of cells —
    the guaranteed-coverage bound shared by the grid and scatter kernels
    (must stay within the 1024-column sentinel padding of the sorted
    arrays; callers refine the cell size or fall back when it doesn't)."""
    ncx, ncy, ncz = cells.dims
    if cells.starts_host is None:
        # device CSR build: windowed max on device, pull one scalar
        # instead of the full starts array
        return int(np.asarray(_row_capacity_device(
            cells.starts, cells.dims, min(mcx, ncx))))
    # prefer the host-side copy: np.asarray on the device array forces a
    # blocking drain of the async transfer queue right after
    # build_cell_list pushed ~30 MB at 1M points
    starts_np = cells.starts_host
    row_counts = np.diff(starts_np.astype(np.int64)).reshape(ncz * ncy, ncx)
    w = min(mcx, ncx)
    csum = np.concatenate([np.zeros((row_counts.shape[0], 1), np.int64),
                           np.cumsum(row_counts, axis=1)], axis=1)
    windows = csum[:, w:] - csum[:, :-w] if ncx > w else csum[:, -1:]
    row_len = int(windows.max()) if windows.size else int(row_counts.max())
    return max(row_len, 1)


def _host_setup(points, values, grid: Grid, k: int, cells, cell_size, block,
                margin_factor, cell_divisor: float = 2.0):
    """Shared host-side setup: cell list, margin, static candidate-region
    dimensions, row capacity, padded axes, and cell-sorted values.

    ``cell_divisor``: auto cell edge = margin / cell_divisor. The
    streaming path uses 2 (coarse cells → fewer, longer dynamic-slice
    rows); the fused path passes 3 — finer cells track the dilated block
    region ~17% tighter, shrinking the compacted panel C and with it both
    the flat gather and the kernel's passes.

    On strongly clustered clouds (near-wall PTV seeding) the auto cell size
    can put >1024 points in one candidate row; rather than failing, the
    cell list is rebuilt at progressively finer resolution (a row's y/z
    thickness is one cell, so capacity shrinks ~quadratically with the cell
    edge). If refinement cannot help — e.g. >1024 coincident points —
    :class:`RowCapacityError` is raised for callers to catch."""
    pts = np.asarray(points, np.float32)
    vals = np.asarray(values, np.float32)
    n = pts.shape[0]

    if cells is None:
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        extent = np.maximum(hi - lo, 1e-12)
        density = n / float(np.prod(extent))
        r_k = (3.0 * k / (4.0 * math.pi * density)) ** (1.0 / 3.0)
        if cell_size is None:
            cell_size = max(r_k * margin_factor / cell_divisor, 1e-6)
        cells = build_cell_list(pts, cell_size=cell_size, build_table=False,
                                bounds=(lo, hi))
    else:
        lo, inv_c = cell_meta_np(cells)
        cell_size = 1.0 / inv_c
        hi = pts.max(axis=0)
        extent = np.maximum(hi - lo, 1e-12)
        density = n / float(np.prod(extent))
        r_k = (3.0 * k / (4.0 * math.pi * density)) ** (1.0 / 3.0)

    margin = r_k * margin_factor
    dx, dy, dz = grid.spacing
    block_ext = (block[2] * dx, block[1] * dy, block[0] * dz)  # x, y, z

    def region_dims(cs):
        return tuple(
            int(math.ceil((ext + 2.0 * margin) / cs)) + 1
            for ext in (block_ext[0], block_ext[1], block_ext[2]))[::-1]

    mc = region_dims(cell_size)
    row_len = _row_capacity(cells, mc[2])
    for _ in range(6):
        if row_len <= 1024:
            break
        # capacity ~ cell_size² (row thickness is one cell in y and z)
        shrink = min(math.sqrt(1024.0 / row_len) * 0.9, 0.7)
        cell_size = cell_size * shrink
        if cell_size < 1e-9:
            break
        cells = build_cell_list(pts, cell_size=cell_size, build_table=False,
                                bounds=(lo, hi))
        mc = region_dims(cell_size)
        row_len = _row_capacity(cells, mc[2])
    if row_len > 1024:
        raise RowCapacityError(
            f"cell row capacity {row_len} exceeds the sorted-array padding "
            f"at every cell resolution tried — cloud too clustered for the "
            f"block kernel; use the generic kNN path")

    # axes padded to block multiples (out-of-range queries are sliced away)
    axes = (_pad_axis(grid.x, block[2]), _pad_axis(grid.y, block[1]),
            _pad_axis(grid.z, block[0]))

    # values pushed to device ONCE; the cell-order sort reuses this copy and
    # so does the repair stage (a second jnp.asarray(np_values) in the
    # repair would re-transfer ~12 MB per call at 1M points)
    values_dev = jnp.asarray(vals)
    values_sorted = _sort_values(values_dev, cells.order)
    return cells, values_sorted, axes, margin, mc, row_len, values_dev


@jax.jit
def _sort_values(vals, order):
    sorted_vals = vals[order]
    pad = jnp.zeros((1024, vals.shape[1]), vals.dtype)
    return jnp.concatenate([sorted_vals, pad])


# ---------------------------------------------------------------------------
# Scatter-block variant: arbitrary query points grouped into spatial blocks
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "k", "mc", "row_len", "b_cap", "out_dim", "consume_fn", "exact_topk",
    "recall_target", "group"))
def _scatter_block_eval(cells: CellList, values_sorted, queries_padded,
                        q_table, block_origins, margin, k: int,
                        mc: Tuple[int, int, int], row_len: int, b_cap: int,
                        out_dim: int, consume_fn: Callable, exact_topk: bool,
                        recall_target: float, group: int):
    """Like ``_grid_block_eval`` but queries are arbitrary points pre-grouped
    into spatial blocks (``q_table``: (n_blocks, b_cap) indices into
    ``queries_padded``, sentinel = last padded row far away)."""
    mcz, mcy, mcx = mc
    ncx, ncy, ncz = cells.dims
    n_rows = mcz * mcy
    C = n_rows * row_len
    V = values_sorted.shape[1]
    n_blocks = q_table.shape[0]

    roz = jax.lax.broadcasted_iota(jnp.int32, (mcz, mcy), 0).ravel()
    roy = jax.lax.broadcasted_iota(jnp.int32, (mcz, mcy), 1).ravel()

    def one_block(flat_idx):
        q_idx = q_table[flat_idx]                         # (b_cap,)
        q = queries_padded[q_idx]                         # (b_cap, 3)
        lo = block_origins[flat_idx]                      # (3,) x,y,z

        base = jnp.floor(
            (lo - margin - cells.origin) * cells.inv_cell).astype(jnp.int32)
        cz = base[2] + roz
        cy = base[1] + roy
        row_ok = (cz >= 0) & (cz < ncz) & (cy >= 0) & (cy < ncy)
        x0 = jnp.clip(base[0], 0, ncx)
        x1 = jnp.clip(base[0] + mcx, 0, ncx)
        rid = (cz * ncy + cy) * ncx
        start = jnp.where(row_ok, cells.starts[rid + x0], 0)
        end = jnp.where(row_ok, cells.starts[rid + x1], 0)
        cnt = end - start

        def slice_row(s):
            p = jax.lax.dynamic_slice(cells.points_sorted, (s, 0),
                                      (row_len, 3))
            v = jax.lax.dynamic_slice(values_sorted, (s, 0), (row_len, V))
            return p, v

        cand_pts, cand_vals = jax.vmap(slice_row)(start)
        lane = jax.lax.broadcasted_iota(jnp.int32, (n_rows, row_len), 1)
        valid_c = (lane < cnt[:, None]).reshape(C)
        cand_pts = cand_pts.reshape(C, 3)
        cand_vals = cand_vals.reshape(C, V)

        d2 = jnp.sum((q[:, None, :] - cand_pts[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(valid_c[None, :], d2, _BIG)

        kk = min(k, C)
        if exact_topk:
            neg, args = jax.lax.top_k(-d2, kk)
            sq = -neg
        else:
            sq, args = jax.lax.approx_min_k(d2, kk,
                                            recall_target=recall_target)
        n_val = cand_vals[args]
        n_ok = valid_c[args] & (sq < _BIG)
        return consume_fn(sq, None, n_val, n_ok, q)       # (b_cap, out)

    g = group
    while n_blocks % g:
        g //= 2
    ids = jnp.arange(n_blocks, dtype=jnp.int32).reshape(-1, g)
    out = jax.lax.map(jax.vmap(one_block), ids)
    return out.reshape(n_blocks * b_cap, out_dim)


def scatter_knn_apply(points, values, queries, k: int, consume_fn: Callable,
                      out_dim: int, cell_size: float | None = None,
                      margin_factor: float = 1.45, exact_topk: bool = False,
                      recall_target: float = 0.99, group: int = 8):
    """Block-centric kNN over *arbitrary* query points: queries are bucketed
    into margin-sized spatial blocks on the host, each block shares one
    candidate fetch. This is the at-scale path for point-cloud self-queries
    (the kNN-MAD outlier filter). Returns (Q, out_dim) in query order."""
    pts = np.asarray(points, np.float32)
    vals = np.asarray(values, np.float32)
    qrs = np.asarray(queries, np.float32)
    n = pts.shape[0]

    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    density = n / float(np.prod(extent))
    r_k = (3.0 * k / (4.0 * math.pi * density)) ** (1.0 / 3.0)
    if cell_size is None:
        cell_size = max(r_k * margin_factor / 2.0, 1e-6)
    cells = build_cell_list(pts, cell_size=cell_size)
    margin = r_k * margin_factor

    # block lattice over the query bbox, edge ≈ 2·margin
    block_edge = 2.0 * margin

    # clustered-cloud refinement: shrink cells until the candidate-row
    # capacity fits the 1024-row sentinel padding (capacity ~ cell_size²)
    for _ in range(6):
        mc_x = int(math.ceil((block_edge + 2 * margin) / cell_size)) + 1
        row_len = _row_capacity(cells, mc_x)
        if row_len <= 1024:
            break
        cell_size *= min(math.sqrt(1024.0 / row_len) * 0.9, 0.7)
        if cell_size < 1e-9:
            break
        cells = build_cell_list(pts, cell_size=cell_size)
    else:
        row_len = _row_capacity(
            cells, int(math.ceil((block_edge + 2 * margin) / cell_size)) + 1)
    if row_len > 1024:
        raise RowCapacityError(
            f"cell row capacity {row_len} exceeds the sorted-array padding "
            f"at every cell resolution tried — cloud too clustered for the "
            f"scatter-block kernel; use the generic kNN path")
    q_lo = qrs.min(axis=0)
    dims = np.maximum(np.ceil((qrs.max(axis=0) - q_lo) / block_edge
                              ).astype(int), 1)
    bidx = np.clip(((qrs - q_lo) / block_edge).astype(np.int64), 0, dims - 1)
    bid = (bidx[:, 2] * dims[1] + bidx[:, 1]) * dims[0] + bidx[:, 0]
    order = np.argsort(bid, kind="stable")
    sorted_bid = bid[order]
    # occupied blocks only
    uniq, inv_start = np.unique(sorted_bid, return_index=True)
    counts = np.diff(np.append(inv_start, len(sorted_bid)))
    b_cap = int(counts.max())
    n_blocks = len(uniq)
    q_table = np.full((n_blocks, b_cap), len(qrs), np.int64)
    rank = np.arange(len(sorted_bid)) - np.repeat(inv_start, counts)
    q_table[np.repeat(np.arange(n_blocks), counts), rank] = order
    # physical origin (x, y, z) of each occupied block
    uz = uniq // (dims[1] * dims[0])
    uy = (uniq // dims[0]) % dims[1]
    ux = uniq % dims[0]
    block_origins = (q_lo[None, :]
                     + np.stack([ux, uy, uz], axis=-1) * block_edge)

    # static candidate-region dims for a block of edge block_edge + 2·margin
    mc = tuple(int(math.ceil((block_edge + 2 * margin) / cell_size)) + 1
               for _ in range(3))
    row_len = _row_capacity(cells, mc[2])

    queries_padded = np.concatenate(
        [qrs, np.full((1, 3), 1e19, np.float32)])
    values_sorted = _sort_values(jnp.asarray(vals), cells.order)

    out = _scatter_block_eval(
        cells, values_sorted, jnp.asarray(queries_padded),
        jnp.asarray(q_table, jnp.int32),
        jnp.asarray(block_origins, jnp.float32), jnp.float32(margin),
        k, mc, row_len, b_cap, out_dim, consume_fn, exact_topk,
        recall_target, group)
    # unscatter: out rows follow q_table order
    result = np.empty((len(qrs), out_dim), np.float32)
    flat_idx = q_table.reshape(-1)
    valid = flat_idx < len(qrs)
    result[flat_idx[valid]] = np.asarray(out)[valid]
    return result
