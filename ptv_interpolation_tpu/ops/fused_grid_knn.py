"""Fused two-phase grid kNN: compact candidate gather (XLA) + streaming
τ-bisection weighted sum (Pallas, Triton route).

Why a kernel — the one-phase XLA form
(``ops/grid_knn.py::_grid_block_weighted_sum``) materializes each block's
(B, C) distance panel in device memory (≈16 MB per block at the
1M→256³/k=50 geometry) and re-reads it in each of the 24 τ-bisection
counting passes: its cost is memory traffic, not arithmetic. This module
restructures the same math so that no panel is ever stored:

* **Phase 1 (XLA)** gathers each block's candidate rows once and writes a
  *compacted* per-block panel ``(8, n_blocks·C)`` — rows x,y,z,u,v,w,0,0,
  invalid slots filled with far sentinels. Compaction (cumsum over the
  block's CSR rows + a vectorized slot→row search) shrinks C from
  ``n_rows × row_capacity`` (max-padded) to the actual candidate count.
* **Phase 2 (Pallas/Triton)** runs one program per (grid block, tile of
  ``_TQ`` queries). Every pass streams the block's candidates in chunks of
  ``_CC`` (12 B each for x, y, z — the block's panel stays in L1/L2) and
  **recomputes** d² instead of storing it; counts and τ live in registers.
  The bisection passes, the sibson statistics, and the weighted
  per-channel sums all run in the one program.

Selection math is identical to the XLA path's ``tau_mode='bisect'``
(monotone counting of ``#{d² ≤ t}``: 24 halvings of [0, margin²], then
one pass that snaps τ² to the k-th d² itself — exact top-k selection),
and d² is computed with the same expression as the XLA form, so both
select the same neighbors. The coverage sentinel / ``repair_empty_nodes``
escape hatch is shared unchanged. The kernel has no matrix contraction:
every operation is an f32 subtract/multiply/compare/count, ``sqrt`` or
``exp``.

Reference parity target: the sibson/IDW weight math of
`/root/reference/interpolator.py:83-155` (same formulas as
``interpolate/knn_weights.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ptv_interpolation_tpu.grid import Grid


_EPS = 1e-10              # reference's weight epsilon (interpolator.py:106)
_BISECT_ITERS = 24
# tile shape, swept on an H100 at the 1M→256³ headline (PERF.md): larger
# query tiles spill registers (128 queries ran 4× slower than 64)
_TQ = 32                  # queries per kernel program
_CC = 32                  # candidates per streamed chunk (C is padded to it)
_NUM_WARPS = 2


def _block_counts(n: int, b: int) -> int:
    return (n + b - 1) // b


def _panel_width(c_raw: int) -> int:
    """Static panel width: the candidate count rounded up to whole chunks."""
    return max((c_raw + _CC - 1) // _CC * _CC, _CC)


def _query_tile(B: int) -> int:
    """Queries per program for a block of ``B`` queries (a power of two —
    Triton tiles are powers of two and a tile must not straddle blocks)."""
    if B & (B - 1):
        raise ValueError(f"block volume {B} must be a power of two")
    return min(B, _TQ)


# ---------------------------------------------------------------------------
# Phase 1: compact candidate gather (XLA)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "block", "grid_shape", "mc", "C", "group"))
def _compact_indices(cells, axes, margin,
                     block: Tuple[int, int, int],
                     grid_shape: Tuple[int, int, int],
                     mc: Tuple[int, int, int], C: int, ids=None,
                     group: int = 64):
    """Per grid block: the (C,) compacted candidate source-row indices
    (slots past the block's candidate count point at the sentinel row).
    Pure index arithmetic — no gathers — so XLA fuses it into a fast
    elementwise program. Returns (n_blocks, C) int32.

    ``ids`` (optional, (n_sel,) int32): evaluate only these flat block
    indices — the repair path reruns the kernel at a widened margin over
    just the blocks containing uncovered nodes."""
    bz, by, bx = block
    nz, ny, nx = grid_shape
    nbz, nby, nbx = (_block_counts(nz, bz), _block_counts(ny, by),
                     _block_counts(nx, bx))
    mcz, mcy, mcx = mc
    ncx, ncy, ncz = cells.dims
    x_ax, y_ax, z_ax = axes
    n_sent = cells.n_points            # first sentinel row index

    roz = jax.lax.broadcasted_iota(jnp.int32, (mcz, mcy), 0).ravel()
    roy = jax.lax.broadcasted_iota(jnp.int32, (mcz, mcy), 1).ravel()
    slots = jnp.arange(C, dtype=jnp.int32)

    def one_block(flat_idx):
        ibz = flat_idx // (nby * nbx)
        iby = (flat_idx // nbx) % nby
        ibx = flat_idx % nbx
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
        cnt = end - start                                     # (R,)

        offsets = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt)])    # (R+1,)
        # slot → source row: #(offsets[1:] <= slot) — R is small (~50), the
        # dense compare+sum beats a binary search
        row = jnp.sum((slots[:, None] >= offsets[None, 1:]).astype(jnp.int32),
                      axis=1)                                  # (C,)
        valid = slots < offsets[-1]
        g = start[row] + (slots - offsets[row])
        return jnp.where(valid, g, n_sent)   # sentinel row: coords 1e19

    if ids is None:
        ids = jnp.arange(nbz * nby * nbx, dtype=jnp.int32)
    n_blocks = ids.shape[0]
    # bound the (g, C, R) row-search intermediate per map step — a bare
    # vmap over every block would let a non-fused compare tensor reach GBs
    g = group
    while n_blocks % g:
        g //= 2
    out = jax.lax.map(jax.vmap(one_block), ids.reshape(-1, g))
    return out.reshape(n_blocks, C)


@jax.jit
def _build_pts8(points_sorted, values_sorted):
    """(N+pad, 8) candidate store [x,y,z,u,v,w,0,0], one 32-byte row per
    point so the panel gather reads whole rows. Sentinel rows carry 1e19
    coords (from ``points_sorted``'s padding) and zero values
    (``values_sorted``'s padding), so compaction needs no explicit
    validity channel."""
    V = values_sorted.shape[1]
    n = points_sorted.shape[0]
    z = jnp.zeros((n, 8 - 3 - V), jnp.float32)
    return jnp.concatenate([points_sorted, values_sorted, z], axis=1)


@jax.jit
def _panel_take(pts8, G):
    """One flat row gather, (N, 8) at (n_blocks·C,) → (8, n_blocks·C): the
    channel-major panel the kernel streams (each channel of a chunk is one
    contiguous load)."""
    return jnp.take(pts8, G.reshape(-1), axis=0).T


def _compact_gather(cells, values_sorted, axes, margin,
                    block: Tuple[int, int, int],
                    grid_shape: Tuple[int, int, int],
                    mc: Tuple[int, int, int], C: int, group: int = 64,
                    ids=None, pts8=None):
    """Candidate panel for the fused kernel: (8, n_blocks·C) channel-major,
    rows [x, y, z, u, v, w, 0, 0]; invalid slots hold far-sentinel coords
    and zero values. ``group`` bounds the (group, C, R) slot-search
    intermediate of the index stage."""
    if pts8 is None:
        pts8 = _build_pts8(cells.points_sorted, values_sorted)
    G = _compact_indices(cells, axes, margin, block, grid_shape, mc, C,
                         ids=ids, group=group)
    return _panel_take(pts8, G)


# ---------------------------------------------------------------------------
# Phase 2: streaming panel kernel (Pallas, Triton route)
# ---------------------------------------------------------------------------

def _chunk_d2(cand_ref, j, qx, qy, qz):
    """(tq, _CC) squared distances of the tile's queries to chunk ``j`` of
    the block's candidates. Every pass calls this one function, so every
    pass computes bit-identical d² — the τ mask below depends on that."""
    sl = pl.ds(j * _CC, _CC)
    dx = qx[:, None] - cand_ref[0, sl][None, :]
    dy = qy[:, None] - cand_ref[1, sl][None, :]
    dz = qz[:, None] - cand_ref[2, sl][None, :]
    return dx * dx + dy * dy + dz * dz


def _chunk_count(n_chunks: int, tq: int, pred):
    """(tq,) i32 count of ``pred(j) -> (tq, _CC) bool`` over all chunks.
    Counts accumulate elementwise and are reduced once per pass, not once
    per chunk."""
    def body(j, acc):
        return acc + pred(j).astype(jnp.int32)
    acc = jax.lax.fori_loop(0, n_chunks, body,
                            jnp.zeros((tq, _CC), jnp.int32))
    return jnp.sum(acc, axis=1)


def _bisect(count_le, need, lo, hi):
    """Bracket [lo, hi] (width (hi-lo)·2⁻²⁴) with ``count_le(lo) < need ≤
    count_le(hi)`` — the monotone-counting order statistic shared by the
    kNN and MAD kernels."""
    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        short = count_le(mid) < need
        return jnp.where(short, mid, lo), jnp.where(short, hi, mid)
    return jax.lax.fori_loop(0, _BISECT_ITERS, body, (lo, hi))


def _exact_kth(n_chunks: int, tq: int, d2_of, need: int, lo, hi):
    """The need-th smallest d² itself, from a bisection bracket.

    24 halvings leave [lo, hi] about one f32 spacing wide at the k-th
    distance, and when the (need+1)-th d² falls inside it too, ``hi``
    selects one candidate too many. One more pass counts the candidates
    at or below ``lo`` and finds the smallest d² above it: when exactly
    need-1 lie at or below ``lo``, that smallest value is the need-th.
    Otherwise (uncovered queries, exact ties) ``hi`` stands. The XLA form
    (``grid_knn._snap_kth``) applies the same rule."""
    def body(j, carry):
        c_lo, m = carry
        d2 = d2_of(j)
        above = d2 > lo[:, None]
        return (c_lo + (~above).astype(jnp.int32),
                jnp.minimum(m, jnp.where(above, d2, 3.4e38)))
    c_lo, m = jax.lax.fori_loop(
        0, n_chunks, body, (jnp.zeros((tq, _CC), jnp.int32),
                            jnp.full((tq, _CC), 3.4e38, jnp.float32)))
    c_lo = jnp.sum(c_lo, axis=1)
    m = jnp.min(m, axis=1)
    return jnp.where((c_lo == need - 1) & (m <= hi), m, hi)


def _fused_kernel(m2_ref, cand_ref, qx_ref, qy_ref, qz_ref, out_ref, *,
                  k, V, mode, power, n_chunks):
    qx = qx_ref[...]                                            # (tq,)
    qy = qy_ref[...]
    qz = qz_ref[...]
    tq = qx.shape[0]
    m2 = jnp.full((tq,), m2_ref[0], jnp.float32)

    def d2_of(j):
        return _chunk_d2(cand_ref, j, qx, qy, qz)

    def count_le(t):
        return _chunk_count(n_chunks, tq, lambda j: d2_of(j) <= t[:, None])

    # coverage sentinel: #candidates inside the margin ≥ k ⟺ the true k-th
    # distance ≤ margin (guaranteed-radius property) — identical to the XLA
    # path's sentinel
    covered = count_le(m2) >= k
    # exact τ by monotone counting: 24 halvings of [0, margin²] pin the
    # k-th distance to about one f32 spacing, one more pass snaps it
    lo, hi = _bisect(count_le, k, jnp.zeros((tq,), jnp.float32), m2)
    tau2 = _exact_kth(n_chunks, tq, d2_of, k, lo, hi)

    # the τ mask is evaluated in the SQUARED domain (sel = d² ≤ τ²), the
    # domain the bisection searched: the k-th neighbor's d² sits within an
    # ulp of τ² by construction, so re-deriving the mask through sqrt (not
    # correctly rounded on every device) can drop it
    def sel_d(j):
        d2 = d2_of(j)
        return d2 <= tau2[:, None], jnp.sqrt(jnp.maximum(d2, 0.0))

    if mode == "idw":
        def weight(sel, d):
            if power == 2.0:
                return jnp.where(sel, 1.0 / (d * d + _EPS), 0.0)
            return jnp.where(sel, 1.0 / (d ** power + _EPS), 0.0)
    else:
        # sibson (`interpolator.py:102-116`): masked mean/std/min of the
        # k-set distances, then inv-dist × shifted-exp smoothing
        def stats(j, carry):
            n_ok, s1, dmin = carry
            sel, d = sel_d(j)
            return (n_ok + jnp.sum(sel.astype(jnp.float32), axis=1),
                    s1 + jnp.sum(jnp.where(sel, d, 0.0), axis=1),
                    jnp.minimum(dmin, jnp.min(jnp.where(sel, d, 3.4e38),
                                              axis=1)))
        zeros = jnp.zeros((tq,), jnp.float32)
        n_ok, s1, dmin = jax.lax.fori_loop(
            0, n_chunks, stats,
            (zeros, zeros, jnp.full((tq,), 3.4e38, jnp.float32)))
        n_ok = jnp.maximum(n_ok, 1.0)
        mean = s1 / n_ok

        # two-pass masked ddof=0 variance, NOT E[d²]−E[d]²: the one-pass
        # form cancels (std/mean)² ≈ 1e-2 of the mantissa and the resulting
        # ~1e-5 std error leaks through exp(-(d-dmin)/std) into the weights
        def var_body(j, acc):
            sel, d = sel_d(j)
            dev = d - mean[:, None]
            return acc + jnp.sum(jnp.where(sel, dev * dev, 0.0), axis=1)
        std = jnp.sqrt(jax.lax.fori_loop(0, n_chunks, var_body, zeros)
                       / n_ok)
        dmin = jnp.where(dmin > 1e18, 0.0, dmin)

        def weight(sel, d):
            return jnp.where(
                sel, (1.0 / (d + _EPS))
                * jnp.exp(-(d - dmin[:, None]) / (std[:, None] + _EPS)), 0.0)

    def sums(j, carry):
        sel, d = sel_d(j)
        w = weight(sel, d)
        sl = pl.ds(j * _CC, _CC)
        return (carry[0] + jnp.sum(w, axis=1),) + tuple(
            carry[1 + c] + jnp.sum(w * cand_ref[3 + c, sl][None, :], axis=1)
            for c in range(V))

    acc = jax.lax.fori_loop(0, n_chunks, sums,
                            (jnp.zeros((tq,), jnp.float32),) * (V + 1))
    den = acc[0]
    inv_den = 1.0 / jnp.maximum(den, 1e-37)
    for c in range(V):
        out_ref[c, :] = acc[1 + c] * inv_den
    out_ref[V, :] = jnp.where(covered, den, 0.0)
    for c in range(V + 1, 8):
        out_ref[c, :] = jnp.zeros((tq,), jnp.float32)


@functools.partial(jax.jit, static_argnames=("block", "dims", "tq"))
def _build_queries(axes, block, dims, tq, ids=None):
    """Per-program query coordinates, (n_rows, tq) each for x/y/z: each
    block's queries in local (tz, ty, tx) order, cut into tiles of ``tq``.
    With ``ids`` (n_sel,), rows are built only for those flat block
    indices."""
    bz, by, bx = block
    nbz, nby, nbx = dims
    x_ax, y_ax, z_ax = axes
    if ids is not None:
        n_sel = ids.shape[0]
        ibz = ids // (nby * nbx)
        iby = (ids // nbx) % nby
        ibx = ids % nbx
        shape = (n_sel, bz, by, bx)
        qx = jnp.broadcast_to(
            x_ax[ibx[:, None] * bx + jnp.arange(bx)[None, :]]
            .reshape(n_sel, 1, 1, bx), shape)
        qy = jnp.broadcast_to(
            y_ax[iby[:, None] * by + jnp.arange(by)[None, :]]
            .reshape(n_sel, 1, by, 1), shape)
        qz = jnp.broadcast_to(
            z_ax[ibz[:, None] * bz + jnp.arange(bz)[None, :]]
            .reshape(n_sel, bz, 1, 1), shape)
    else:
        shape = (nbz, nby, nbx, bz, by, bx)
        qx = jnp.broadcast_to(x_ax.reshape(1, 1, nbx, 1, 1, bx), shape)
        qy = jnp.broadcast_to(y_ax.reshape(1, nby, 1, 1, by, 1), shape)
        qz = jnp.broadcast_to(z_ax.reshape(nbz, 1, 1, bz, 1, 1), shape)
    return qx.reshape(-1, tq), qy.reshape(-1, tq), qz.reshape(-1, tq)


@functools.partial(jax.jit, static_argnames=(
    "block", "k", "V", "C", "mode", "power", "interpret"))
def _fused_eval(m2, cand, qx_all, qy_all, qz_all, block, k, V, C,
                mode, power, interpret=False):
    """Phase 2 over every block of the candidate panel: returns
    (n_blocks, n_sub, 8, tq) rows [field_0..V-1, den, 0...] per query
    tile. ``m2``: (1,) margin²."""
    bz, by, bx = block
    tq = qx_all.shape[1]
    # blocks come from the candidate panel: subset (repair) evaluation
    # passes a panel holding only the uncovered blocks
    n_blocks = cand.shape[1] // C
    n_sub = bz * by * bx // tq

    kern = functools.partial(_fused_kernel, k=k, V=V, mode=mode, power=power,
                             n_chunks=C // _CC)
    q_spec = pl.BlockSpec((None, tq), lambda i, j: (i * n_sub + j, 0))
    return pl.pallas_call(
        kern,
        grid=(n_blocks, n_sub),
        in_specs=[
            pl.BlockSpec((1,), lambda i, j: (0,)),                 # m2
            pl.BlockSpec((8, C), lambda i, j: (0, i)),             # panel
            q_spec, q_spec, q_spec,
        ],
        out_specs=pl.BlockSpec((None, None, 8, tq),
                               lambda i, j: (i, j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n_blocks, n_sub, 8, tq), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="fused_grid_knn",
    )(m2, cand, qx_all, qy_all, qz_all)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("dims_c", "mcz", "mcy"))
def _block_tot_device(starts, x0, x1, base_y, base_z, dims_c,
                      mcz: int, mcy: int):
    """Device form of the per-block candidate-total table: same integral-
    image math as the numpy branch below, run where ``starts`` lives.
    Returns (nbz, nby, nbx) i32 totals (callers pull the ~64 KB table once
    instead of the full multi-MB ``starts``)."""
    ncx, ncy, ncz = dims_c
    counts = jnp.diff(starts).reshape(ncz * ncy, ncx)
    csum = jnp.concatenate(
        [jnp.zeros((ncz * ncy, 1), jnp.int32), jnp.cumsum(counts, axis=1)],
        axis=1)
    W = (jnp.take(csum, x1, axis=1) - jnp.take(csum, x0, axis=1))
    nbx = x0.shape[0]
    W = W.reshape(ncz, ncy, nbx)
    Wp = jnp.pad(W, ((mcz, mcz), (mcy, mcy), (0, 0)))
    cz_idx = jnp.clip(base_z[:, None] + jnp.arange(mcz)[None, :] + mcz,
                      0, ncz + 2 * mcz - 1)
    cy_idx = jnp.clip(base_y[:, None] + jnp.arange(mcy)[None, :] + mcy,
                      0, ncy + 2 * mcy - 1)
    T1 = Wp[cz_idx].sum(axis=1)                      # (nbz, ncy+2mcy, nbx)
    return T1[:, cy_idx, :].sum(axis=2)              # (nbz, nby, nbx)


def _block_total_capacity(cells, axes_np, margin: float,
                          block: Tuple[int, int, int],
                          grid_shape: Tuple[int, int, int],
                          mc: Tuple[int, int, int], ids=None) -> int:
    """Max total candidate count over all blocks (the static panel width C
    for the compacted store) — the compaction analogue of
    ``grid_knn._row_capacity``, summed over the block's candidate rows.
    With ``ids`` (flat block indices), the max is taken over that subset
    only (the repair path's widened-margin panels stay as narrow as the
    repair blocks allow)."""
    bz, by, bx = block
    nz, ny, nx = grid_shape
    nbz, nby, nbx = (_block_counts(nz, bz), _block_counts(ny, by),
                     _block_counts(nx, bx))
    mcz, mcy, mcx = mc
    ncx, ncy, ncz = cells.dims
    x_ax, y_ax, z_ax = axes_np
    from ptv_interpolation_tpu.ops.neighbors import cell_meta_np
    origin, inv = cell_meta_np(cells)
    inv = np.float32(inv)
    # the window base MUST be computed in f32 with the device kernel's
    # exact op order ((lo - margin) - origin) * inv: in f64 the floor can
    # land one cell off when the product sits within an f32 ulp of an
    # integer, under-sizing C and silently truncating candidates that
    # the coverage sentinel would never flag
    m32 = np.float32(margin)

    base_x = np.floor(((np.asarray(x_ax)[np.arange(nbx) * bx]
                        .astype(np.float32) - m32)
                       - origin[0]) * inv).astype(np.int64)
    base_y = np.floor(((np.asarray(y_ax)[np.arange(nby) * by]
                        .astype(np.float32) - m32)
                       - origin[1]) * inv).astype(np.int64)
    base_z = np.floor(((np.asarray(z_ax)[np.arange(nbz) * bz]
                        .astype(np.float32) - m32)
                       - origin[2]) * inv).astype(np.int64)
    x0 = np.clip(base_x, 0, ncx)
    x1 = np.clip(base_x + mcx, 0, ncx)

    if cells.starts_host is None:
        # device CSR build: integral image on device, pull the ~64 KB
        # per-block table instead of the full starts array
        tot = np.asarray(_block_tot_device(
            cells.starts, jnp.asarray(x0, jnp.int32),
            jnp.asarray(x1, jnp.int32), jnp.asarray(base_y, jnp.int32),
            jnp.asarray(base_z, jnp.int32), cells.dims, mcz, mcy))
        if ids is not None:
            tot = tot.reshape(-1)[np.asarray(ids, np.int64)]
        return int(tot.max()) if tot.size else 1

    starts_np = cells.starts_host.astype(np.int64)
    counts = np.diff(starts_np).reshape(ncz * ncy, ncx)
    csum = np.concatenate([np.zeros((ncz * ncy, 1), np.int64),
                           np.cumsum(counts, axis=1)], axis=1)

    W = (csum[:, x1] - csum[:, x0]).reshape(ncz, ncy, nbx)
    Wp = np.zeros((ncz + 2 * mcz, ncy + 2 * mcy, nbx), np.int64)
    Wp[mcz:mcz + ncz, mcy:mcy + ncy] = W
    cz_idx = np.clip(base_z[:, None] + np.arange(mcz)[None, :] + mcz,
                     0, ncz + 2 * mcz - 1)
    cy_idx = np.clip(base_y[:, None] + np.arange(mcy)[None, :] + mcy,
                     0, ncy + 2 * mcy - 1)
    T1 = Wp[cz_idx].sum(axis=1)                      # (nbz, ncy+2mcy, nbx)
    tot = T1[:, cy_idx, :].sum(axis=2)               # (nbz, nby, nbx)
    if ids is not None:
        tot = tot.reshape(-1)[np.asarray(ids, np.int64)]
    return int(tot.max()) if tot.size else 1


class FusedCapacityError(ValueError):
    """The compacted candidate panel would exceed ``max_panel`` (its
    device-memory footprint and the per-query pass cost both grow with C)
    — callers fall back to the streaming XLA path."""


def fused_grid_weighted_interpolate(points, values, grid: Grid, k: int,
                                    mode: str = "sibson", power: float = 2.0,
                                    block: Tuple[int, int, int] | None = None,
                                    margin_factor: float = 1.45,
                                    group: int = 8, skip_mask=None,
                                    max_panel: int = 8192,
                                    interpret: bool = False):
    """IDW/sibson onto ``grid`` via the fused two-phase kernel. Returns
    (nz, ny, nx, V) with uncovered nodes repaired exactly — same contract
    (and same escape hatches) as
    ``ops.grid_knn.grid_weighted_interpolate``."""
    from ptv_interpolation_tpu.ops.grid_knn import (
        _host_setup, repair_empty_nodes)

    if block is None:
        block = (4, 8, 16) if skip_mask is not None else (8, 8, 16)
    bz, by, bx = block
    tq = _query_tile(bz * by * bx)

    setup = _host_setup(points, values, grid, k, None, None, block,
                        margin_factor, cell_divisor=3.0)
    (cells, values_sorted, axes, margin, mc, _row_len, values_dev) = setup
    axes_np = tuple(np.asarray(a) for a in axes)

    C = _panel_width(_block_total_capacity(cells, axes_np, margin, block,
                                           grid.shape, mc))
    if C > max_panel:
        raise FusedCapacityError(
            f"compacted candidate panel {C} exceeds max_panel={max_panel}; "
            f"use the streaming XLA path")

    nz, ny, nx = grid.shape
    dims = (_block_counts(nz, bz), _block_counts(ny, by),
            _block_counts(nx, bx))
    V = int(np.shape(values)[1])

    cand = _compact_gather(cells, values_sorted, axes, jnp.float32(margin),
                           tuple(block), grid.shape, mc, C, group)
    m2 = jnp.asarray([margin * margin], jnp.float32)
    qx_all, qy_all, qz_all = _build_queries(axes, tuple(block), dims, tq)
    out = _fused_eval(m2, cand, qx_all, qy_all, qz_all, tuple(block),
                      int(k), V, C, mode, float(power),
                      interpret=bool(interpret))
    out = _reassemble(out, tuple(block), dims, grid.shape)
    field, den = out[..., :V], out[..., V]
    return repair_empty_nodes(field, den, points, values_dev, grid, k, mode,
                              power, cells=cells, margin=margin,
                              skip_mask=skip_mask, values_sorted=values_sorted,
                              block=tuple(block), interpret=interpret)


def fused_subset_weighted_sum(cells, values_sorted, axes, margin: float,
                              ids_np, k: int, block: Tuple[int, int, int],
                              grid_shape: Tuple[int, int, int],
                              mc: Tuple[int, int, int], mode: str,
                              power: float, V: int,
                              max_panel: int = 8192, group: int = 8,
                              interpret: bool = False):
    """Fused-kernel analogue of ``grid_knn._grid_block_weighted_sum_subset``:
    evaluate only the blocks in ``ids_np`` (host int array) at the given
    (typically widened) margin. Returns ``(n_sel, B, V+1)`` in ids order
    with the coverage-sentinel den channel, or ``None`` when the compacted
    panel would not fit (caller falls back to the streaming subset kernel).
    """
    bz, by, bx = block
    B = bz * by * bx
    axes_np = tuple(np.asarray(a) for a in axes)
    C = _panel_width(_block_total_capacity(cells, axes_np, margin, block,
                                           grid_shape, mc, ids=ids_np))
    if C > max_panel:
        return None
    nz, ny, nx = grid_shape
    dims = (_block_counts(nz, bz), _block_counts(ny, by),
            _block_counts(nx, bx))
    tq = _query_tile(B)
    g = group
    n_pad = (len(ids_np) + g - 1) // g * g
    ids_pad = np.concatenate(
        [ids_np, np.broadcast_to(ids_np[-1:], (n_pad - len(ids_np),))])
    ids_dev = jnp.asarray(ids_pad, jnp.int32)
    cand = _compact_gather(cells, values_sorted, axes, jnp.float32(margin),
                           tuple(block), grid_shape, mc, C, group,
                           ids=ids_dev)
    m2 = jnp.asarray([margin * margin], jnp.float32)
    qx, qy, qz = _build_queries(axes, tuple(block), dims, tq, ids=ids_dev)
    out = _fused_eval(m2, cand, qx, qy, qz, tuple(block), int(k), V, C,
                      mode, float(power), interpret=bool(interpret))
    return _block_rows(out, B)[:len(ids_np), :, :V + 1]


def _block_rows(out, B: int):
    """(n, n_sub, 8, tq) kernel output → (n, B, 8) rows in each block's
    local (tz, ty, tx) order (tile j holds local queries j·tq … j·tq+tq-1)."""
    n = out.shape[0]
    return out.transpose(0, 1, 3, 2).reshape(n, B, 8)


# ---------------------------------------------------------------------------
# Single-dispatch device repair
# ---------------------------------------------------------------------------

_NBLK_MAX = 4096


@functools.partial(jax.jit, static_argnames=("block", "dims", "nblk_max"))
def _repair_survey(den, skip, block, dims, nblk_max: int):
    """One device program for everything the repair driver must know before
    it can launch: ``[n_fix, n_bad, bad_block_ids...]`` as one (2+nblk_max,)
    int32 vector (ids padded with -1). One device-to-host pull replaces the
    legacy ladder's scalar-sum sync + nonzero + index pull."""
    den_eff = den if skip is None else jnp.where(skip, 1.0, den)
    bad = den_eff == 0.0
    n_fix = jnp.sum(bad, dtype=jnp.int32)
    bz, by, bx = block
    nbz, nby, nbx = dims
    nz, ny, nx = den.shape
    badp = jnp.pad(bad, ((0, nbz * bz - nz), (0, nby * by - ny),
                         (0, nbx * bx - nx)))
    blk_bad = badp.reshape(nbz, bz, nby, by, nbx, bx).any(axis=(1, 3, 5))
    n_bad = jnp.sum(blk_bad, dtype=jnp.int32)
    ids = jnp.nonzero(blk_bad.ravel(), size=nblk_max,
                      fill_value=-1)[0].astype(jnp.int32)
    return jnp.concatenate([jnp.stack([n_fix, n_bad]), ids])


@functools.partial(jax.jit, static_argnames=(
    "block", "dims", "tq", "k", "V", "C", "mode", "power", "grid_shape",
    "mc", "group", "interpret"))
def _fused_repair_apply(field, den, skip, cells, values_sorted, axes2,
                        margin2, ids_dev, n_bad, block, dims, tq, k: int,
                        V: int, C: int, mode: str, power: float, grid_shape,
                        mc, group: int = 8, interpret: bool = False):
    """The whole repair stage as ONE traced program: widened-margin panel
    gather + fused kernel eval + row pick + certification + scatter into
    the field. Returns (field', den', n_repaired)."""
    bz, by, bx = block
    nbz, nby, nbx = dims
    nz, ny, nx = grid_shape
    NBLK = ids_dev.shape[0]
    B = bz * by * bx
    den_eff = den if skip is None else jnp.where(skip, 1.0, den)

    pts8 = _build_pts8(cells.points_sorted, values_sorted)
    G = _compact_indices(cells, axes2, margin2, block, grid_shape, mc, C,
                         ids=ids_dev, group=group)
    cand = _panel_take(pts8, G)
    m2 = (margin2 * margin2).reshape(1).astype(jnp.float32)
    qx, qy, qz = _build_queries(axes2, block, dims, tq, ids=ids_dev)
    sub = _fused_eval(m2, cand, qx, qy, qz, block, k, V, C, mode, power,
                      interpret=interpret)
    rows = _block_rows(sub, B)                 # (NBLK, B, 8)
    vals_new = rows[..., :V]
    den2 = rows[..., V]

    ibz = ids_dev // (nby * nbx)
    iby = (ids_dev // nbx) % nby
    ibx = ids_dev % nbx
    tz = jnp.arange(bz, dtype=jnp.int32)
    ty = jnp.arange(by, dtype=jnp.int32)
    tx = jnp.arange(bx, dtype=jnp.int32)
    iz = (ibz[:, None, None, None] * bz + tz[None, :, None, None])
    iy = (iby[:, None, None, None] * by + ty[None, None, :, None])
    ix = (ibx[:, None, None, None] * bx + tx[None, None, None, :])
    in_grid = (iz < nz) & (iy < ny) & (ix < nx)
    flat = ((iz * ny + iy) * nx + ix).reshape(NBLK, B)
    in_grid = in_grid.reshape(NBLK, B)
    lane_ok = (jnp.arange(NBLK, dtype=jnp.int32) < n_bad)[:, None]

    n_total = nz * ny * nx
    flat_safe = jnp.clip(flat, 0, n_total - 1)
    den_at = den_eff.reshape(-1)[flat_safe]
    valid = lane_ok & in_grid & (den_at == 0.0) & (den2 > 0.0)
    # invalid rows (incl. padded lanes, which alias real blocks) are routed
    # out of range and dropped — surviving writes hit unique nodes
    idx = jnp.where(valid, flat, n_total).reshape(-1)
    field2 = field.reshape(-1, V).at[idx].set(
        vals_new.reshape(-1, V), mode="drop")
    den_out = den_eff.reshape(-1).at[idx].set(1.0, mode="drop")
    n_rep = jnp.sum(valid, dtype=jnp.int32)
    return (field2.reshape(grid_shape + (V,)), den_out.reshape(grid_shape),
            n_rep)


def fused_repair(field, den, skip_mask, cells, values_sorted, grid, k: int,
                 mode: str, power: float, block: Tuple[int, int, int],
                 margin: float, max_panel: int = 8192, group: int = 8,
                 interpret: bool = False):
    """Single-dispatch repair driver for the fused kernel path. Returns
    ``(field', den', n_left)`` — ``n_left`` nodes remain uncovered at the
    widened margin (``den'`` marks the repaired ones nonzero so the caller
    can brute-force only the rest) — or ``None`` when the fast path is
    ineligible (too many uncovered blocks for the survey, or a
    void-dominated cloud where per-block certification would fail anyway).
    Exactly two device syncs: the survey pull and the n_repaired pull —
    the panel eval, certification, and scatter live in one program."""
    nz, ny, nx = grid.shape
    bz, by, bx = block
    dims = (_block_counts(nz, bz), _block_counts(ny, by),
            _block_counts(nx, bx))
    skip = None if skip_mask is None else jnp.asarray(skip_mask, bool)
    survey = np.asarray(_repair_survey(den, skip, block, dims, _NBLK_MAX))
    n_fix, n_bad = int(survey[0]), int(survey[1])
    if n_fix == 0:
        return field, den, 0
    B = bz * by * bx
    if n_bad > _NBLK_MAX or n_bad * B > max(32 * n_fix, 64 * B):
        return None
    ids_np = survey[2:2 + n_bad].astype(np.int64)

    from ptv_interpolation_tpu.ops.grid_knn import _pad_axis
    from ptv_interpolation_tpu.ops.neighbors import cell_meta_np
    cell_size = 1.0 / cell_meta_np(cells)[1]
    margin2 = 1.6 * float(margin)
    dx, dy, dz = grid.spacing
    mc2 = tuple(int(math.ceil((ext + 2.0 * margin2) / cell_size)) + 1
                for ext in (bx * dx, by * dy, bz * dz))[::-1]
    axes2 = (_pad_axis(grid.x, bx), _pad_axis(grid.y, by),
             _pad_axis(grid.z, bz))
    axes2_np = tuple(np.asarray(a) for a in axes2)
    C = _panel_width(_block_total_capacity(cells, axes2_np, margin2, block,
                                           grid.shape, mc2, ids=ids_np))
    if C > max_panel:
        return None

    NBLK = 1 << max(n_bad - 1, 31).bit_length()
    ids_pad = np.concatenate(
        [ids_np, np.broadcast_to(ids_np[-1:], (NBLK - n_bad,))])
    ids_dev = jnp.asarray(ids_pad, jnp.int32)
    V = field.shape[-1]
    field2, den_out, n_rep = _fused_repair_apply(
        field, den, skip, cells, values_sorted, axes2, jnp.float32(margin2),
        ids_dev, jnp.asarray(n_bad, jnp.int32), tuple(block), dims,
        _query_tile(B), int(k), V, C, mode, float(power), grid.shape, mc2,
        group, interpret=interpret)
    n_left = n_fix - int(n_rep)
    return field2, den_out, n_left


@functools.partial(jax.jit, static_argnames=("block", "dims", "grid_shape"))
def _reassemble(out, block, dims, grid_shape):
    """(n_blocks, n_sub, 8, tq) → (nz, ny, nx, 8) node order."""
    bz, by, bx = block
    nbz, nby, nbx = dims
    nz, ny, nx = grid_shape
    o = _block_rows(out, bz * by * bx).reshape(nbz, nby, nbx, bz, by, bx, 8)
    o = o.transpose(0, 3, 1, 4, 2, 5, 6)
    o = o.reshape(nbz * bz, nby * by, nbx * bx, 8)
    return o[:nz, :ny, :nx]
