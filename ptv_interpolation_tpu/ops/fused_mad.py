"""Fused panel-based kNN-MAD outlier filter — order statistics by
counting bisection, no sort, no per-query gathers.

The reference filter (`/root/reference/filtering.py:5-58`) KDTree-queries
each point's k+1 nearest (self included), then takes the median and MAD
of the k neighbor *speeds*. A selection-based port pays for a top-k
selection plus neighbor gathers per point. But every statistic the filter
needs is an order statistic, and order statistics are monotone-counting
problems, the same shape as the interpolation kernel's exact-τ selection:

* the (k+1)-th distance τ      = bisect t: #{d² ≤ t} ≥ k+1
* the j-th smallest speed      = bisect t: #{s ≤ t, d² ≤ τ²} − [s₀ ≤ t] ≥ j
* the j-th smallest |s − med|  = same, on the shifted speeds

(`s₀` is the query's own speed — subtracting its indicator drops exactly
one self-copy, which also handles coincident points the way the
reference's `idx[:, 1:]` does.) So the whole filter runs per spatial
block over one compacted candidate panel: ~120 counting passes, each
streaming the block's candidates (x, y, z, s: 16 B each) and recomputing
d² and the selection ``d² ≤ τ²`` on the fly, decisions in one kernel
(the chunked counting loop is shared with ``ops/fused_grid_knn.py``).

Median semantics match ``np.median`` on k values: the mean of the
⌈k/2⌉-th and (⌊k/2⌋+1)-th order statistics (equal when k is odd), each
pinned to ``range · 2⁻²⁴`` by 24 halvings.

Queries are the points themselves, bucketed into margin-sized spatial
blocks on the host exactly like ``grid_knn.scatter_knn_apply``; each
occupied block shares one compacted candidate gather (the flat row
gather of ``fused_grid_knn``).
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

from ptv_interpolation_tpu.ops.fused_grid_knn import (
    _BISECT_ITERS, _CC, _NUM_WARPS, _TQ, _bisect, _chunk_count, _chunk_d2,
    _exact_kth, _panel_width)
from ptv_interpolation_tpu.ops.neighbors import build_cell_list


@functools.partial(jax.jit, static_argnames=("mc", "C", "group"))
def _compact_indices_scatter(cells, lo_blocks, margin,
                             mc: Tuple[int, int, int], C: int,
                             group: int = 64):
    """Scatter-block analogue of ``fused_grid_knn._compact_indices``:
    block lows come from an (n_blocks, 3) array instead of grid axes.
    Returns (n_blocks, C) int32 source rows (sentinel row for empty
    slots)."""
    mcz, mcy, mcx = mc
    ncx, ncy, ncz = cells.dims
    n_sent = cells.n_points            # first sentinel row index

    roz = jax.lax.broadcasted_iota(jnp.int32, (mcz, mcy), 0).ravel()
    roy = jax.lax.broadcasted_iota(jnp.int32, (mcz, mcy), 1).ravel()
    slots = jnp.arange(C, dtype=jnp.int32)

    def one_block(lo):
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
        offsets = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt)])
        row = jnp.sum((slots[:, None] >= offsets[None, 1:]).astype(jnp.int32),
                      axis=1)
        valid = slots < offsets[-1]
        g = start[row] + (slots - offsets[row])
        return jnp.where(valid, g, n_sent)

    n_blocks = lo_blocks.shape[0]
    g = group
    while n_blocks % g:
        g //= 2
    out = jax.lax.map(jax.vmap(one_block), lo_blocks.reshape(-1, g, 3))
    return out.reshape(n_blocks, C)


def _mad_kernel(m2_ref, cand_ref, qx_ref, qy_ref, qz_ref, qs_ref, out_ref,
                *, k, threshold, n_chunks):
    qx = qx_ref[...]                                     # (tq,)
    qy = qy_ref[...]
    qz = qz_ref[...]
    own = qs_ref[...]                                    # own speeds
    tq = qx.shape[0]
    m2 = jnp.full((tq,), m2_ref[0], jnp.float32)

    def d2_of(j):
        return _chunk_d2(cand_ref, j, qx, qy, qz)

    def speeds(j):
        return cand_ref[3, pl.ds(j * _CC, _CC)][None, :]

    def count(pred):
        return _chunk_count(n_chunks, tq, pred)

    zeros = jnp.zeros((tq,), jnp.float32)
    # selection incl. self: k+1 neighbors
    covered = count(lambda j: d2_of(j) <= m2[:, None]) >= k + 1
    lo, hi = _bisect(lambda t: count(lambda j: d2_of(j) <= t[:, None]),
                     k + 1, zeros, m2)
    tau2 = _exact_kth(n_chunks, tq, d2_of, k + 1, lo, hi)

    def sel(j):                                          # k+1 set incl self
        return d2_of(j) <= tau2[:, None]

    # Per-query bisection bound: the largest *selected* candidate speed.
    # The query itself is in its own selection (d²=0), so own ≤ smax_q, and
    # every order statistic counted below — neighbor speeds s and
    # deviations |s − med| with 0 ≤ med ≤ smax_q — is ≤ smax_q. A global
    # bound (`float(s.max()) + 1`) would let one extreme outlier — the very
    # thing this filter removes — degrade the bisection resolution
    # (range·2⁻²⁴) of EVERY point's median/MAD.
    smax_q = jax.lax.fori_loop(
        0, n_chunks,
        lambda j, m: jnp.maximum(
            m, jnp.max(jnp.where(sel(j), speeds(j), 0.0), axis=1)),
        zeros)

    def order_stat(vals_own, j_stat, shifted=None):
        """j-th smallest (1-indexed) of the selected neighbor values, self
        excluded by indicator subtraction. ``vals_own`` is the query's own
        value on the counted axis (own speed, or |own − med| when
        ``shifted=med`` counts |s − med| values)."""
        def count_le(t):
            if shifted is None:
                def pred(j):
                    return sel(j) & (speeds(j) <= t[:, None])
            else:
                def pred(j):
                    return sel(j) & (jnp.abs(speeds(j) - shifted[:, None])
                                     <= t[:, None])
            return count(pred) - (vals_own <= t).astype(jnp.int32)
        return _bisect(count_le, j_stat, zeros, smax_q)[1]

    jlo = (k + 1) // 2
    jhi = k // 2 + 1

    # odd k: the two middle order statistics coincide — one bisection
    # (24 counting passes) instead of two
    def middle_pair(vals_own, shifted=None):
        t_lo = order_stat(vals_own, jlo, shifted)
        if jlo == jhi:
            return t_lo
        return 0.5 * (t_lo + order_stat(vals_own, jhi, shifted))

    med = middle_pair(own)
    own_dev = jnp.abs(own - med)
    mad = middle_pair(own_dev, shifted=med)

    thr = jnp.float32(threshold)
    keep = own_dev <= thr * (mad + 1e-6)

    # Decisions whose margin is within the bisection error bound are
    # *uncertain*, not wrong — mark them uncovered so the caller re-decides
    # exactly. Error budget: med and own_dev carry ≤ r = smax_q·2⁻²⁴ each,
    # mad ≤ 2r (its counted axis is shifted by the computed med), so the
    # compare `own_dev ≤ thr·(mad+1e-6)` is certain outside
    # (1 + 2·thr)·r — bounded by 4(1+thr)·r for margin. This is what makes
    # one extreme-speed outlier (exactly what the filter removes) unable to
    # silently flip its neighbors' near-threshold decisions: those panels
    # see smax_q ≈ the outlier speed, r blows up, and they fall back to the
    # exact path instead of absorbing the error.
    r = smax_q * jnp.float32(2.0 ** -_BISECT_ITERS)
    delta = 4.0 * (1.0 + thr) * r
    certain = jnp.abs(own_dev - thr * (mad + 1e-6)) > delta
    covered = covered & certain

    # row 0: keep + 2·covered packed (one cheap pull decodes both);
    # row 1: k-th distance, +inf on padding slots so an on-device sort
    # puts them last and the first n entries are the real values
    out_ref[0, :] = (keep.astype(jnp.float32)
                     + 2.0 * covered.astype(jnp.float32))
    out_ref[1, :] = jnp.where(qx >= 1e18, jnp.float32(jnp.inf),
                              jnp.sqrt(tau2))
    out_ref[2, :] = med
    out_ref[3, :] = mad


@functools.partial(jax.jit, static_argnames=("k", "threshold", "C",
                                             "interpret"))
def _mad_eval(m2, cand, qx, qy, qz, qs, k: int, threshold: float, C: int,
              interpret: bool = False):
    """Kernel over every occupied block: ``q*`` are (n_blocks, Bt) padded
    query rows, Bt a multiple of the query tile. Returns (n_blocks, 4, Bt)
    rows [keep + 2·covered, k-th distance, median, MAD]."""
    n_blocks, Bt = qx.shape
    tq = min(Bt, _TQ)
    n_sub = Bt // tq
    kern = functools.partial(_mad_kernel, k=k, threshold=threshold,
                             n_chunks=C // _CC)
    q_spec = pl.BlockSpec((None, tq), lambda i, j: (i, j))
    return pl.pallas_call(
        kern,
        grid=(n_blocks, n_sub),
        in_specs=[
            pl.BlockSpec((1,), lambda i, j: (0,)),            # m2
            pl.BlockSpec((8, C), lambda i, j: (0, i)),        # panel
            q_spec, q_spec, q_spec, q_spec,
        ],
        out_specs=pl.BlockSpec((None, 4, tq), lambda i, j: (i, 0, j)),
        out_shape=jax.ShapeDtypeStruct((n_blocks, 4, Bt), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="fused_mad",
    )(m2, cand, qx, qy, qz, qs)


@functools.partial(jax.jit, static_argnames=("n",))
def _post(out, n: int):
    """Device post-pass: pack the pull to one uint8 plane and reduce the
    k-th-distance diagnostic to its median on device (np.median semantics:
    mean of the two middle order statistics; padding slots are +inf so the
    first ``n`` sorted entries are exactly the real points)."""
    packed = out[:, 0, :].reshape(-1).astype(jnp.uint8)
    kth = out[:, 1, :].reshape(-1)
    ks = jnp.sort(kth)
    radius = 0.5 * (ks[(n - 1) // 2] + ks[n // 2])
    return packed, radius, kth


@jax.jit
def _build_store(points_sorted, speed_sorted):
    """(N+pad, 8) candidate store [x, y, z, speed, 0...], one 32-byte row
    per point."""
    n = points_sorted.shape[0]
    z = jnp.zeros((n, 4), jnp.float32)
    return jnp.concatenate(
        [points_sorted, speed_sorted[:, None], z], axis=1)


@jax.jit
def _gather_queries(qrs_pad, speed_pad, q_table):
    """Per-block padded query rows: (n_blocks, Bt) × {x, y, z, s}."""
    q = qrs_pad[q_table]                                  # (nb, Bt, 3)
    s = speed_pad[q_table]                                # (nb, Bt)
    return q[:, :, 0], q[:, :, 1], q[:, :, 2], s


def _lattice_capacity(cells, q_lo, edge, dims, uniq, margin, mc):
    """Max compacted candidate count over the occupied scatter blocks —
    numpy, from the host-side CSR starts (the scatter analogue of
    ``fused_grid_knn._block_total_capacity``)."""
    mcz, mcy, mcx = mc
    ncx, ncy, ncz = cells.dims
    from ptv_interpolation_tpu.ops.neighbors import cell_meta_np
    origin, inv = cell_meta_np(cells)
    inv = np.float32(inv)
    m32 = np.float32(margin)
    starts_np = (cells.starts_host if cells.starts_host is not None
                 else np.asarray(cells.starts)).astype(np.int64)
    counts = np.diff(starts_np).reshape(ncz * ncy, ncx)
    csum = np.concatenate([np.zeros((ncz * ncy, 1), np.int64),
                           np.cumsum(counts, axis=1)], axis=1)

    # f32 with the device kernel's exact op order — see
    # fused_grid_knn._block_total_capacity for why; ``lows`` must be the
    # same f32 values the driver pushes to the kernel as ``lo_blocks``
    # (q_lo + idx·edge, all f32)
    lows = [np.float32(q_lo[d])
            + np.arange(dims[d], dtype=np.float32) * np.float32(edge)
            for d in range(3)]
    base = [np.floor(((lows[d] - m32) - origin[d]) * inv).astype(np.int64)
            for d in range(3)]
    x0 = np.clip(base[0], 0, ncx)
    x1 = np.clip(base[0] + mcx, 0, ncx)
    W = (csum[:, x1] - csum[:, x0]).reshape(ncz, ncy, dims[0])
    Wp = np.zeros((ncz + 2 * mcz, ncy + 2 * mcy, dims[0]), np.int64)
    Wp[mcz:mcz + ncz, mcy:mcy + ncy] = W
    cz_idx = np.clip(base[2][:, None] + np.arange(mcz)[None, :] + mcz,
                     0, ncz + 2 * mcz - 1)
    cy_idx = np.clip(base[1][:, None] + np.arange(mcy)[None, :] + mcy,
                     0, ncy + 2 * mcy - 1)
    T1 = Wp[cz_idx].sum(axis=1)                  # (nbz, ncy+2mcy, nbx)
    tot = T1[:, cy_idx, :].sum(axis=2)           # (nbz, nby, nbx)
    # occupied blocks: uniq are flat ids (iz*dims1 + iy)*dims0 + ix
    uz = uniq // (dims[1] * dims[0])
    uy = (uniq // dims[0]) % dims[1]
    ux = uniq % dims[0]
    sel = tot[uz, uy, ux]
    return int(sel.max()) if sel.size else 1


def fused_mad_filter(points, speeds, k: int, threshold: float,
                     margin_factor: float = 1.9, max_panel: int = 8192,
                     max_bt: int = 4096, interpret: bool = False,
                     want_kth: bool = False):
    """Keep/radius decisions of the kNN-MAD filter via the fused panel
    kernel. Returns ``(keep, covered, radius, kth)`` — keep/covered numpy
    bool arrays in point order, ``radius`` the median k-th-neighbor
    distance (computed on device; the reference's diagnostic,
    `filtering.py:33-35`), and ``kth`` per-point k-th distances (numpy,
    only when ``want_kth``; ``None`` otherwise — production only needs
    the median). Returns ``None`` when the cloud's density pushes the
    panel width past ``max_panel`` or a block's population past
    ``max_bt`` (callers fall back to the selection-based scatter path).

    ``margin_factor`` = 1.9 covers domain-*edge* neighborhoods (a corner
    octant's k-th radius is ~2× the bulk's); the residual uncovered
    fraction (extreme corners, density holes) is flagged in ``covered``
    for the caller to re-decide exactly.
    """
    pts = np.asarray(points, np.float32)
    s = np.asarray(speeds, np.float32).ravel()
    n = pts.shape[0]

    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    density = n / float(np.prod(extent))
    r_k = (3.0 * (k + 1) / (4.0 * math.pi * density)) ** (1.0 / 3.0)
    margin = r_k * margin_factor
    cell_size = max(margin / 3.0, 1e-6)
    cells = build_cell_list(pts, cell_size=cell_size, build_table=False)

    edge = 2.0 * margin
    dims = np.maximum(np.ceil(extent / edge).astype(int), 1)
    bidx = np.clip(((pts - lo) / edge).astype(np.int64), 0, dims - 1)
    bid = (bidx[:, 2] * dims[1] + bidx[:, 1]) * dims[0] + bidx[:, 0]
    order = np.argsort(bid, kind="stable")
    sorted_bid = bid[order]
    uniq, inv_start = np.unique(sorted_bid, return_index=True)
    counts = np.diff(np.append(inv_start, len(sorted_bid)))
    b_cap = int(counts.max())
    # whole query tiles per block (a power-of-two tile, or one tile of the
    # next power of two when the block is smaller than a tile)
    Bt = ((b_cap + _TQ - 1) // _TQ * _TQ if b_cap > _TQ
          else 1 << max(b_cap - 1, 0).bit_length())
    if Bt > max_bt:
        return None
    n_blocks = len(uniq)
    q_table = np.full((n_blocks, Bt), n, np.int64)
    rank = np.arange(len(sorted_bid)) - np.repeat(inv_start, counts)
    q_table[np.repeat(np.arange(n_blocks), counts), rank] = order

    mc = tuple(int(math.ceil((edge + 2.0 * margin) / cell_size)) + 1
               for _ in range(3))
    C = _panel_width(_lattice_capacity(cells, lo, edge, dims, uniq, margin,
                                       mc))
    if C > max_panel:
        return None

    uz = uniq // (dims[1] * dims[0])
    uy = (uniq // dims[0]) % dims[1]
    ux = uniq % dims[0]
    # f32 arithmetic, matching _lattice_capacity's lattice lows bit-wise
    lo_blocks = (lo[None, :].astype(np.float32)
                 + np.stack([ux, uy, uz], axis=-1).astype(np.float32)
                 * np.float32(edge))

    speed_sorted = jnp.concatenate(
        [jnp.asarray(s)[cells.order], jnp.zeros((1024,), jnp.float32)])
    store = _build_store(cells.points_sorted, speed_sorted)
    G = _compact_indices_scatter(cells, jnp.asarray(lo_blocks),
                                 jnp.float32(margin), mc, C)
    cand = jnp.take(store, G.reshape(-1), axis=0).T        # (8, nb·C)

    qrs_pad = jnp.asarray(np.concatenate(
        [pts, np.full((1, 3), 1e19, np.float32)]))
    speed_pad = jnp.asarray(np.concatenate([s, np.zeros(1, np.float32)]))
    qx, qy, qz, qs = _gather_queries(qrs_pad, speed_pad,
                                     jnp.asarray(q_table, jnp.int32))

    m2 = jnp.asarray([margin * margin], jnp.float32)
    out = _mad_eval(m2, cand, qx, qy, qz, qs, int(k), float(threshold), C,
                    interpret=bool(interpret))
    packed_dev, radius_dev, kth_dev = _post(out, n)
    packed = np.asarray(packed_dev)      # 1 byte/slot: keep | covered<<1

    keep = np.ones(n, bool)
    covered = np.zeros(n, bool)
    flat_idx = q_table.reshape(-1)
    valid = flat_idx < n
    keep[flat_idx[valid]] = (packed & 1)[valid] > 0
    covered[flat_idx[valid]] = (packed & 2)[valid] > 0
    kth = None
    if want_kth:
        kth = np.zeros(n, np.float32)
        kth[flat_idx[valid]] = np.asarray(kth_dev)[valid]
    return keep, covered, float(radius_dev), kth
