"""Local (k-nearest-neighbor) RBF interpolation.

Device equivalent of ``scipy.interpolate.RBFInterpolator(..., neighbors=k)``
(reference `/root/reference/interpolator.py:157-195`): for every evaluation
point, fit an RBF + polynomial model through its ``k`` nearest particles and
evaluate it there.

Where scipy groups evaluation points that share a neighbor set and solves
each group's system once on the CPU, here every query gets its own local
``(k+m)×(k+m)`` system and the systems are solved as one big *batched*
elimination — thousands of small dense solves in one program, with no
group bookkeeping or dynamic shapes. The two formulations agree wherever
the local
model is well-posed; the per-query fit is the textbook "moving RBF" method.

Conditioning: each local system is centered on the query and scaled by the
k-th neighbor distance before assembly, keeping f32 solves stable for
arbitrarily large coordinate magnitudes (scipy does a similar shift/scale
on its global system).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ptv_interpolation_tpu.ops.neighbors import (
    CellList,
    bruteforce_tile_fn,
    celllist_tile_fn,
    map_query_tiles,
)
from ptv_interpolation_tpu.ops.rbf_kernels import (
    MIN_DEGREE,
    SCALE_INVARIANT,
    kernel_value,
    n_poly_terms,
    polynomial_basis,
)


def _local_rbf_solve_tile(q_tile, sq, xi, fi, valid, k, kernel, smoothing,
                          epsilon, degree, m, n_ch):
    """Shared per-neighborhood RBF fit+evaluate used by both the tiled and
    the grid-block paths: center on query, scale by k-th distance, solve
    the (k+m)² saddle system batched, evaluate at the query."""
    # k-th *valid* distance (missing slots carry a 3.4e38 sentinel that
    # would collapse every valid offset to ~0 and wreck conditioning)
    sq_valid = jnp.where(valid, sq, 0.0)
    scale = jnp.sqrt(jnp.maximum(
        jnp.max(sq_valid, axis=-1), 1e-30))[:, None, None]
    xl = (xi - q_tile[:, None, :]) / scale                # (T, k, 3)

    r = jnp.sqrt(jnp.maximum(
        jnp.sum((xl[:, :, None, :] - xl[:, None, :, :]) ** 2, axis=-1),
        0.0))
    K = kernel_value(kernel, epsilon * r)                 # (T, k, k)
    lam = smoothing + 1e-6 * jnp.max(jnp.abs(K), axis=(1, 2), keepdims=True)
    K = K + lam * jnp.eye(k)
    vmat = valid[:, :, None] & valid[:, None, :]
    K = jnp.where(vmat, K, jnp.eye(k))

    P = polynomial_basis(xl, degree)                      # (T, k, m)
    P = jnp.where(valid[:, :, None], P, 0.0)

    A = jnp.concatenate([
        jnp.concatenate([K, P], axis=2),
        jnp.concatenate([jnp.swapaxes(P, 1, 2),
                         jnp.zeros((q_tile.shape[0], m, m))], axis=2),
    ], axis=1)                                            # (T, k+m, k+m)
    rhs = jnp.concatenate([
        jnp.where(valid[:, :, None], fi, 0.0),
        jnp.zeros((q_tile.shape[0], m, n_ch)),
    ], axis=1)                                            # (T, k+m, C)

    sol = jnp.linalg.solve(A, rhs)                        # batched LU
    c = sol[:, :k, :]
    d = sol[:, k:, :]

    rq = jnp.sqrt(jnp.maximum(sq_valid, 0.0)) / scale[:, :, 0]
    Kq = kernel_value(kernel, epsilon * rq)               # (T, k)
    Kq = jnp.where(valid, Kq, 0.0)
    hi = jax.lax.Precision.HIGHEST
    out = jnp.einsum("tk,tkc->tc", Kq, c, precision=hi)
    if m > 0:
        Pq = polynomial_basis(jnp.zeros_like(q_tile), degree)  # (T, m)
        out = out + jnp.einsum("tm,tmc->tc", Pq, d, precision=hi)
    return out


@functools.lru_cache(maxsize=32)
def _rbf_consume(k: int, kernel: str, smoothing: float, epsilon: float,
                 degree: int, n_ch: int):
    m = n_poly_terms(degree)

    def consume(sq, n_pos, n_val, ok, q):
        return _local_rbf_solve_tile(q, sq, n_pos, n_val, ok, k, kernel,
                                     smoothing, epsilon, degree, m, n_ch)
    return consume


def _index_consume(k: int, id_ch: int):
    """Selection-only consumer: per query, the squared distances and the
    *original point ids* of its k-set (ids ride in value channel
    ``id_ch``; invalid slots → -1). Output (B, 2k)."""
    def consume(sq, n_pos, n_val, ok, q):
        ids = jnp.where(ok, n_val[:, :, id_ch], -1.0)
        return jnp.concatenate([sq, ids], axis=1)
    return consume


def _poly_rows_t(xl, yl, zl, degree: int):
    """Monomial rows (m, k, T) on transposed (k, T) coords — same term
    order as :func:`polynomial_basis` ([1, x, y, z, x², xy, xz, y², yz,
    z²]), laid out batch-minor so nothing pads to the 128-lane tile."""
    one = jnp.ones_like(xl)
    rows = [one]
    if degree >= 1:
        rows += [xl, yl, zl]
    if degree >= 2:
        rows += [xl * xl, xl * yl, xl * zl, yl * yl, yl * zl, zl * zl]
    return jnp.stack(rows)


def _gauss_solve_t(A, rhs):
    """Batched dense solve in batch-minor layout: ``A`` (m, m, B),
    ``rhs`` (m, C, B) → (m, C, B). Gauss-Jordan with partial pivoting,
    vectorized over the lane (batch) axis.

    Full-reduction elimination is m·m·(m+C)·B fused elementwise
    multiplies with the batch on the fast axis — one fused program, no
    per-system library call — and partial pivoting keeps it stable on the
    saddle systems (the polynomial block has a zero diagonal, so
    pivot-free elimination would divide by ~λ≈1e-6·|K|)."""
    m = A.shape[0]
    M = jnp.concatenate([A, rhs], axis=1)            # (m, m+C, B)
    rows = jnp.arange(m)

    def step(i, M):
        col = jnp.abs(M[:, i, :])                    # (m, B)
        col = jnp.where(rows[:, None] < i, -1.0, col)
        p = jnp.argmax(col, axis=0)                  # (B,)
        onehot_p = rows[:, None] == p[None, :]       # (m, B)
        pivot_row = jnp.sum(jnp.where(onehot_p[:, None, :], M, 0.0),
                            axis=0)                  # (m+C, B)
        row_i = M[i]                                 # (m+C, B)
        M = jnp.where(onehot_p[:, None, :], row_i[None, :, :], M)
        M = M.at[i].set(pivot_row)
        row_norm = M[i] / M[i, i, :][None, :]        # (m+C, B)
        factors = M[:, i, :]                         # (m, B)
        elim = factors[:, None, :] * row_norm[None, :, :]
        M = M - jnp.where((rows == i)[:, None, None], 0.0, elim)
        M = M.at[i].set(row_norm)
        return M

    M = jax.lax.fori_loop(0, m, step, M)
    return M[:, m:, :]


@functools.partial(jax.jit, static_argnames=(
    "k", "kernel", "degree", "chunk", "n_ch"))
def _rbf_solve_flat(points, values, queries, sq, idx, k: int, kernel: str,
                    smoothing, epsilon, degree: int, n_ch: int,
                    chunk: int = 131072):
    """Stage 2 of the two-stage local RBF: given every query's k-set
    (``sq`` (Q, k) f32, ``idx`` (Q, k) int32, -1 = missing), fit and
    evaluate the local models as ONE flat batched computation.

    All small per-neighborhood tensors are laid out batch-minor
    ((k, T), (k, k, T), (m, k, T)): with the batch on the fastest axis
    every elementwise step is one wide, contiguous operation instead of
    many tiny (k, 3) / (k, k) ones. The (k+m)² systems are solved in the
    same batch-minor layout by :func:`_gauss_solve_t`."""
    m = n_poly_terms(degree)
    Q = queries.shape[0]
    n_pad = (Q + chunk - 1) // chunk * chunk
    pad = n_pad - Q
    queries = jnp.concatenate(
        [queries, jnp.zeros((pad, 3), jnp.float32)]) if pad else queries
    sq = jnp.concatenate(
        [sq, jnp.ones((pad, k), jnp.float32)]) if pad else sq
    idx = jnp.concatenate(
        [idx, jnp.zeros((pad, k), jnp.int32)]) if pad else idx
    # (8, N) transposed store [x, y, z, f₀.., 0]: neighbor data is pulled
    # with ONE flat lane-gather per chunk straight into (k, T) layout —
    # six separate (k, T) scalar gathers ran ~4× slower
    store8 = jnp.concatenate(
        [points.T, values.T,
         jnp.zeros((8 - 3 - n_ch, points.shape[0]), jnp.float32)], axis=0)
    eye_kk = jnp.eye(k, dtype=jnp.float32)[:, :, None]

    def do_chunk(args):
        q_c, sq_c, idx_c = args                     # (T,3) (T,k) (T,k)
        T = q_c.shape[0]
        validT = (idx_c >= 0).T                     # (k,T)
        safeT = jnp.clip(idx_c, 0, None).T          # (k,T)
        xi8 = jnp.take(store8, safeT.reshape(-1), axis=1).reshape(8, k, T)
        sqT = jnp.where(validT, sq_c.T, 0.0)        # (k,T) valid sq only
        scale = jnp.sqrt(jnp.maximum(jnp.max(sqT, axis=0), 1e-30))  # (T,)
        xl = (xi8[0] - q_c[:, 0][None, :]) / scale[None, :]         # (k,T)
        yl = (xi8[1] - q_c[:, 1][None, :]) / scale[None, :]
        zl = (xi8[2] - q_c[:, 2][None, :]) / scale[None, :]

        dx = xl[:, None, :] - xl[None, :, :]        # (k,k,T)
        dy = yl[:, None, :] - yl[None, :, :]
        dz = zl[:, None, :] - zl[None, :, :]
        r = jnp.sqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 0.0))
        K = kernel_value(kernel, epsilon * r)       # (k,k,T)
        lam = smoothing + 1e-6 * jnp.max(jnp.abs(K), axis=(0, 1))   # (T,)
        K = K + lam[None, None, :] * eye_kk
        vmat = validT[:, None, :] & validT[None, :, :]
        K = jnp.where(vmat, K, eye_kk)

        P = _poly_rows_t(xl, yl, zl, degree) if m else None  # (m,k,T)
        if m:
            P = jnp.where(validT[None, :, :], P, 0.0)
            top = jnp.concatenate(
                [K, jnp.transpose(P, (1, 0, 2))], axis=1)    # (k,k+m,T)
            bot = jnp.concatenate(
                [P, jnp.zeros((m, m, T), jnp.float32)], axis=1)
            A = jnp.concatenate([top, bot], axis=0)          # (k+m,k+m,T)
        else:
            A = K
        rhs_rows = []
        for c in range(n_ch):
            fcT = jnp.where(validT, xi8[3 + c], 0.0)           # (k,T)
            if m:
                fcT = jnp.concatenate(
                    [fcT, jnp.zeros((m, T), jnp.float32)], axis=0)
            rhs_rows.append(fcT)
        rhs = jnp.stack(rhs_rows, axis=1)                      # (k+m,C,T)

        sol = _gauss_solve_t(A, rhs)                           # (k+m,C,T)

        rqT = jnp.sqrt(jnp.maximum(sqT, 0.0)) / scale[None, :]  # (k,T)
        KqT = jnp.where(validT, kernel_value(kernel, epsilon * rqT), 0.0)
        out = jnp.sum(KqT[:, None, :] * sol[:k], axis=0)       # (C,T)
        if m:
            out = out + sol[k]         # polynomial at the (centered) query
        return out.T

    chunks = (queries.reshape(-1, chunk, 3), sq.reshape(-1, chunk, k),
              idx.reshape(-1, chunk, k))
    out = jax.lax.map(do_chunk, chunks)
    return out.reshape(n_pad, n_ch)[:Q]


def rbf_local_grid_interpolate(points, values, grid, k: int = 20,
                               kernel: str = "thin_plate_spline",
                               smoothing: float = 0.0, epsilon: float = 1.0,
                               degree: int | None = None, **kwargs):
    """Local kNN-RBF onto a :class:`Grid` — the at-scale path for
    scenario 3 (PERF.md), in two stages:

    1. the block-centric grid kernel selects each node's k-set (squared
       distances + original point ids riding in an extra value channel);
    2. :func:`_rbf_solve_flat` fits and evaluates every local model in
       one flat batch-minor computation.

    Running the fit inside the block kernel's consumer instead would
    build small (B, k, 3)/(B, k, k) intermediates per block; the
    two-stage form keeps the fit batch-minor."""
    import numpy as np

    from ptv_interpolation_tpu.ops.grid_knn import grid_knn_apply
    if degree is None:
        degree = max(MIN_DEGREE[kernel], 0)
    vals = np.asarray(values, np.float32)
    n_ch = int(vals.shape[1])
    n = vals.shape[0]
    if n >= (1 << 24):
        raise ValueError("two-stage local RBF carries point ids in an f32 "
                         "channel; point counts ≥ 2^24 are not supported")
    vals_aug = np.concatenate(
        [vals, np.arange(n, dtype=np.float32)[:, None]], axis=1)
    consume = _index_consume(int(k), n_ch)
    # flatter z-blocks keep the k≈20 selection panels narrow
    kwargs.setdefault("block", (4, 8, 16))
    out = grid_knn_apply(points, vals_aug, grid, k, consume, out_dim=2 * k,
                         needs_positions=False, **kwargs)
    Q = int(np.prod(grid.shape))
    flat = out.reshape(Q, 2 * k)
    sq = flat[:, :k]
    idx = flat[:, k:].astype(jnp.int32)
    pts_dev = jnp.asarray(np.asarray(points, np.float32))
    res = _rbf_solve_flat(pts_dev, jnp.asarray(vals), grid.flat_coords(),
                          sq, idx, int(k), kernel, float(smoothing),
                          float(epsilon), int(degree), n_ch)
    return res.reshape(grid.shape + (n_ch,))


def rbf_local_interpolate(points, values, queries, k: int = 20,
                          kernel: str = "thin_plate_spline",
                          smoothing: float = 0.0, epsilon: float = 1.0,
                          degree: int | None = None,
                          cells: CellList | None = None, rings: int = 1,
                          query_tile: int = 256, point_chunk: int = 4096,
                          progress=None):
    """Evaluate a k-neighbor local RBF model of ``values`` (N, C) at
    ``queries`` (Q, 3). Returns (Q, C).

    Parameters mirror the reference CLI: ``k`` = --rbf-neighbors,
    ``kernel`` = --rbf-kernel, ``smoothing`` = --smoothing
    (`main.py:34-36`). ``progress`` (a host callback ``fn(done, total)``)
    routes through host-level macro-batches instead of the one-shot jit.
    """
    if degree is None:
        # scipy default: the kernel's minimum degree, or 0 when unrestricted
        degree = max(MIN_DEGREE[kernel], 0)
    if progress is None:
        return _rbf_local_jit(points, values, queries, k, kernel, smoothing,
                              epsilon, degree, cells, rings, query_tile,
                              point_chunk)
    return _rbf_local_impl(points, values, queries, k, kernel, smoothing,
                           epsilon, degree, cells, rings, query_tile,
                           point_chunk, progress)


@functools.partial(jax.jit, static_argnames=(
    "k", "kernel", "degree", "rings", "query_tile", "point_chunk"))
def _rbf_local_jit(points, values, queries, k, kernel, smoothing, epsilon,
                   degree, cells, rings, query_tile, point_chunk):
    return _rbf_local_impl(points, values, queries, k, kernel, smoothing,
                           epsilon, degree, cells, rings, query_tile,
                           point_chunk, None)


def _rbf_local_impl(points, values, queries, k, kernel, smoothing, epsilon,
                    degree, cells, rings, query_tile, point_chunk, progress):
    points = jnp.asarray(points, jnp.float32)
    values = jnp.asarray(values, jnp.float32)
    m = n_poly_terms(degree)
    n_ch = values.shape[1]

    neighbor = (celllist_tile_fn(cells, k, rings) if cells is not None
                else bruteforce_tile_fn(points, k, point_chunk))

    def tile(q_tile):
        sq, idx = neighbor(q_tile)                        # (T, k)
        safe_idx = jnp.clip(idx, 0, None)
        xi = points[safe_idx]                             # (T, k, 3)
        fi = values[safe_idx]                             # (T, k, C)
        valid = idx >= 0
        return _local_rbf_solve_tile(q_tile, sq, xi, fi, valid, k, kernel,
                                     smoothing, epsilon, degree, m, n_ch)

    return map_query_tiles(tile, queries, query_tile, progress=progress)
