"""Delaunay-barycentric ("linear") interpolation — hybrid host/device.

The reference's default method delegates to ``scipy.interpolate.griddata``
(`/root/reference/interpolator.py:197`), whose 'linear' mode is Qhull
Delaunay + barycentric evaluation. Incremental triangulation and simplex
walking are irreducibly sequential/pointer-chasing, so that *topology* stage
stays on the host (scipy's compiled Qhull) — but it runs once per particle
set — while the *evaluation* (barycentric weights + vertex-value blend, the
O(Q) hot part) runs vectorized on device.

``fill_value=0.0`` outside the convex hull matches the reference call.
"""

from __future__ import annotations

import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np

# One-slot in-memory triangulation cache. Qhull dominates the `linear`
# wall (42.7 s of 50.5 s at 1M pts, `tools/measure_linear.py`) and the
# pipeline/scenario runs re-interpolate the SAME point cloud (per
# component, per run), so the triangulation is keyed by a content hash of
# the point array and rebuilt only when the cloud actually changes. One
# slot only: a 1M-point triangulation holds ~750 MB of simplices +
# transform blocks. Set PTV_TRI_CACHE_DIR to also persist across
# processes (CLI runs); entries there are pickles named by the same hash.
_TRI_CACHE: dict = {}


def _points_digest(pts: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(str(pts.shape).encode())
    h.update(np.ascontiguousarray(pts).data)
    return h.hexdigest()


def get_cached_triangulation(points, cache_dir: str | None = None):
    """Delaunay triangulation of ``points`` with content-hash caching.

    Memory hit → free; disk hit (``cache_dir`` or $PTV_TRI_CACHE_DIR) →
    unpickle (~seconds); miss → Qhull build (the 42.7 s stage), then cache.
    """
    from scipy.spatial import Delaunay, QhullError

    pts = np.asarray(points, np.float64)
    key = _points_digest(pts)
    if key in _TRI_CACHE:
        return _TRI_CACHE[key]
    cache_dir = cache_dir or os.environ.get("PTV_TRI_CACHE_DIR")
    path = os.path.join(cache_dir, f"tri_{key}.pkl") if cache_dir else None
    tri = None
    if path and os.path.exists(path):
        import pickle
        try:
            with open(path, "rb") as f:
                tri = pickle.load(f)
        except Exception:
            tri = None  # corrupt/stale cache entry: rebuild
    if tri is None:
        try:
            tri = Delaunay(pts)
        except QhullError as e:
            raise ValueError(f"Delaunay triangulation failed: {e}")
        tri.transform  # materialize lazy attrs while we own the build cost
        if path:
            import pickle
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(tri, f, protocol=4)
            os.replace(tmp, path)
    _TRI_CACHE.clear()  # one slot
    _TRI_CACHE[key] = tri
    return tri


@functools.partial(jax.jit, static_argnames=())
def _barycentric_eval(transform, simplices, values, queries, simplex_idx,
                      fill_value):
    """Device evaluation given host-found simplex ids.

    transform : (S, 4, 3) scipy Delaunay transform blocks (Tinv rows + r)
    simplices : (S, 4) vertex indices
    """
    safe = jnp.clip(simplex_idx, 0, None)
    Tinv = transform[safe, :3, :]              # (Q, 3, 3)
    r = transform[safe, 3, :]                  # (Q, 3)
    b = jnp.einsum("qij,qj->qi", Tinv, queries - r,
                   precision=jax.lax.Precision.HIGHEST)    # (Q, 3)
    w = jnp.concatenate([b, 1.0 - jnp.sum(b, axis=1, keepdims=True)], axis=1)
    verts = simplices[safe]                    # (Q, 4)
    vals = values[verts]                       # (Q, 4, C)
    out = jnp.einsum("qk,qkc->qc", w, vals,
                     precision=jax.lax.Precision.HIGHEST)
    inside = (simplex_idx >= 0)[:, None]
    return jnp.where(inside, out, fill_value)


def linear_interpolate(points, values, queries, fill_value: float = 0.0,
                       tri=None, query_chunk: int = 4_000_000,
                       cache_dir: str | None = None):
    """Piecewise-linear interpolation of ``values`` (N, C) at ``queries``.

    Pass a prebuilt ``scipy.spatial.Delaunay`` as ``tri`` to amortize the
    triangulation across calls (e.g. per-component or sharded evaluation),
    or ``cache_dir`` to persist triangulations across processes.
    ``query_chunk`` bounds the device gather intermediates — the one-shot
    ``transform[idx]`` gather is (Q, 3, 3) f32, 26 GB at 16.7M queries.
    """
    pts = np.asarray(points, np.float64)
    qrs = np.asarray(queries, np.float64)
    if tri is None:
        tri = get_cached_triangulation(pts, cache_dir=cache_dir)

    simplex_idx = tri.find_simplex(qrs).astype(np.int32)   # host walk (C)
    tr = jnp.asarray(tri.transform, jnp.float32)
    simp = jnp.asarray(tri.simplices, jnp.int32)
    vals = jnp.asarray(values, jnp.float32)
    fv = jnp.float32(fill_value)
    if len(qrs) <= query_chunk:
        return _barycentric_eval(tr, simp, vals, jnp.asarray(qrs, jnp.float32),
                                 jnp.asarray(simplex_idx), fv)
    parts = []
    for s in range(0, len(qrs), query_chunk):
        parts.append(np.asarray(_barycentric_eval(
            tr, simp, vals, jnp.asarray(qrs[s:s + query_chunk], jnp.float32),
            jnp.asarray(simplex_idx[s:s + query_chunk]), fv)))
    return jnp.asarray(np.concatenate(parts))


def linear_grid_interpolate(points, values, grid, fill_value: float = 0.0,
                            tri=None, pair_chunk: int = 4_000_000,
                            evaluator: str = "auto",
                            cache_dir: str | None = None):
    """Piecewise-linear (Delaunay) interpolation onto a regular grid —
    the reference's production method (`run_porous_glass.py:18` →
    `scipy.interpolate.griddata(method='linear')`,
    `/root/reference/interpolator.py:197`).

    Where the wall actually goes (measured at 1M pts → 256³,
    `tools/measure_linear.py`): Qhull triangulation 42.7 s, walk+evaluate
    7.8 s. The triangulation is the irreducible host stage — walks are
    nearly free on grid-ordered queries in scipy ≥1.13 (the C evaluator
    reuses the previous node's simplex as the walk seed). Three
    evaluators are provided:

    * ``'walk'`` — scipy's compiled walk+blend over the grid nodes, the
      fastest measured exact evaluator (7.8 s / 16.7M nodes). Default at
      scale.
    * ``'raster'`` — vectorized simplex rasterization (bbox candidate
      pairs + barycentric tests, host numpy). Loses to 'walk' at every
      measured size (88 s at 16.7M: ~2.3 tested pairs per covered node,
      but each pair costs a 9-term dot plus 4 comparisons in numpy);
      kept as an independent oracle for tests.
    * ``'auto'`` — 'walk'.

    The interpolant is identical in all cases: a node inside tet T gets
    ``Σ bary_k · values[T_k]`` ('walk' vs 'raster' parity 2.8e-8 rel-L2
    at the bench shape). Returns ``(nz, ny, nx, C)`` float32; nodes
    outside the convex hull get ``fill_value`` (the reference's
    ``fill_value=0.0`` contract).
    """
    pts = np.asarray(points, np.float64)
    vals = np.asarray(values, np.float64)
    if tri is None:
        tri = get_cached_triangulation(pts, cache_dir=cache_dir)

    if evaluator in ("auto", "walk"):
        from scipy.interpolate import LinearNDInterpolator
        x = np.asarray(grid.x, np.float64)
        y = np.asarray(grid.y, np.float64)
        z = np.asarray(grid.z, np.float64)
        ZZ, YY, XX = np.meshgrid(z, y, x, indexing="ij")
        q = np.stack([XX.ravel(), YY.ravel(), ZZ.ravel()], axis=-1)
        interp = LinearNDInterpolator(tri, vals, fill_value=float(fill_value))
        out = interp(q)
        return out.reshape(len(z), len(y), len(x),
                           vals.shape[1]).astype(np.float32)

    x = np.asarray(grid.x, np.float64)
    y = np.asarray(grid.y, np.float64)
    z = np.asarray(grid.z, np.float64)
    nx_, ny_, nz_ = len(x), len(y), len(z)
    dx = x[1] - x[0] if nx_ > 1 else 1.0
    dy = y[1] - y[0] if ny_ > 1 else 1.0
    dz = z[1] - z[0] if nz_ > 1 else 1.0

    simp = tri.simplices                       # (S, 4)
    Tf = tri.transform                         # (S, 4, 3)
    ok_t = np.isfinite(Tf[:, 0, 0])            # degenerate tets excluded
    vert = pts[simp]                           # (S, 4, 3)
    lo = vert.min(axis=1)                      # (S, 3) x,y,z
    hi = vert.max(axis=1)

    # grid-index bbox per tet (clipped; empty boxes drop out via cnt=0)
    ix0 = np.maximum(np.ceil((lo[:, 0] - x[0]) / dx), 0).astype(np.int64)
    iy0 = np.maximum(np.ceil((lo[:, 1] - y[0]) / dy), 0).astype(np.int64)
    iz0 = np.maximum(np.ceil((lo[:, 2] - z[0]) / dz), 0).astype(np.int64)
    ix1 = np.minimum(np.floor((hi[:, 0] - x[0]) / dx), nx_ - 1).astype(np.int64)
    iy1 = np.minimum(np.floor((hi[:, 1] - y[0]) / dy), ny_ - 1).astype(np.int64)
    iz1 = np.minimum(np.floor((hi[:, 2] - z[0]) / dz), nz_ - 1).astype(np.int64)
    sx = np.maximum(ix1 - ix0 + 1, 0)
    sy = np.maximum(iy1 - iy0 + 1, 0)
    sz = np.maximum(iz1 - iz0 + 1, 0)
    cnt = np.where(ok_t, sx * sy * sz, 0)

    C = vals.shape[1]
    out = np.full((nz_ * ny_ * nx_, C), float(fill_value), np.float64)

    # chunk boundaries so each expansion holds ≤ pair_chunk (tet, node) pairs
    csum = np.concatenate([[0], np.cumsum(cnt)])
    total = int(csum[-1])
    bounds = [0]
    while csum[bounds[-1]] < total:
        nxt = int(np.searchsorted(csum, csum[bounds[-1]] + pair_chunk,
                                  side="right") - 1)
        bounds.append(max(nxt, bounds[-1] + 1))
    Tinv_flat = Tf[:, :3, :].reshape(-1, 9)
    r_off = Tf[:, 3, :]

    for s, e in zip(bounds[:-1], bounds[1:]):
        c = cnt[s:e]
        n_pairs = int(csum[e] - csum[s])
        if n_pairs == 0:
            continue
        tid = np.repeat(np.arange(s, e), c)
        off = np.arange(n_pairs) - np.repeat(csum[s:e] - csum[s], c)
        sxt = sx[tid]
        ox = off % sxt
        rem = off // sxt
        oy = rem % sy[tid]
        oz = rem // sy[tid]
        gx = ix0[tid] + ox
        gy = iy0[tid] + oy
        gz = iz0[tid] + oz
        qx = x[gx] - r_off[tid, 0]
        qy = y[gy] - r_off[tid, 1]
        qz = z[gz] - r_off[tid, 2]
        Ti = Tinv_flat[tid]
        b0 = Ti[:, 0] * qx + Ti[:, 1] * qy + Ti[:, 2] * qz
        b1 = Ti[:, 3] * qx + Ti[:, 4] * qy + Ti[:, 5] * qz
        b2 = Ti[:, 6] * qx + Ti[:, 7] * qy + Ti[:, 8] * qz
        b3 = 1.0 - b0 - b1 - b2
        eps = -1e-10
        inside = (b0 >= eps) & (b1 >= eps) & (b2 >= eps) & (b3 >= eps)
        if not inside.any():
            continue
        tid = tid[inside]
        flat = (gz[inside] * ny_ + gy[inside]) * nx_ + gx[inside]
        w = np.stack([b0[inside], b1[inside], b2[inside], b3[inside]],
                     axis=1)                                   # (P, 4)
        # (P, C) accumulation; overlapping nodes (shared faces) agree
        out[flat] = np.einsum("pk,pkc->pc", w, vals[simp[tid]])

    return out.reshape(nz_, ny_, nx_, C).astype(np.float32)
