"""Global RBF at scale: matrix-free projected PCG (no O(N²) storage).

Device equivalent of ``scipy.interpolate.RBFInterpolator`` with
``neighbors=None`` (`/root/reference/interpolator.py:162-167`) beyond the
dense-Cholesky capacity of :mod:`rbf_global` (N ≲ 3·10⁴). The full kernel
matrix is never materialized: each CG matvec streams tiled ``(T, N)``
kernel panels, so memory is O(N·T) and the N ~ 10⁵ regime fits a single
device.

Solver design
-------------
scipy's sign conventions make the kernel matrix K conditionally positive
definite together with the minimum polynomial tail P (see
``ops/rbf_kernels.py``): vᵀKv > 0 whenever Pᵀv = 0. The saddle system

    [K + λI  P] [c]   [f]
    [Pᵀ      0] [d] = [0]

is therefore solved by **projected PCG** on the constraint subspace
{c : Pᵀc = 0}: with P = QR (reduced QR), the projector Π = I − QQᵀ gives
the SPD-on-subspace operator Π(K + λI)Π, CG converges to the exact c, and
the polynomial coefficients follow from the triangular solve
R d = Qᵀ(f − (K + λI)c). Pure-PD kernels with ``degree=-1`` skip the
projection (plain PCG).

Preconditioner: **block-Jacobi over Morton-ordered points** — points are
sorted along a Z-order curve so consecutive blocks are spatially coherent,
each (B, B) diagonal block of K + λI is Cholesky-factored batched (one
vmapped factorization), and the preconditioner solve is a batched
``cho_solve``. This is the classical domain-decomposition preconditioner
for RBF systems and typically cuts iteration counts by ~an order of
magnitude on clustered clouds.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ptv_interpolation_tpu.interpolate.rbf_global import GlobalRBF
from ptv_interpolation_tpu.ops.rbf_kernels import (
    MIN_DEGREE,
    kernel_value,
    n_poly_terms,
    polynomial_basis,
)


def _morton_order(pts: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-order (Morton) sort permutation of (N, 3) points — host-side."""
    lo = pts.min(axis=0)
    extent = np.maximum(pts.max(axis=0) - lo, 1e-12)
    q = ((pts - lo) / extent * (2 ** bits - 1)).astype(np.uint64)
    code = np.zeros(len(pts), np.uint64)
    for b in range(bits):
        for axis in range(3):
            code |= ((q[:, axis] >> np.uint64(b)) & np.uint64(1)) \
                << np.uint64(3 * b + axis)
    return np.argsort(code, kind="stable")


@functools.partial(jax.jit, static_argnames=(
    "kernel", "epsilon", "degree", "row_tile", "block", "maxiter", "tol"))
def _pcg_solve(xs, f, valid, Q, pre_chol, kernel: str, epsilon: float,
               degree: int, smoothing, row_tile: int, block: int,
               maxiter: int, tol: float):
    """Projected PCG on Π(K+λI)Π c = Πf. All shapes padded to multiples of
    ``row_tile`` and ``block``; ``valid`` masks pad rows (kept at 0)."""
    n_pad, C = f.shape
    m = Q.shape[1]
    vcol = valid[:, None]

    x_tiles = xs.reshape(-1, row_tile, 3)

    def matvec(c):
        def one_tile(x_t):
            r = jnp.sqrt(jnp.maximum(jnp.sum(
                (x_t[:, None, :] - xs[None, :, :]) ** 2, axis=-1), 0.0))
            return jnp.dot(kernel_value(kernel, epsilon * r), c,
                           precision=jax.lax.Precision.HIGHEST)
        y = jax.lax.map(one_tile, x_tiles).reshape(n_pad, C)
        return jnp.where(vcol, y + smoothing * c, 0.0)

    def project(v):
        if m == 0:
            return jnp.where(vcol, v, 0.0)
        hi = jax.lax.Precision.HIGHEST
        return jnp.where(vcol, v - jnp.matmul(
            Q, jnp.matmul(Q.T, v, precision=hi), precision=hi), 0.0)

    def precond(r):
        z = jax.vmap(lambda L, b: jax.scipy.linalg.cho_solve((L, True), b))(
            pre_chol, r.reshape(-1, block, C))
        return z.reshape(n_pad, C)

    b = project(f)
    bnorm = jnp.maximum(jnp.linalg.norm(b, axis=0), 1e-30)

    c0 = jnp.zeros_like(f)
    r0 = b
    z0 = project(precond(r0))
    rz0 = jnp.sum(r0 * z0, axis=0)
    res0 = jnp.max(jnp.linalg.norm(r0, axis=0) / bnorm)

    # Best-iterate safeguard: on near-singular systems (e.g. a flat
    # gaussian kernel at tiny epsilon) f32 roundoff breaks conjugacy and
    # the residual can grow without bound. Track the lowest-residual
    # iterate and bail out once the current residual exceeds 10× the best.
    def cond(state):
        i, c, r, z, p, rz, c_best, res_best = state
        res = jnp.max(jnp.linalg.norm(r, axis=0) / bnorm)
        return (i < maxiter) & (res_best > tol) & (res < 10.0 * res_best)

    def body(state):
        i, c, r, z, p, rz, c_best, res_best = state
        Ap = project(matvec(p))
        pAp = jnp.sum(p * Ap, axis=0)
        alpha = rz / jnp.where(pAp > 0, pAp, 1e-30)
        alpha = jnp.where(pAp > 0, alpha, 0.0)
        c = c + alpha * p
        r = r - alpha * Ap
        z = project(precond(r))
        rz_new = jnp.sum(r * z, axis=0)
        beta = rz_new / jnp.where(rz != 0, rz, 1e-30)
        p = z + beta * p
        res = jnp.max(jnp.linalg.norm(r, axis=0) / bnorm)
        better = res < res_best
        c_best = jnp.where(better, c, c_best)
        res_best = jnp.where(better, res, res_best)
        return i + 1, c, r, z, p, rz_new, c_best, res_best

    state = (jnp.int32(0), c0, r0, z0, z0, rz0, c0, res0)
    iters, _, _, _, _, _, c, res = jax.lax.while_loop(cond, body, state)
    return c, matvec(c), iters, res


def rbf_global_fit_pcg(points, values, kernel: str = "thin_plate_spline",
                       smoothing: float = 0.0, epsilon: float = 1.0,
                       degree: int | None = None, row_tile: int = 2048,
                       block: int = 256, maxiter: int = 600,
                       tol: float = 1e-6, verbose: bool = False) -> GlobalRBF:
    """Fit the global RBF system matrix-free. Returns a :class:`GlobalRBF`
    consumable by :func:`rbf_global_evaluate` — same contract as the dense
    path, no N² memory. ``smoothing`` also regularizes the CG system; for
    exact interpolation at large N a tiny value (1e-6·‖f‖) is applied
    implicitly for numerical stability when 0 is passed."""
    pts = np.asarray(points, np.float32)
    f_in = np.asarray(values, np.float32)
    if f_in.ndim == 1:
        f_in = f_in[:, None]
    n = pts.shape[0]
    if degree is None:
        degree = max(MIN_DEGREE[kernel], 0)
    m = n_poly_terms(degree)

    # conditioning transform (same as the dense path / scipy)
    shift = pts.mean(axis=0)
    scale = max(float(np.max(np.abs(pts - shift))), 1e-12)
    xs_np = ((pts - shift) / scale).astype(np.float32)

    # Morton sort for block-coherent preconditioner blocks
    order = _morton_order(xs_np)
    xs_np = xs_np[order]
    f_np = f_in[order]

    # pad to a multiple of lcm(row_tile, block); pad coords repeat the first
    # point (finite kernel values) and pad rows are masked + coefficients
    # pinned at zero, so they never influence the solution
    mult = int(np.lcm(row_tile, block))
    n_pad = ((n + mult - 1) // mult) * mult
    pad = n_pad - n
    xs_pad = np.concatenate([xs_np, np.repeat(xs_np[:1], pad, axis=0)])
    f_pad = np.concatenate([f_np, np.zeros((pad, f_np.shape[1]), np.float32)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])

    lam = float(smoothing)
    if lam == 0.0:
        lam = 1e-6   # stability floor on the scaled system

    xs_j = jnp.asarray(xs_pad)
    # block-Jacobi factors (pad rows get identity via the valid mask)
    xb = xs_pad.reshape(-1, block, 3)
    vb = valid.reshape(-1, block)

    @jax.jit
    def block_factors(xb, vb):
        def one(xb1, vb1):
            r = jnp.sqrt(jnp.maximum(jnp.sum(
                (xb1[:, None, :] - xb1[None, :, :]) ** 2, axis=-1), 0.0))
            K = kernel_value(kernel, epsilon * r)
            ok = vb1[:, None] & vb1[None, :]
            K = jnp.where(ok, K, 0.0)
            dj = 1e-5 * jnp.max(jnp.abs(K)) + lam
            K = K + dj * jnp.eye(block)
            # CPD kernels can be indefinite on a block: the Cholesky then
            # produces NaNs and the block falls back to the identity (plain
            # projected CG for that block). A scaled-diagonal fallback is
            # NOT safe here — a tiny diagonal turns the preconditioner into
            # a ~1e20 scalar and the CG inner products overflow f32.
            L = jnp.linalg.cholesky(K)
            bad = jnp.any(jnp.isnan(L))
            return jnp.where(bad, jnp.eye(block), L)
        return jax.vmap(one)(xb, vb)

    pre_chol = block_factors(jnp.asarray(xb), jnp.asarray(vb))

    # polynomial constraint basis: zero rows at pads, reduced QR
    if m > 0:
        P = np.array(polynomial_basis(jnp.asarray(xs_pad), degree))
        P[~valid] = 0.0
        Qm, Rm = np.linalg.qr(P.astype(np.float64), mode="reduced")
        Q = jnp.asarray(Qm.astype(np.float32))
    else:
        Q = jnp.zeros((n_pad, 0), jnp.float32)
        Rm = np.zeros((0, 0))

    c, Kc, iters, res = _pcg_solve(
        xs_j, jnp.asarray(f_pad), jnp.asarray(valid), Q, pre_chol,
        kernel, float(epsilon), int(degree), jnp.float32(lam),
        row_tile, block, maxiter, tol)
    if verbose:
        print(f"  [rbf-pcg] N={n} iters={int(iters)} relres={float(res):.2e}")

    if m > 0:
        # R d = Qᵀ(f − (K+λI)c), solved in f64 on host (m ≤ 10)
        rhs = np.asarray(jnp.matmul(
            Q.T, jnp.asarray(f_pad) - Kc,
            precision=jax.lax.Precision.HIGHEST)).astype(np.float64)
        d = np.linalg.solve(Rm, rhs).astype(np.float32)
    else:
        d = np.zeros((0, f_np.shape[1]), np.float32)

    return GlobalRBF(points_scaled=jnp.asarray(xs_np),
                     coeffs=jnp.asarray(np.asarray(c)[:n]),
                     poly_coeffs=jnp.asarray(d),
                     shift=jnp.asarray(shift), scale=jnp.float32(scale),
                     kernel=kernel, epsilon=float(epsilon),
                     degree=int(degree))
