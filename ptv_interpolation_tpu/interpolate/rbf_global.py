"""Global (all-points) RBF interpolation with a dense device solve.

Device equivalent of ``scipy.interpolate.RBFInterpolator`` without
``neighbors`` — one global system through every particle:

    [K + λI  P] [c]   [f]
    [Pᵀ      0] [d] = [0]

* Positive-definite kernels (gaussian / inverse-multiquadric /
  inverse-quadratic) with ``degree=-1``: solved by **dense Cholesky** of
  ``K + λI`` — scenario 2 ("Global Gaussian-RBF with dense Cholesky",
  PERF.md).
* Conditionally-PD kernels with polynomial tail: batched LU
  (``jnp.linalg.solve``) on the saddle-point system.

Evaluation is a tiled ``(Q_tile, N)`` kernel matrix × coefficient matmul
at ``Precision.HIGHEST``. Coordinates are shifted/scaled as scipy does for
conditioning.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ptv_interpolation_tpu.ops.neighbors import map_query_tiles
from ptv_interpolation_tpu.ops.rbf_kernels import (
    MIN_DEGREE,
    PD_KERNELS,
    kernel_value,
    n_poly_terms,
    polynomial_basis,
)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class GlobalRBF:
    """A fitted global RBF model (coefficients + conditioning transform)."""

    points_scaled: jax.Array   # (N, 3)
    coeffs: jax.Array          # (N, C) kernel coefficients
    poly_coeffs: jax.Array     # (m, C)
    shift: jax.Array           # (3,)
    scale: jax.Array           # ()
    kernel: str                # static
    epsilon: float             # static
    degree: int                # static

    def tree_flatten(self):
        return ((self.points_scaled, self.coeffs, self.poly_coeffs,
                 self.shift, self.scale),
                (self.kernel, self.epsilon, self.degree))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


@functools.partial(jax.jit, static_argnames=("kernel", "degree", "epsilon"))
def rbf_global_fit(points, values, kernel: str = "thin_plate_spline",
                   smoothing: float = 0.0, epsilon: float = 1.0,
                   degree: int | None = None) -> GlobalRBF:
    """Fit the global system. O(N²) memory, O(N³) flops — intended for
    N ≲ 3·10⁴ (beyond that, use the local/kNN path like the reference does)."""
    x = jnp.asarray(points, jnp.float32)
    f = jnp.asarray(values, jnp.float32)
    if degree is None:
        degree = max(MIN_DEGREE[kernel], 0)
    m = n_poly_terms(degree)
    n = x.shape[0]

    shift = jnp.mean(x, axis=0)
    scale = jnp.maximum(jnp.max(jnp.abs(x - shift)), 1e-12)
    xs = (x - shift) / scale

    r = jnp.sqrt(jnp.maximum(jnp.sum(
        (xs[:, None, :] - xs[None, :, :]) ** 2, axis=-1), 0.0))
    K = kernel_value(kernel, epsilon * r) + smoothing * jnp.eye(n)

    if m == 0 and kernel in PD_KERNELS:
        # SPD path: one Cholesky factorization on the device
        jitter = 1e-6 * jnp.max(jnp.abs(K))
        L = jnp.linalg.cholesky(K + jitter * jnp.eye(n))
        c = jax.scipy.linalg.cho_solve((L, True), f)
        d = jnp.zeros((0, f.shape[1]), f.dtype)
    else:
        P = polynomial_basis(xs, degree)                  # (N, m)
        A = jnp.block([[K, P], [P.T, jnp.zeros((m, m))]])
        rhs = jnp.concatenate([f, jnp.zeros((m, f.shape[1]), f.dtype)])
        sol = jnp.linalg.solve(A, rhs)
        c, d = sol[:n], sol[n:]

    return GlobalRBF(points_scaled=xs, coeffs=c, poly_coeffs=d,
                     shift=shift, scale=scale, kernel=kernel,
                     epsilon=float(epsilon), degree=int(degree))


def rbf_global_evaluate(model: GlobalRBF, queries, query_tile: int = 1024,
                        progress=None):
    """Evaluate a fitted model at (Q, 3) queries → (Q, C). Tiled (T, N)
    kernel blocks keep device memory bounded.
    ``progress`` (host callback ``fn(done, total)``) switches to host-level
    macro-batches with per-batch reporting."""
    if progress is None:
        return _rbf_global_evaluate_jit(model, queries, query_tile)
    return _rbf_global_evaluate_impl(model, queries, query_tile, progress)


@functools.partial(jax.jit, static_argnames=("query_tile",))
def _rbf_global_evaluate_jit(model: GlobalRBF, queries, query_tile):
    return _rbf_global_evaluate_impl(model, queries, query_tile, None)


def _rbf_global_evaluate_impl(model: GlobalRBF, queries, query_tile,
                              progress):
    def tile(q_tile):
        qs = (q_tile - model.shift) / model.scale
        r = jnp.sqrt(jnp.maximum(jnp.sum(
            (qs[:, None, :] - model.points_scaled[None, :, :]) ** 2, axis=-1),
            0.0))
        Kq = kernel_value(model.kernel, model.epsilon * r)     # (T, N)
        out = jnp.dot(Kq, model.coeffs, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        if model.poly_coeffs.shape[0] > 0:
            Pq = polynomial_basis(qs, model.degree)
            out = out + jnp.dot(Pq, model.poly_coeffs,
                                preferred_element_type=jnp.float32)
        return out

    return map_query_tiles(tile, queries, query_tile, progress=progress)


#: above this point count the dense O(N²)-memory Cholesky path is replaced
#: by the matrix-free projected PCG (rbf_global_pcg.py)
DENSE_FIT_MAX = 20_000


def rbf_global_interpolate(points, values, queries, solver: str = "auto",
                           **kwargs):
    """Fit + evaluate in one call.

    ``solver``: 'dense' (O(N²) Cholesky/LU, fastest for small N), 'pcg'
    (matrix-free projected PCG, N ~ 10⁵ on one chip), or 'auto' (dense
    below ``DENSE_FIT_MAX`` points, pcg above)."""
    import numpy as np
    query_tile = kwargs.pop("query_tile", 1024)
    progress = kwargs.pop("progress", None)
    if solver == "auto":
        solver = "dense" if np.shape(points)[0] <= DENSE_FIT_MAX else "pcg"
    if solver == "pcg":
        from ptv_interpolation_tpu.interpolate.rbf_global_pcg import (
            rbf_global_fit_pcg)
        model = rbf_global_fit_pcg(points, values, **kwargs)
    else:
        model = rbf_global_fit(points, values, **kwargs)
    return rbf_global_evaluate(model, queries, query_tile=query_tile,
                               progress=progress)
