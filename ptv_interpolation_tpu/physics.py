"""Divergence cleaning and Poisson solves — matrix-free, jit-compiled.

Functional rebuild of `/root/reference/physics.py`. The reference's design
is: assemble sparse operators over fluid cells, solve with scipy LSQR/CG,
scatter back. Here every operator is a fused full-grid stencil
(`ops/stencils.py`), every solve is matrix-free preconditioned CG
(`ops/solvers.py`), and the fluid-cell gather/scatter disappears — masks are
arrays, shapes are static, and the whole cleaning loop jit-compiles into a
single XLA program that shards over a device mesh.

Parity notes
------------
* The projection path solves ``Lap φ = div`` with the *same* masked
  Laplacian / divergence / correction coefficients as the reference
  (verified coefficient-for-coefficient in tests), so cleaned fields match
  to solver tolerance.
* The variational path needs ``Dᵀ`` of the FV divergence. The reference
  hand-assembles ``Dx, Dy, Dz`` (`physics.py:356-438`); here the adjoint is
  obtained with ``jax.linear_transpose`` of the divergence *function* —
  exact consistency by construction.
* Pure-Neumann singular systems: the reference leans on ``b − mean(b)`` +
  LSQR (`physics.py:183,186`); here CG with explicit zero-mean projection
  each iteration (same fixed point, faster convergence).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ptv_interpolation_tpu.ops.solvers import pcg
from ptv_interpolation_tpu.ops.stencils import (
    consistent_correction,
    consistent_divergence,
    force_divergence,
    laplacian_apply,
    laplacian_diag,
)

# re-export reference-named aliases
compute_consistent_divergence = consistent_divergence
apply_consistent_correction = consistent_correction
compute_force_divergence = force_divergence


class CleanResult(NamedTuple):
    u: jax.Array
    v: jax.Array
    w: jax.Array
    mean_abs_div_initial: jax.Array
    mean_abs_div_final: jax.Array
    cg_iterations: jax.Array
    converged: jax.Array


def _mean_abs_div(u, v, w, mask, dx, dy, dz):
    div = consistent_divergence(u, v, w, mask, dx, dy, dz)
    n_fluid = jnp.maximum(jnp.sum(mask), 1)
    return jnp.sum(jnp.abs(div) * mask) / n_fluid


def mid_plane_flux(u, dy, dz):
    """Net X-flux through the middle YZ plane (`physics.py:160-165`)."""
    nx = u.shape[2]
    return jnp.sum(u[:, :, nx // 2]) * dy * dz


# ---------------------------------------------------------------------------
# Projection cleaning
# ---------------------------------------------------------------------------

# Grid spacings and solver constants are static: they fold into the
# program as constants, and a call on z-slab-sharded fields then runs as
# one program whose only parameters are the fields. With them as traced
# scalar arguments the sharded variational solve stalled on four H100s.
@functools.partial(jax.jit, static_argnames=("dx", "dy", "dz", "iterations",
                                             "tol", "maxiter", "precond"))
def clean_divergence_projection(u, v, w, mask, dx, dy, dz, iterations: int = 3,
                                tol: float = 1e-8, maxiter: int = 1000,
                                precond: str = "mg") -> CleanResult:
    """Iterative pressure-projection cleaning (`physics.py:149-209`).

    Each iteration: FV divergence → masked-Laplacian Poisson solve
    (multigrid- or Jacobi-preconditioned CG with zero-mean projection over
    fluid) → staggered-gradient correction. The Laplacian is a fixed
    stencil, so unlike the reference there is nothing to "build once" —
    XLA fuses it each iteration.
    """
    mask = jnp.asarray(mask, bool)
    maskf = mask.astype(jnp.float32)
    u = jnp.asarray(u, jnp.float32) * maskf
    v = jnp.asarray(v, jnp.float32) * maskf
    w = jnp.asarray(w, jnp.float32) * maskf
    n_fluid = jnp.maximum(jnp.sum(maskf), 1.0)

    diag = laplacian_diag(mask, dx, dy, dz)
    inv_diag = jnp.where(diag < 0, 1.0 / jnp.where(diag < 0, diag, -1.0), 0.0)

    def project(x):
        return (x - jnp.sum(x * maskf) / n_fluid) * maskf

    def neg_lap(phi):
        return -laplacian_apply(phi, mask, dx, dy, dz)

    if precond == "mg":
        from ptv_interpolation_tpu.ops.multigrid import make_mg_preconditioner
        m_inv = make_mg_preconditioner(mask, dx, dy, dz)
    else:
        def m_inv(r):
            return -inv_diag * r

    m_div_init = _mean_abs_div(u, v, w, mask, dx, dy, dz)

    def body(carry, _):
        u_c, v_c, w_c, total_iters, _conv = carry
        div = consistent_divergence(u_c, v_c, w_c, mask, dx, dy, dz) * maskf
        b = project(div)
        # solve Lap φ = b  ⇔  (−Lap) φ = −b (PSD)
        res = pcg(neg_lap, -b, M_inv=m_inv, project=project,
                  tol=tol, maxiter=maxiter)
        phi = res.x
        u_c, v_c, w_c = consistent_correction(u_c, v_c, w_c, phi, mask,
                                              dx, dy, dz)
        return (u_c, v_c, w_c, total_iters + res.iterations,
                res.converged), None

    (u_c, v_c, w_c, iters, conv), _ = jax.lax.scan(
        body, (u, v, w, jnp.int32(0), jnp.bool_(True)), None,
        length=iterations)

    m_div_final = _mean_abs_div(u_c, v_c, w_c, mask, dx, dy, dz)
    return CleanResult(u_c, v_c, w_c, m_div_init, m_div_final, iters, conv)


# ---------------------------------------------------------------------------
# Variational cleaning
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("dx", "dy", "dz", "lambda_reg",
                                             "tol", "maxiter", "solver"))
def clean_divergence_variational(u, v, w, mask, dx, dy, dz,
                                 lambda_reg: float = 1e3, tol: float = 1e-8,
                                 maxiter: int = 2000,
                                 solver: str = "woodbury") -> CleanResult:
    """Variational cleaning (`physics.py:440-514`): minimize
    ``‖U − U0‖² + λ‖div U‖²`` ⇔ solve ``(I + λ DᵀD) U = U0`` — matrix-free,
    with ``Dᵀ`` obtained by ``jax.linear_transpose`` of the FV divergence
    restricted to fluid cells (no 3n×3n ``bmat``).

    ``solver='woodbury'`` (default) reduces the 3n-unknown system by the
    Woodbury identity to the **scalar** SPD screened system

        ((1/λ) I + D̃D̃ᵀ) q = D̃ U0,     U = U0 − D̃ᵀ q

    whose interior operator is exactly the compact 7-point Laplacian at
    spacing 2h on each of the 8 parity sublattices (central differences
    decouple parities), so it is preconditioned by a parity-decomposed
    geometric-MG V-cycle: ~50 CG iterations instead of the ~180 the
    unpreconditioned 3n form needs at production λ=200/tol=1e-8 (the
    reference runs plain CG on the assembled bmat, `physics.py:485`).
    Plain MG on ``D̃D̃ᵀ`` itself would fail — near-checkerboard modes in
    range(D̃) have arbitrarily small eigenvalues but are invisible to the
    coarse grid; decimating by parity maps them onto ordinary smooth/rough
    modes of the compact Laplacian. ``solver='direct'`` keeps the literal
    3n CG formulation (used by tests as the oracle)."""
    mask = jnp.asarray(mask, bool)
    maskf = mask.astype(jnp.float32)
    u0 = jnp.asarray(u, jnp.float32) * maskf
    v0 = jnp.asarray(v, jnp.float32) * maskf
    w0 = jnp.asarray(w, jnp.float32) * maskf

    def div_op(uvw):
        # 'operator' variant: matches the reference's assembled Dx/Dy/Dz
        # (see consistent_divergence docstring on the two conventions)
        du = consistent_divergence(uvw[0] * maskf, uvw[1] * maskf,
                                   uvw[2] * maskf, mask, dx, dy, dz,
                                   variant="operator")
        return du * maskf

    example = (u0, v0, w0)
    div_T = jax.linear_transpose(div_op, example)

    m_div_init = _mean_abs_div(u0, v0, w0, mask, dx, dy, dz)

    if solver == "direct":
        from ptv_interpolation_tpu.ops.stencils import divergence_dtd_diag

        def A(uvw):
            d = div_op(uvw)
            (dtu,) = div_T(d)
            return tuple(x * maskf + lambda_reg * y * maskf
                         for x, y in zip(uvw, dtu))

        # Jacobi on the exact per-component diagonal of (I + λ D̃ᵀD̃):
        # boundary-adjacent diagonal entries differ from the interior
        # 1 + λ/(2h²) by up to 4× either way, and λ ≈ 200 in production —
        # removing that spread cuts iterations vs the reference's
        # unpreconditioned CG on the same system (`physics.py:485`)
        dtd = divergence_dtd_diag(mask, dx, dy, dz)
        inv_diag = tuple(1.0 / (1.0 + lambda_reg * d) for d in dtd)

        def m_inv(uvw):
            return tuple(r * di * maskf for r, di in zip(uvw, inv_diag))

        res = pcg(A, (u0, v0, w0), M_inv=m_inv, tol=tol, maxiter=maxiter)
        sol = res.x
    else:
        from ptv_interpolation_tpu.ops.multigrid import (
            make_mg_preconditioner_batched,
        )

        def S(q):
            (dt,) = div_T(q)
            return maskf * q / lambda_reg + div_op(dt)

        # pad to even so the 8 parity sublattices share one static shape
        # and run as a single batched V-cycle program
        nz, ny, nx = mask.shape
        pz, py, px = nz % 2, ny % 2, nx % 2
        ez, ey, ex = nz + pz, ny + py, nx + px

        def to_parity(a):
            ap = jnp.pad(a, ((0, pz), (0, py), (0, px)))
            ap = ap.reshape(ez // 2, 2, ey // 2, 2, ex // 2, 2)
            return ap.transpose(1, 3, 5, 0, 2, 4).reshape(
                8, ez // 2, ey // 2, ex // 2)

        def from_parity(b):
            a = b.reshape(2, 2, 2, ez // 2, ey // 2, ex // 2)
            a = a.transpose(3, 0, 4, 1, 5, 2).reshape(ez, ey, ex)
            return a[:nz, :ny, :nx]

        mg = make_mg_preconditioner_batched(
            to_parity(mask), 2 * dx, 2 * dy, 2 * dz,
            screening=1.0 / lambda_reg)

        def m_inv(r):
            return from_parity(mg(to_parity(r))) * maskf

        b_s = div_op(example)
        res = pcg(S, b_s, M_inv=m_inv, tol=tol, maxiter=maxiter)
        (dt,) = div_T(res.x)
        sol = tuple(x - d * maskf for x, d in zip(example, dt))

    # reference behavior: non-convergence only warns and uses the partial
    # solution; a *broken* solve (NaNs) falls back to the input unchanged
    # (`physics.py:486-491`)
    bad = jnp.any(jnp.stack([jnp.any(jnp.isnan(x)) for x in sol]))
    u_n, v_n, w_n = jax.tree_util.tree_map(
        lambda new, old: jnp.where(bad, old, new), sol, (u0, v0, w0))
    m_div_final = _mean_abs_div(u_n, v_n, w_n, mask, dx, dy, dz)
    return CleanResult(u_n, v_n, w_n, m_div_init, m_div_final,
                       res.iterations, res.converged & (~bad))


def clean_divergence(u, v, w, mask, dx, dy, dz, iterations: int = 3,
                     method: str = "projection", lambda_reg: float = 1e3,
                     verbose: bool = True):
    """Dispatcher matching the reference signature (`physics.py:347-354`).
    Returns ``(u, v, w)``; diagnostics are printed like the reference's
    cleaning reports when ``verbose``."""
    if method == "variational":
        if verbose:
            print(f"Starting Variational Divergence Cleaning (lambda={lambda_reg})...")
        res = clean_divergence_variational(u, v, w, mask, dx, dy, dz,
                                           lambda_reg=lambda_reg)
        title = "VARIATIONAL CLEANING COMPLETE"
    else:
        if verbose:
            print(f"Starting Iterative Divergence Cleaning ({iterations} iterations)...")
            print(f"  [Initial] Net X-Flux (mid-plane): "
                  f"{float(mid_plane_flux(jnp.asarray(u, jnp.float32), dy, dz)):.4e}")
        res = clean_divergence_projection(u, v, w, mask, dx, dy, dz,
                                          iterations=iterations)
        title = "DIVERGENCE CLEANING COMPLETE"
    if verbose:
        init = float(res.mean_abs_div_initial)
        final = float(res.mean_abs_div_final)
        print("\n" + "=" * 40)
        print(title)
        print(f"Initial Mean Abs Div: {init:.6e}")
        print(f"Final Mean Abs Div:   {final:.6e}")
        reduction = init / final if final > 0 else float("inf")
        print(f"Total Reduction:      {reduction:.2f}x")
        print(f"CG iterations:        {int(res.cg_iterations)}")
        if not bool(res.converged):
            print("  Warning: CG did not converge to tolerance "
                  "(variational falls back to the input field).")
        if method != "variational":
            print(f"  [Final] Net X-Flux (mid-plane): "
                  f"{float(mid_plane_flux(res.u, dy, dz)):.4e}")
        print("=" * 40 + "\n")
    return res.u, res.v, res.w


# ---------------------------------------------------------------------------
# Poisson solver (pressure recovery)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("wall_bc", "has_dirichlet",
                                             "maxiter", "precond"))
def _solve_poisson_impl(rhs_field, mask, dx, dy, dz, dirichlet_mask,
                        dirichlet_values, wall_bc: str, has_dirichlet: bool,
                        tol: float, maxiter: int, precond: str = "mg"):
    mask = jnp.asarray(mask, bool)
    maskf = mask.astype(jnp.float32)
    b = jnp.asarray(rhs_field, jnp.float32) * maskf

    diag = laplacian_diag(mask, dx, dy, dz)
    inv_diag = jnp.where(diag < 0, 1.0 / jnp.where(diag < 0, diag, -1.0), 0.0)

    def make_m_inv(solve_mask):
        if precond == "mg":
            from ptv_interpolation_tpu.ops.multigrid import (
                make_mg_preconditioner)
            return make_mg_preconditioner(solve_mask, dx, dy, dz)
        smf = solve_mask.astype(jnp.float32)
        return lambda r: -inv_diag * r * smf

    if has_dirichlet:
        d_mask = jnp.asarray(dirichlet_mask, bool) & mask
        free = mask & (~d_mask)
        freef = free.astype(jnp.float32)
        d_field = jnp.where(d_mask, dirichlet_values, 0.0)
        # b_f -= A_fd x_d   (reference `physics.py:299-307`)
        b_eff = (b - laplacian_apply(d_field, mask, dx, dy, dz)) * freef

        def neg_lap_free(phi):
            return -laplacian_apply(phi * freef, mask, dx, dy, dz) * freef

        # NOTE: the MG hierarchy uses the free mask, so Dirichlet cells act
        # as walls inside the preconditioner — approximate but SPD
        res = pcg(neg_lap_free, -b_eff, M_inv=make_m_inv(free),
                  tol=tol, maxiter=maxiter)
        p = res.x * freef + d_field
    else:
        n_fluid = jnp.maximum(jnp.sum(maskf), 1.0)

        def project(x):
            return (x - jnp.sum(x * maskf) / n_fluid) * maskf

        def neg_lap(phi):
            return -laplacian_apply(phi, mask, dx, dy, dz)

        b_eff = project(b)
        res = pcg(neg_lap, -b_eff, M_inv=make_m_inv(mask),
                  project=project, tol=tol, maxiter=maxiter)
        p = res.x
    return p * maskf, res.iterations, res.converged


def solve_poisson(source, mask, dx, dy, dz, force_field=None,
                  wall_bc: str = "inhomogeneous", dirichlet_mask=None,
                  dirichlet_values=0.0, tol: float = 1e-8,
                  maxiter: int = 3000, precond: str = "mg"):
    """Solve ``Lap(p) = source`` on the fluid domain (`physics.py:264-345`).

    ``force_field=(fx, fy, fz)`` computes the RHS as a consistent face-flux
    divergence with ``wall_bc`` boundary treatment. ``dirichlet_mask`` pins
    nodes to ``dirichlet_values`` (scalar or field); otherwise the singular
    pure-Neumann system is solved with zero-mean projection.
    """
    mask = jnp.asarray(mask, bool)
    if int(np.asarray(jnp.sum(mask))) == 0:
        return jnp.zeros(mask.shape, jnp.float32)
    if force_field is not None:
        fx, fy, fz = force_field
        rhs_field = force_divergence(fx, fy, fz, mask, dx, dy, dz,
                                     wall_bc=wall_bc)
    else:
        rhs_field = jnp.asarray(source)

    has_dirichlet = dirichlet_mask is not None
    d_mask = dirichlet_mask if has_dirichlet else jnp.zeros(mask.shape, bool)
    d_vals = (jnp.asarray(dirichlet_values, jnp.float32)
              if not np.isscalar(dirichlet_values)
              else jnp.float32(dirichlet_values))
    p, _, _ = _solve_poisson_impl(rhs_field, mask, dx, dy, dz, d_mask, d_vals,
                                  wall_bc, has_dirichlet, tol, maxiter,
                                  precond)
    return p
