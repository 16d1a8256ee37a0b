"""Finite-volume stencil operators on the (nz, ny, nx) grid, matrix-free.

The reference assembles sparse matrices (COO Laplacian
`/root/reference/physics.py:55-108`, divergence operators `:356-438`) only
because scipy's solvers need explicit matrices. On the device the same operators
are *functions*: fused shift/where stencils over the full grid, with the
fluid mask carried as an array. Coefficient-for-coefficient parity with the
reference assembly (including the subtle domain-edge Neumann terms) is
checked in tests against a literal numpy port.

Conventions: mask True = fluid; velocities are zero in solid cells; all
operators return zero on solid rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _axis_index(shape, axis):
    return jax.lax.broadcasted_iota(jnp.int32, shape, axis)


def shift(arr, offset: int, axis: int, fill):
    """Shift ``arr`` by ``offset`` along ``axis`` without wraparound:
    ``out[i] = arr[i + offset]`` where valid, else ``fill``."""
    rolled = jnp.roll(arr, -offset, axis=axis)
    idx = _axis_index(arr.shape, axis)
    n = arr.shape[axis]
    if offset > 0:
        valid = idx < n - offset
    else:
        valid = idx >= -offset
    return jnp.where(valid, rolled, fill)


def consistent_divergence(u, v, w, mask, dx, dy, dz, variant: str = "roll"):
    """FV divergence with the reference's face conventions.

    Face velocity: mean of the two cells if the neighbor is fluid, 0 at a
    solid face (no-penetration), own-cell value at domain edges (Neumann).
    Computed on every cell; only fluid rows are meaningful downstream.

    The reference ships **two inconsistent formulations** of this operator:

    * ``variant='roll'`` reproduces ``compute_consistent_divergence``
      (`physics.py:6-53`), where the left face is literally
      ``roll(f_next, +1)`` — so at a fluid cell whose *lower* neighbor is
      solid the face takes ``(v_solid + v_i)/2 = v_i/2`` instead of the
      no-penetration 0. This is the operator the projection-cleaning loop
      and all divergence diagnostics consume, so it is the parity default.
    * ``variant='operator'`` reproduces the assembled ``Dx/Dy/Dz``
      matrices (`physics.py:356-438`), where *both* solid faces are 0 —
      the symmetric convention the variational cleaner uses.
    """
    mask = jnp.asarray(mask, bool)

    def face_div(vel, axis, h):
        v_next = shift(vel, +1, axis, 0.0)
        m_next = shift(mask, +1, axis, False)
        f_next = jnp.where(m_next, (vel + v_next) * 0.5, 0.0)
        idx = _axis_index(vel.shape, axis)
        n = vel.shape[axis]
        f_next = jnp.where(idx == n - 1, vel, f_next)        # edge Neumann

        if variant == "roll":
            f_prev = shift(f_next, -1, axis, 0.0)            # f_next[i-1]
        else:
            v_prev = shift(vel, -1, axis, 0.0)
            m_prev = shift(mask, -1, axis, False)
            f_prev = jnp.where(m_prev, (vel + v_prev) * 0.5, 0.0)
        f_prev = jnp.where(idx == 0, vel, f_prev)            # edge Neumann
        return (f_next - f_prev) / h

    return (face_div(jnp.asarray(u), 2, dx)
            + face_div(jnp.asarray(v), 1, dy)
            + face_div(jnp.asarray(w), 0, dz))


def laplacian_apply(phi, mask, dx, dy, dz):
    """Matrix-free application of the reference's masked 7-point Laplacian
    (`physics.py:55-108`): for each fluid cell, ``Σ (φ_j − φ_i)/h²`` over
    in-domain fluid neighbors j. Zero on solid rows. Symmetric NSD."""
    mask = jnp.asarray(mask, bool)
    phi = jnp.asarray(phi)
    out = jnp.zeros_like(phi)
    for axis, h in ((2, dx), (1, dy), (0, dz)):
        h2_inv = 1.0 / (h * h)
        for off in (+1, -1):
            phi_n = shift(phi, off, axis, 0.0)
            m_n = shift(mask, off, axis, False)
            connected = mask & m_n
            out = out + jnp.where(connected, (phi_n - phi) * h2_inv, 0.0)
    return out


def laplacian_diag(mask, dx, dy, dz):
    """Diagonal of the masked Laplacian: ``−Σ 1/h²`` per connected neighbor —
    the Jacobi preconditioner for the CG solves."""
    mask = jnp.asarray(mask, bool)
    diag = jnp.zeros(mask.shape, jnp.float32)
    for axis, h in ((2, dx), (1, dy), (0, dz)):
        h2_inv = 1.0 / (h * h)
        for off in (+1, -1):
            m_n = shift(mask, off, axis, False)
            diag = diag - jnp.where(mask & m_n, h2_inv, 0.0)
    return diag


def divergence_dtd_diag(mask, dx, dy, dz):
    """Exact per-component diagonal of ``D̃ᵀD̃`` where ``D̃`` is the masked
    'operator'-variant FV divergence (rows and columns both restricted to
    fluid cells) — the Jacobi preconditioner for the variational cleaner's
    ``(I + λ D̃ᵀD̃)`` system (reference solves it unpreconditioned,
    `physics.py:485`).

    Derivation: per axis the divergence row at cell ``i`` carries
    coefficients ``±1/(2h)`` on the in-domain fluid neighbors ``i±1``,
    ``(a₊ − a₋)/(2h) ± 1/h`` (edge Neumann) on ``i`` itself; the column sum
    of squares for unknown ``j`` therefore has the closed form below. The
    interior value is ``1/(2h²)`` but boundary-adjacent cells differ by up
    to 4× either way — that spread (times λ ≈ 200) is what Jacobi removes.
    """
    mask = jnp.asarray(mask, bool)
    maskf = mask.astype(jnp.float32)

    def axis_diag(axis, h):
        m_next = shift(maskf, +1, axis, 0.0)   # fluid indicator at j+1
        m_prev = shift(maskf, -1, axis, 0.0)
        idx = _axis_index(mask.shape, axis)
        n = mask.shape[axis]
        inv2h = 1.0 / (2.0 * h)
        edge = (jnp.where(idx == n - 1, 1.0, 0.0)
                - jnp.where(idx == 0, 1.0, 0.0)) / h
        c_self = (m_next - m_prev) * inv2h + edge      # c_{j,j}
        # rows j∓1 (if fluid) each touch u_j with ±1/(2h)
        off = (m_next + m_prev) * (inv2h * inv2h)
        return maskf * (c_self * c_self + off)

    return (axis_diag(2, dx), axis_diag(1, dy), axis_diag(0, dz))


def consistent_correction(u, v, w, phi, mask, dx, dy, dz):
    """Velocity correction from a potential φ (`physics.py:110-147`):
    cell-centered gradient = mean of the two staggered face gradients,
    with zero gradient at solid faces and domain edges; solid re-zeroed."""
    mask = jnp.asarray(mask, bool)

    def cell_grad(p, axis, h):
        p_next = shift(p, +1, axis, 0.0)
        m_next = shift(mask, +1, axis, False)
        g_next = jnp.where(m_next & mask, (p_next - p) / h, 0.0)
        idx = _axis_index(p.shape, axis)
        n = p.shape[axis]
        g_next = jnp.where(idx == n - 1, 0.0, g_next)
        g_prev = shift(g_next, -1, axis, 0.0)
        g_prev = jnp.where(idx == 0, 0.0, g_prev)
        return (g_next + g_prev) * 0.5

    u_new = (u - cell_grad(phi, 2, dx)) * mask
    v_new = (v - cell_grad(phi, 1, dy)) * mask
    w_new = (w - cell_grad(phi, 0, dz)) * mask
    return u_new, v_new, w_new


def force_divergence(fx, fy, fz, mask, dx, dy, dz, wall_bc: str = "zero-neumann"):
    """Face-flux divergence of a force field for the Poisson RHS
    (`physics.py:211-262`).

    ``zero-neumann``: boundary faces (domain edges and solid walls) carry
    zero flux, injecting the force into the RHS. ``inhomogeneous``: solid
    faces take the one-sided fluid value.
    """
    mask = jnp.asarray(mask, bool)

    def flux_grad(field, axis, h):
        # face between cell i and i+1 lives at index i of f_face
        f_next_val = shift(field, +1, axis, 0.0)
        m_next = shift(mask, +1, axis, False)
        both = mask & m_next
        f_face = jnp.where(both, 0.5 * (field + f_next_val), 0.0)
        if wall_bc == "inhomogeneous":
            f_face = jnp.where(mask & (~m_next), field, f_face)
            f_face = jnp.where((~mask) & m_next, f_next_val, f_face)
        idx = _axis_index(field.shape, axis)
        n = field.shape[axis]
        f_face = jnp.where(idx == n - 1, 0.0, f_face)   # domain edge: no flux
        f_face_prev = shift(f_face, -1, axis, 0.0)      # face i-1 (zero at edge)
        return (f_face - f_face_prev) / h

    return (flux_grad(jnp.asarray(fx), 2, dx)
            + flux_grad(jnp.asarray(fy), 1, dy)
            + flux_grad(jnp.asarray(fz), 0, dz))


def gradient(f, dx, dy, dz):
    """Central-difference gradient identical to ``np.gradient`` (one-sided
    at edges). Returns (df/dz, df/dy, df/dx) like numpy's axis order."""
    f = jnp.asarray(f)

    def grad_axis(axis, h):
        f_next = shift(f, +1, axis, 0.0)
        f_prev = shift(f, -1, axis, 0.0)
        idx = _axis_index(f.shape, axis)
        n = f.shape[axis]
        interior = (f_next - f_prev) / (2.0 * h)
        first = (f_next - f) / h
        last = (f - f_prev) / h
        out = jnp.where(idx == 0, first, interior)
        return jnp.where(idx == n - 1, last, out)

    return grad_axis(0, dz), grad_axis(1, dy), grad_axis(2, dx)
