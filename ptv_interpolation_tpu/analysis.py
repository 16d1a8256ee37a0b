"""Velocity-field analysis: strain rate, vorticity, dissipation, flow type,
permeability, and pressure recovery.

Functional JAX rebuild of `/root/reference/velocity_analysis.py:10-330` (the
interface-drag integrators live in :mod:`ptv_interpolation_tpu.drag`).
Every function is jit-compiled, mask-aware, and shape-static; gradients use
the same central-difference convention as ``np.gradient``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ptv_interpolation_tpu.grid import binary_erosion6
from ptv_interpolation_tpu.ops.stencils import gradient, shift
from ptv_interpolation_tpu.physics import solve_poisson


def _maybe_mask(field, mask):
    if mask is None:
        return field
    return field * jnp.asarray(mask, bool)


@jax.jit
def compute_strain_rate(u, v, w, dx, dy, dz, mask=None):
    """Shear-rate magnitude γ̇ = sqrt(0.5 Σ(2ε̇ᵢᵢ)² + Σ(2ε̇ᵢⱼ)²)
    (`velocity_analysis.py:10-63`)."""
    du_dz, du_dy, du_dx = gradient(u, dx, dy, dz)
    dv_dz, dv_dy, dv_dx = gradient(v, dx, dy, dz)
    dw_dz, dw_dy, dw_dx = gradient(w, dx, dy, dz)

    e_xx = 2 * du_dx
    e_yy = 2 * dv_dy
    e_zz = 2 * dw_dz
    e_xy = du_dy + dv_dx
    e_xz = du_dz + dw_dx
    e_yz = dv_dz + dw_dy

    gamma = jnp.sqrt(0.5 * (e_xx ** 2 + e_yy ** 2 + e_zz ** 2)
                     + e_xy ** 2 + e_xz ** 2 + e_yz ** 2)
    return _maybe_mask(gamma, mask)


@jax.jit
def compute_viscous_dissipation(strain_rate, viscosity, dx=1.0, dy=1.0,
                                dz=1.0, mask=None):
    """Φ = μ γ̇² (Pilotti 2002; `velocity_analysis.py:65-92`)."""
    return _maybe_mask(viscosity * strain_rate ** 2, mask)


@functools.partial(jax.jit, static_argnames=("want_strain", "want_diss",
                                              "want_vort", "want_xi"))
def compute_derivative_fields(u, v, w, dx, dy, dz, viscosity, mask=None,
                              want_strain: bool = True,
                              want_diss: bool = True,
                              want_vort: bool = True,
                              want_xi: bool = False):
    """All first-derivative analysis fields in ONE traced program.

    Fuses strain rate (`velocity_analysis.py:10-63`), viscous dissipation
    (`velocity_analysis.py:65-92`), vorticity magnitude
    (`velocity_analysis.py:94-120`) and the Astarita flow type
    (`velocity_analysis.py:151-188`): the nine velocity gradients are
    computed once and shared, everything stays device-resident, and the
    caller pays a single dispatch + D2H round trip instead of one per
    stage (each hop re-uploaded a 67 MB field at 256³ — the round-3
    "4 s elementwise dissipation" anomaly). Individual fields remain
    available via :func:`compute_strain_rate` etc.; results here are
    bit-identical (same op order, same masking).

    Returns a dict with the requested keys among
    ``{"strain_rate", "dissipation", "vorticity", "xi"}``.
    """
    du_dz, du_dy, du_dx = gradient(u, dx, dy, dz)
    dv_dz, dv_dy, dv_dx = gradient(v, dx, dy, dz)
    dw_dz, dw_dy, dw_dx = gradient(w, dx, dy, dz)

    out = {}
    gamma = None
    if want_strain or want_diss or want_xi:
        e_xx = 2 * du_dx
        e_yy = 2 * dv_dy
        e_zz = 2 * dw_dz
        e_xy = du_dy + dv_dx
        e_xz = du_dz + dw_dx
        e_yz = dv_dz + dw_dy
        gamma = jnp.sqrt(0.5 * (e_xx ** 2 + e_yy ** 2 + e_zz ** 2)
                         + e_xy ** 2 + e_xz ** 2 + e_yz ** 2)
        gamma = _maybe_mask(gamma, mask)
        if want_strain:
            out["strain_rate"] = gamma
    if want_diss:
        out["dissipation"] = _maybe_mask(viscosity * gamma ** 2, mask)
    vort = None
    if want_vort or want_xi:
        vort_x = dw_dy - dv_dz
        vort_y = du_dz - dw_dx
        vort_z = dv_dx - du_dy
        vort = _maybe_mask(
            jnp.sqrt(vort_x ** 2 + vort_y ** 2 + vort_z ** 2), mask)
        if want_vort:
            out["vorticity"] = vort
    if want_xi:
        out["xi"] = compute_astarita_flow_type(gamma, vort, mask)
    return out


@jax.jit
def compute_vorticity(u, v, w, dx, dy, dz, mask=None):
    """|∇×u| (`velocity_analysis.py:94-120`)."""
    du_dz, du_dy, _ = gradient(u, dx, dy, dz)
    dv_dz, _, dv_dx = gradient(v, dx, dy, dz)
    _, dw_dy, dw_dx = gradient(w, dx, dy, dz)
    vort_x = dw_dy - dv_dz
    vort_y = du_dz - dw_dx
    vort_z = dv_dx - du_dy
    mag = jnp.sqrt(vort_x ** 2 + vort_y ** 2 + vort_z ** 2)
    return _maybe_mask(mag, mask)


@jax.jit
def compute_permeability(u, v, w, dissipation, viscosity, dx, dy, dz,
                         mask=None):
    """Energy-dissipation permeability k = μ U₀² / ⟨Φ⟩ with Darcy velocity
    and mean dissipation over the **total** volume — solid included, the
    reference's deliberate Pilotti convention (`velocity_analysis.py:122-149`,
    SURVEY §7 quirk (d))."""
    u0 = jnp.sqrt(jnp.mean(u) ** 2 + jnp.mean(v) ** 2 + jnp.mean(w) ** 2)
    mean_phi = jnp.mean(dissipation)
    return jnp.where(mean_phi == 0, 0.0, viscosity * u0 ** 2 / mean_phi)


@jax.jit
def compute_astarita_flow_type(strain_rate, vorticity_mag, mask=None):
    """ξ = (γ̇ − |ω|)/(γ̇ + |ω|) ∈ [−1, 1] (`velocity_analysis.py:151-188`)."""
    num = strain_rate - vorticity_mag
    den = strain_rate + vorticity_mag
    xi = jnp.where(den > 1e-15, num / jnp.where(den > 1e-15, den, 1.0), 0.0)
    return _maybe_mask(xi, mask)


@functools.partial(jax.jit, static_argnames=("fill_sweeps",))
def laplacian_mask_aware(f, dx, dy, dz, mask=None, fill_sweeps: int = 2):
    """Mask-protected Laplacian (`velocity_analysis.py:210-269`):

    1. 7-point Laplacian with edge-clamped neighbors.
    2. 'Bulk' = fluid eroded by 1; boundary fluid nodes get their Laplacian
       back-filled from adjacent bulk values by ``fill_sweeps`` dilation
       sweeps (avoids one-sided spikes at no-slip walls).
    """
    f = jnp.asarray(f, jnp.float32)
    lap = jnp.zeros_like(f)
    for axis, h in ((0, dz), (1, dy), (2, dx)):
        f_next = shift(f, +1, axis, 0.0)
        f_prev = shift(f, -1, axis, 0.0)
        idx = jax.lax.broadcasted_iota(jnp.int32, f.shape, axis)
        n = f.shape[axis]
        f_next = jnp.where(idx == n - 1, f, f_next)   # clamp at edges
        f_prev = jnp.where(idx == 0, f, f_prev)
        lap = lap + (f_next - 2 * f + f_prev) / (h * h)

    if mask is None:
        return lap

    mask = jnp.asarray(mask, bool)
    bulk = binary_erosion6(mask, 1)
    boundary = mask & (~bulk)

    def sweep(state, _):
        lap_f, bulk_m = state
        to_fill = boundary & (~bulk_m)
        sum_val = jnp.zeros_like(lap_f)
        count = jnp.zeros_like(lap_f)
        for axis in (0, 1, 2):
            for s in (-1, 1):
                l_sh = shift(lap_f, s, axis, 0.0)
                m_sh = shift(bulk_m, s, axis, False)
                valid = to_fill & m_sh
                sum_val = sum_val + jnp.where(valid, l_sh, 0.0)
                count = count + jnp.where(valid, 1.0, 0.0)
        upd = to_fill & (count > 0)
        lap_f = jnp.where(upd, sum_val / jnp.maximum(count, 1.0), lap_f)
        bulk_m = bulk_m | upd
        return (lap_f, bulk_m), None

    (lap, _), _ = jax.lax.scan(sweep, (lap, bulk), None, length=fill_sweeps)
    return lap


def compute_pressure_field(u, v, w, dx, dy, dz, mu, rho=0.0, mask=None,
                           wall_bc: str = "zero-neumann",
                           anchor: str = "outlet",
                           flow_direction: str = "auto",
                           tol: float = 1e-8, maxiter: int = 3000,
                           verbose: bool = True):
    """Pressure recovery via the pressure Poisson equation
    (`velocity_analysis.py:190-330`): RHS force f = μ∇²u − ρ(u·∇)u with a
    mask-aware Laplacian; Dirichlet anchor plane at the inlet/outlet Z-face.
    """
    u = jnp.asarray(u, jnp.float32)
    v = jnp.asarray(v, jnp.float32)
    w = jnp.asarray(w, jnp.float32)
    if mask is None:
        mask_b = jnp.ones(u.shape, bool)
    else:
        mask_b = jnp.asarray(mask, bool)

    if verbose:
        print(f"Computing pressure field source term (mu={mu}, rho={rho}, "
              f"wall_bc={wall_bc}, flow={flow_direction})...")

    fx = mu * laplacian_mask_aware(u, dx, dy, dz, mask_b)
    fy = mu * laplacian_mask_aware(v, dx, dy, dz, mask_b)
    fz = mu * laplacian_mask_aware(w, dx, dy, dz, mask_b)

    if rho > 0:
        gu = gradient(u, dx, dy, dz)
        gv = gradient(v, dx, dy, dz)
        gw = gradient(w, dx, dy, dz)
        # gradient returns (d/dz, d/dy, d/dx)
        fx = fx - rho * (u * gu[2] + v * gu[1] + w * gu[0])
        fy = fy - rho * (u * gv[2] + v * gv[1] + w * gv[0])
        fz = fz - rho * (u * gw[2] + v * gw[1] + w * gw[0])

    # flow direction → inlet/outlet plane selection (`velocity_analysis.py:304-314`)
    import numpy as np
    w_mean = float(jnp.sum(w * mask_b) / jnp.maximum(jnp.sum(mask_b), 1))
    if flow_direction == "positive":
        plane_inlet, plane_outlet = 0, -1
    elif flow_direction == "negative":
        plane_inlet, plane_outlet = -1, 0
    else:
        plane_inlet, plane_outlet = (0, -1) if w_mean >= 0 else (-1, 0)

    dirichlet_mask = None
    if anchor != "none":
        dm = np.zeros(u.shape, dtype=bool)
        dm[plane_outlet if anchor == "outlet" else plane_inlet, :, :] = True
        dirichlet_mask = jnp.asarray(dm) & mask_b

    if verbose:
        print(f"Solving pressure Poisson equation (anchor={anchor} at "
              f"Z-plane, dir={flow_direction})...")
    return solve_poisson(None, mask_b, dx, dy, dz, force_field=(fx, fy, fz),
                         wall_bc=wall_bc, dirichlet_mask=dirichlet_mask,
                         dirichlet_values=0.0, tol=tol, maxiter=maxiter)


@jax.jit
def compute_permeability_from_pressure(u, v, w, pressure, viscosity,
                                       dx, dy, dz):
    """Darcy permeability k = −μ (U₀·∇P)/|∇P|² with bulk means
    (`velocity_analysis.py:659-697`)."""
    u0 = jnp.stack([jnp.mean(u), jnp.mean(v), jnp.mean(w)])
    dp_dz, dp_dy, dp_dx = gradient(pressure, dx, dy, dz)
    g = jnp.stack([jnp.mean(dp_dx), jnp.mean(dp_dy), jnp.mean(dp_dz)])
    g2 = jnp.sum(g * g)
    return jnp.where(g2 == 0, 0.0, -viscosity * jnp.dot(
        u0, g, precision=jax.lax.Precision.HIGHEST) / g2)
