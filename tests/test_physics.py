"""Physics parity: matrix-free stencils/solvers vs scipy sparse assembly of
the reference formulation (coefficient-for-coefficient)."""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.linalg import cg as scipy_cg
from scipy.sparse.linalg import lsqr, spsolve

from ptv_interpolation_tpu.ops.stencils import (
    consistent_correction, consistent_divergence, force_divergence,
    gradient, laplacian_apply, laplacian_diag,
)
from ptv_interpolation_tpu.physics import (
    clean_divergence, clean_divergence_projection,
    clean_divergence_variational, solve_poisson,
)

# ------------------------------------------------------------------ fixtures


def _sphere_mask(n=16, r_frac=0.3):
    ax = np.arange(n) - n / 2 + 0.5
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    solid = (X ** 2 + Y ** 2 + Z ** 2) < (r_frac * n) ** 2
    return ~solid  # fluid


def _divergent_field(n=16, seed=0):
    rng = np.random.default_rng(seed)
    ax = np.arange(n, dtype=np.float64)
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    u = 0.05 * np.sin(X / 3) + 0.01 * rng.normal(size=(n, n, n))
    v = 0.05 * np.cos(Y / 4) + 0.01 * rng.normal(size=(n, n, n))
    w = 1.0 + 0.1 * Z / n + 0.01 * rng.normal(size=(n, n, n))
    return u, v, w


# ------------------------------------------- reference assemblies (numpy)


def _assemble_laplacian(mask, dx, dy, dz):
    """Sparse assembly of the reference's masked Laplacian
    (`physics.py:55-108` semantics): off-diag 1/h² per in-domain fluid
    neighbor pair, matching −1/h² on the diagonal."""
    nz, ny, nx = mask.shape
    n_fluid = int(mask.sum())
    idx_map = np.full(mask.shape, -1, np.int64)
    idx_map[mask] = np.arange(n_fluid)
    I, J, K = np.where(mask)
    curr = idx_map[I, J, K]
    rows, cols, data = [], [], []
    for (di, dj, dk, h) in [(0, 0, 1, dx), (0, 0, -1, dx), (0, 1, 0, dy),
                            (0, -1, 0, dy), (1, 0, 0, dz), (-1, 0, 0, dz)]:
        In, Jn, Kn = I + di, J + dj, K + dk
        ok = ((In >= 0) & (In < nz) & (Jn >= 0) & (Jn < ny)
              & (Kn >= 0) & (Kn < nx))
        neigh = np.full_like(curr, -1)
        neigh[ok] = idx_map[In[ok], Jn[ok], Kn[ok]]
        conn = neigh >= 0
        h2 = 1.0 / h ** 2
        rows += [curr[conn], curr[conn]]
        cols += [neigh[conn], curr[conn]]
        data += [np.full(conn.sum(), h2), np.full(conn.sum(), -h2)]
    A = sp.coo_matrix((np.concatenate(data),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n_fluid, n_fluid)).tocsr()
    return A, idx_map


def _numpy_divergence(u, v, w, mask, dx, dy, dz, variant="roll"):
    """Literal numpy port of the FV divergence semantics for parity checks
    (both reference conventions — see stencils.consistent_divergence)."""
    def face(vel, axis, m):
        v_next = np.roll(vel, -1, axis=axis)
        m_next = np.roll(m, -1, axis=axis)
        f_next = np.where(m_next, (vel + v_next) / 2.0, 0.0)
        sl = [slice(None)] * 3
        sl[axis] = -1
        f_next[tuple(sl)] = vel[tuple(sl)]
        if variant == "roll":
            f_prev = np.roll(f_next, 1, axis=axis)
        else:
            v_prev = np.roll(vel, 1, axis=axis)
            m_prev = np.roll(m, 1, axis=axis)
            f_prev = np.where(m_prev, (vel + v_prev) / 2.0, 0.0)
        sl[axis] = 0
        f_prev[tuple(sl)] = vel[tuple(sl)]
        return f_next, f_prev

    ufn, ufp = face(u, 2, mask)
    vfn, vfp = face(v, 1, mask)
    wfn, wfp = face(w, 0, mask)
    return (ufn - ufp) / dx + (vfn - vfp) / dy + (wfn - wfp) / dz


# ------------------------------------------------------------------- tests


def test_divergence_matches_reference_formulation():
    mask = _sphere_mask()
    u, v, w = _divergent_field()
    u, v, w = (a * mask for a in (u, v, w))
    for variant in ("roll", "operator"):
        want = _numpy_divergence(u, v, w, mask, 1.0, 0.9, 1.1, variant)
        got = np.asarray(consistent_divergence(u, v, w, mask, 1.0, 0.9, 1.1,
                                               variant=variant))
        np.testing.assert_allclose(got[mask], want[mask], rtol=1e-4, atol=1e-5)
    # the two conventions genuinely differ at fluid cells with solid
    # lower neighbors (the reference's internal inconsistency)
    d_roll = _numpy_divergence(u, v, w, mask, 1, 1, 1, "roll")
    d_op = _numpy_divergence(u, v, w, mask, 1, 1, 1, "operator")
    assert np.abs(d_roll - d_op)[mask].max() > 1e-4


def test_laplacian_matches_sparse_assembly():
    mask = _sphere_mask()
    rng = np.random.default_rng(1)
    phi_grid = rng.normal(size=mask.shape) * mask
    A, idx_map = _assemble_laplacian(mask, 1.0, 0.8, 1.2)
    want = A @ phi_grid[mask]
    got = np.asarray(laplacian_apply(phi_grid, mask, 1.0, 0.8, 1.2))[mask]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # diag parity
    diag = np.asarray(laplacian_diag(mask, 1.0, 0.8, 1.2))[mask]
    np.testing.assert_allclose(diag, A.diagonal(), rtol=1e-5, atol=1e-6)


def test_correction_zero_gradient_noop():
    mask = _sphere_mask()
    u, v, w = _divergent_field()
    phi = np.zeros(mask.shape)
    un, vn, wn = (np.asarray(a) for a in
                  consistent_correction(u, v, w, phi, mask, 1, 1, 1))
    np.testing.assert_allclose(un[mask], (u * mask)[mask], atol=1e-6)
    assert (un[~mask] == 0).all()


def test_gradient_matches_numpy():
    rng = np.random.default_rng(2)
    f = rng.normal(size=(8, 9, 10))
    want = np.gradient(f, 1.1, 0.9, 1.3)
    got = gradient(f, 1.3, 0.9, 1.1)  # ours returns (d/dz, d/dy, d/dx)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w_, rtol=1e-4, atol=1e-5)


def test_projection_cleaning_reduces_divergence():
    mask = _sphere_mask()
    u, v, w = _divergent_field()
    u, v, w = (a * mask for a in (u, v, w))
    res = clean_divergence_projection(u, v, w, mask, 1.0, 1.0, 1.0,
                                      iterations=3)
    # the collocated-grid scheme converges gradually: the scipy-LSQR
    # reference loop reaches exactly 2.09x on this field after 3 iterations
    assert float(res.mean_abs_div_final) < 0.55 * float(res.mean_abs_div_initial)
    # solid cells stay zero
    assert np.abs(np.asarray(res.u)[~mask]).max() == 0


def test_projection_cleaning_parity_vs_scipy_lsqr():
    """Full-loop parity: the reference algorithm implemented with scipy
    sparse + LSQR vs our matrix-free jitted loop."""
    mask = _sphere_mask(12)
    u, v, w = _divergent_field(12)
    u, v, w = (a * mask for a in (u, v, w))
    dx = dy = dz = 1.0

    uc, vc, wc = u.copy(), v.copy(), w.copy()
    A, idx_map = _assemble_laplacian(mask, dx, dy, dz)
    for _ in range(2):
        div = _numpy_divergence(uc, vc, wc, mask, dx, dy, dz)
        b = div[mask] - div[mask].mean()
        phi = lsqr(A, b, damp=1e-8, atol=1e-10, btol=1e-10, iter_lim=3000)[0]
        phi_grid = np.zeros(mask.shape)
        phi_grid[mask] = phi
        uc, vc, wc = (np.asarray(a) for a in consistent_correction(
            uc, vc, wc, phi_grid, mask, dx, dy, dz))

    res = clean_divergence_projection(u, v, w, mask, dx, dy, dz, iterations=2)
    scale = np.abs(uc[mask]).mean() + np.abs(wc[mask]).mean()
    for ours, ref in ((res.u, uc), (res.v, vc), (res.w, wc)):
        err = np.abs(np.asarray(ours)[mask] - ref[mask]).mean() / scale
        assert err < 5e-3, f"cleaned-field mismatch {err}"


def test_variational_cleaning_parity_vs_scipy():
    mask = _sphere_mask(10)
    u, v, w = _divergent_field(10)
    u, v, w = (a * mask for a in (u, v, w))
    dx = dy = dz = 1.0
    lam = 100.0
    n_fluid = int(mask.sum())

    # reference-style assembly: D operators via finite differencing of our
    # (already parity-checked) divergence function
    cols = []
    basis = np.zeros((n_fluid,))
    idx_map = np.full(mask.shape, -1, np.int64)
    idx_map[mask] = np.arange(n_fluid)

    def div_of(u_, v_, w_):
        # the variational system uses the 'operator' convention (the
        # reference's assembled Dx/Dy/Dz, physics.py:356-438)
        return _numpy_divergence(u_, v_, w_, mask, dx, dy, dz, "operator")[mask]

    # build dense D (small problem) by probing unit vectors
    D = np.zeros((n_fluid, 3 * n_fluid))
    zero = np.zeros(mask.shape)
    for j in range(n_fluid):
        e = np.zeros(mask.shape)
        e[tuple(np.argwhere(mask)[j])] = 1.0
        D[:, j] = div_of(e, zero, zero)
        D[:, n_fluid + j] = div_of(zero, e, zero)
        D[:, 2 * n_fluid + j] = div_of(zero, zero, e)

    A = np.eye(3 * n_fluid) + lam * D.T @ D
    rhs = np.concatenate([u[mask], v[mask], w[mask]])
    sol = np.linalg.solve(A, rhs)

    res = clean_divergence_variational(u, v, w, mask, dx, dy, dz,
                                       lambda_reg=lam, tol=1e-10)
    got = np.concatenate([np.asarray(res.u)[mask], np.asarray(res.v)[mask],
                          np.asarray(res.w)[mask]])
    np.testing.assert_allclose(got, sol, rtol=2e-3, atol=2e-4)


def test_poisson_dirichlet_parity():
    mask = _sphere_mask(12)
    rng = np.random.default_rng(3)
    rhs = rng.normal(size=mask.shape) * mask
    dirichlet = np.zeros(mask.shape, bool)
    dirichlet[0] = True
    dirichlet &= mask

    p = np.asarray(solve_poisson(rhs, mask, 1, 1, 1,
                                 dirichlet_mask=dirichlet,
                                 dirichlet_values=0.0, tol=1e-10))

    # scipy reference: reduced system on free nodes
    A, idx_map = _assemble_laplacian(mask, 1, 1, 1)
    free = mask & ~dirichlet
    fluid_ids = idx_map[mask]
    free_in_fluid = free[mask]
    A_ff = A[free_in_fluid][:, free_in_fluid]
    b_f = rhs[mask][free_in_fluid]
    p_f = spsolve(A_ff.tocsc(), b_f)
    want = np.zeros(mask.shape)
    want[free] = p_f

    np.testing.assert_allclose(p[free], want[free], rtol=5e-3, atol=5e-4)
    assert np.abs(p[dirichlet]).max() == 0
    assert np.abs(p[~mask]).max() == 0


def test_poisson_pure_neumann_gradient_parity():
    # pure-Neumann: solutions differ by a constant; compare gradients
    mask = _sphere_mask(12)
    rng = np.random.default_rng(4)
    rhs = (rng.normal(size=mask.shape) * mask)
    rhs -= mask * rhs[mask].mean()

    p = np.asarray(solve_poisson(rhs, mask, 1, 1, 1, tol=1e-10))
    A, idx_map = _assemble_laplacian(mask, 1, 1, 1)
    b = rhs[mask] - rhs[mask].mean()
    p_ref = lsqr(A, b, damp=1e-8, atol=1e-12, btol=1e-12, iter_lim=5000)[0]
    want = np.zeros(mask.shape)
    want[mask] = p_ref

    got_c = p[mask] - p[mask].mean()
    want_c = want[mask] - want[mask].mean()
    scale = np.abs(want_c).max()
    np.testing.assert_allclose(got_c, want_c, atol=2e-2 * scale)


def test_force_divergence_wall_bcs():
    mask = _sphere_mask(10)
    rng = np.random.default_rng(5)
    fx, fy, fz = (rng.normal(size=mask.shape) for _ in range(3))
    for bc in ("zero-neumann", "inhomogeneous"):
        div = np.asarray(force_divergence(fx, fy, fz, mask, 1, 1, 1, wall_bc=bc))
        assert np.isfinite(div).all()
    # uniform force field, all-fluid domain: zero interior divergence
    ones = np.ones((8, 8, 8))
    full = np.ones((8, 8, 8), bool)
    div = np.asarray(force_divergence(ones, ones, ones, full, 1, 1, 1,
                                      wall_bc="zero-neumann"))
    assert np.abs(div[1:-1, 1:-1, 1:-1]).max() < 1e-6


def test_clean_divergence_dispatcher():
    mask = _sphere_mask(10)
    u, v, w = _divergent_field(10)
    u, v, w = (a * mask for a in (u, v, w))
    for method in ("projection", "variational"):
        un, vn, wn = clean_divergence(u, v, w, mask, 1, 1, 1,
                                      iterations=1, method=method,
                                      lambda_reg=100.0, verbose=False)
        assert np.isfinite(np.asarray(un)).all()


def test_multigrid_preconditioner_accelerates_and_agrees():
    """MG-PCG must reach the same solution as Jacobi-PCG in far fewer
    iterations (the at-scale default for all Poisson solves)."""
    from ptv_interpolation_tpu.ops.solvers import pcg
    from ptv_interpolation_tpu.ops.stencils import laplacian_apply
    from ptv_interpolation_tpu.ops.multigrid import make_mg_preconditioner
    import jax.numpy as jnp

    mask = _sphere_mask(24)
    rng = np.random.default_rng(7)
    b = (rng.normal(size=mask.shape) * mask).astype(np.float32)
    b -= mask * b[mask].mean()
    maskf = jnp.asarray(mask, jnp.float32)
    n_fluid = float(mask.sum())

    def project(x):
        return (x - jnp.sum(x * maskf) / n_fluid) * maskf

    def neg_lap(phi):
        return -laplacian_apply(phi, mask, 1.0, 1.0, 1.0)

    m_inv = make_mg_preconditioner(mask, 1.0, 1.0, 1.0)
    res_mg = pcg(neg_lap, jnp.asarray(-b), M_inv=m_inv, project=project,
                 tol=1e-8, maxiter=500)
    res_jac = pcg(neg_lap, jnp.asarray(-b), project=project,
                  tol=1e-8, maxiter=5000)
    assert int(res_mg.iterations) < int(res_jac.iterations) / 5
    assert bool(res_mg.converged)
    x_mg = np.asarray(project(res_mg.x))
    x_j = np.asarray(project(res_jac.x))
    scale = np.abs(x_j).max()
    np.testing.assert_allclose(x_mg, x_j, atol=5e-4 * scale)


def test_divergence_dtd_diag_exact():
    """`divergence_dtd_diag` (the closed-form per-component diagonal of the
    masked 'operator'-variant D̃ᵀD̃) must equal the dense-jacobian column
    sums of squares on a random mask with domain-edge cells."""
    import jax
    import jax.numpy as jnp
    from ptv_interpolation_tpu.ops.stencils import divergence_dtd_diag

    rng = np.random.default_rng(0)
    shape = (4, 5, 6)
    mask = rng.random(shape) > 0.35
    mask[0, 0, 0] = True
    mask[-1, -1, -1] = True
    maskb = jnp.asarray(mask)
    maskf = maskb.astype(jnp.float32)

    def dtilde(u, v, w):
        return maskf * consistent_divergence(
            u * maskf, v * maskf, w * maskf, maskb, 1.0, 1.0, 1.0,
            variant="operator")

    n = int(np.prod(shape))
    got = divergence_dtd_diag(maskb, 1.0, 1.0, 1.0)
    for comp in range(3):
        def f(x, comp=comp):
            fields = [jnp.zeros(shape)] * 3
            fields[comp] = x.reshape(shape)
            return dtilde(*fields).ravel()
        J = jax.jacfwd(f)(jnp.zeros(n))
        want = np.asarray((J ** 2).sum(axis=0)).reshape(shape)
        np.testing.assert_allclose(np.asarray(got[comp]), want, atol=1e-6)


def test_variational_woodbury_matches_direct():
    """The Woodbury + parity-MG variational solve (default) must reproduce
    the literal 3n-CG formulation's cleaned field and converge in far fewer
    iterations (≤ half at production λ/tol)."""
    mask = _sphere_mask(22)
    fluid = np.asarray(mask)  # _sphere_mask returns the fluid indicator
    rng = np.random.default_rng(5)
    shape = fluid.shape
    mf = fluid.astype(np.float32)
    u = (0.1 * rng.normal(size=shape)).astype(np.float32) * mf
    v = (0.1 * rng.normal(size=shape)).astype(np.float32) * mf
    w = (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32) * mf

    kw = dict(lambda_reg=200.0, tol=1e-8, maxiter=2000)
    res_w = clean_divergence_variational(u, v, w, fluid, 1.0, 1.0, 1.0, **kw)
    res_d = clean_divergence_variational(u, v, w, fluid, 1.0, 1.0, 1.0,
                                         solver="direct", **kw)
    assert bool(res_w.converged) and bool(res_d.converged)
    assert int(res_w.cg_iterations) <= int(res_d.cg_iterations) / 2
    for a, b in ((res_w.u, res_d.u), (res_w.v, res_d.v), (res_w.w, res_d.w)):
        a, b = np.asarray(a), np.asarray(b)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < 1e-4, rel


def test_variational_woodbury_odd_anisotropic():
    """Woodbury vs direct at ODD extents and anisotropic spacing — the
    production regime (`/root/reference/run_porous_glass.py:15-17` →
    ~161×168×243 with downscale-2 anisotropy). Odd extents exercise the
    parity padding in `physics.py::to_parity` (never hit by even-cube
    tests); dx≠dy≠dz exercises the 2h MG stencil per axis."""
    shape = (21, 24, 27)
    az = np.arange(shape[0]) - shape[0] / 2 + 0.5
    ay = np.arange(shape[1]) - shape[1] / 2 + 0.5
    ax = np.arange(shape[2]) - shape[2] / 2 + 0.5
    Z, Y, X = np.meshgrid(az, ay, ax, indexing="ij")
    fluid = ~(((X / 8.0) ** 2 + (Y / 7.0) ** 2 + (Z / 6.0) ** 2) < 1.0)

    rng = np.random.default_rng(11)
    mf = fluid.astype(np.float32)
    u = (0.1 * rng.normal(size=shape)).astype(np.float32) * mf
    v = (0.1 * rng.normal(size=shape)).astype(np.float32) * mf
    w = (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32) * mf

    dx, dy, dz = 1.0, 1.3, 0.7
    kw = dict(lambda_reg=200.0, tol=1e-8, maxiter=2000)
    res_w = clean_divergence_variational(u, v, w, fluid, dx, dy, dz, **kw)
    res_d = clean_divergence_variational(u, v, w, fluid, dx, dy, dz,
                                         solver="direct", **kw)
    assert bool(res_w.converged) and bool(res_d.converged)
    assert int(res_w.cg_iterations) < int(res_d.cg_iterations)
    for a, b in ((res_w.u, res_d.u), (res_w.v, res_d.v), (res_w.w, res_d.w)):
        a, b = np.asarray(a), np.asarray(b)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < 1e-4, rel
    # the cleaner must actually clean
    assert float(res_w.mean_abs_div_final) < 0.5 * float(
        res_w.mean_abs_div_initial)
