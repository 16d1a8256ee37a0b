"""Drag validation vs closed-form solutions (pytest port of
validate_analysis.py:280-711) plus surface/sampling unit checks."""

import numpy as np
import pytest

from ptv_interpolation_tpu.drag import compute_interface_drag
from ptv_interpolation_tpu.ops.sampling import map_coordinates
from ptv_interpolation_tpu.surface import (
    marching_tetrahedra, orient_normals, triangle_geometry,
)


def test_map_coordinates_orders_match_scipy():
    from scipy.ndimage import map_coordinates as scipy_map
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(12, 13, 14))
    coords = np.stack([rng.uniform(1, 10, 200), rng.uniform(1, 11, 200),
                       rng.uniform(1, 12, 200)])
    for order in (0, 1):
        got = np.asarray(map_coordinates(vol, coords, order=order))
        want = scipy_map(vol, coords, order=order, mode="nearest")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # cubic: ours is Catmull-Rom, scipy's is a prefiltered interpolating
    # B-spline — different C¹ families that agree to ~1e-2 on smooth data
    # (drag integrals tolerate 20%)
    z, y, x = np.meshgrid(*(np.arange(n) for n in (12, 13, 14)), indexing="ij")
    smooth = np.sin(z / 3) * np.cos(y / 4) + 0.1 * x
    got = np.asarray(map_coordinates(smooth, coords, order=3))
    want = scipy_map(smooth, coords, order=3, mode="nearest")
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-2)
    # and it must exactly reproduce grid values at integer coords
    igrid = np.stack([np.full(5, 3.0), np.arange(5.0), np.arange(5.0) + 2])
    np.testing.assert_allclose(
        np.asarray(map_coordinates(smooth, igrid, order=3)),
        smooth[3, :5, 2:7].diagonal(), rtol=1e-5, atol=1e-5)


def test_marching_tetrahedra_sphere_area():
    """Surface area of an extracted sphere ≈ 4πR² within a few percent."""
    n = 48
    ax = np.arange(n) - n / 2 + 0.5
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    R = 14.0
    vol = ((X ** 2 + Y ** 2 + Z ** 2) < R ** 2).astype(float)
    tris = marching_tetrahedra(vol, 0.5)
    assert len(tris) > 1000
    centroids, areas, normals = triangle_geometry(tris)
    area = areas.sum()
    assert abs(area - 4 * np.pi * R ** 2) / (4 * np.pi * R ** 2) < 0.05
    # normals oriented into the sphere (increasing mask)
    normals = orient_normals(normals, centroids, vol)
    center = np.asarray([n / 2 - 0.5] * 3)
    inward = ((center - centroids) * normals).sum(axis=1)
    assert (inward > 0).mean() > 0.99


def test_marching_tetrahedra_watertight_closed_surface():
    """Closed surface ⇒ oriented area integral ≈ 0 (divergence theorem)."""
    n = 32
    ax = np.arange(n) - n / 2 + 0.5
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")
    vol = ((X ** 2 + 1.5 * Y ** 2 + 0.7 * Z ** 2) < 9.0 ** 2).astype(float)
    tris = marching_tetrahedra(vol, 0.5)
    centroids, areas, normals = triangle_geometry(tris)
    normals = orient_normals(normals, centroids, vol)
    net = (normals * areas[:, None]).sum(axis=0)
    assert np.abs(net).max() < 1e-2 * areas.sum()


@pytest.fixture(scope="module")
def stokes_sphere():
    """Analytical Stokes flow past a sphere (validate_analysis.py:280-361)."""
    nn = 80
    d = 1e-5
    U_inf, mu = 0.1, 1e-3
    radius = 15.0 * d
    ax = (np.arange(nn) - nn / 2) * d
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    r = np.where(r == 0, 1e-20, r)
    r_safe = np.maximum(r, radius * 0.5)
    t1 = 0.75 * radius / r_safe
    t2 = 0.25 * radius ** 3 / r_safe ** 3
    w = U_inf * (1 - t1 * (1 + z ** 2 / r_safe ** 2)
                 - t2 * (1 - 3 * z ** 2 / r_safe ** 2))
    u = U_inf * (-t1 * (x * z / r_safe ** 2) + t2 * (3 * x * z / r_safe ** 2))
    v = U_inf * (-t1 * (y * z / r_safe ** 2) + t2 * (3 * y * z / r_safe ** 2))
    p = -1.5 * mu * radius * U_inf * z / r ** 3
    mask_fluid = (r > radius).astype(int)
    return dict(u=u, v=v, w=w, p=p, mask=mask_fluid, d=d, mu=mu,
                radius=radius, U_inf=U_inf)


def test_stokes_sphere_drag_mesh(stokes_sphere):
    """Fz_v → −4πμaU, Fz_p → −2πμaU, ratio 1/2 (validate 20%/ratio window)."""
    s = stokes_sphere
    res = compute_interface_drag(s["u"], s["v"], s["w"], s["p"], s["mu"],
                                 s["d"], s["d"], s["d"], s["mask"],
                                 method="mesh")
    assert 1 in res
    d = res[1]
    target_v = -4 * np.pi * s["mu"] * s["radius"] * s["U_inf"]
    target_p = -2 * np.pi * s["mu"] * s["radius"] * s["U_inf"]
    err_v = abs(d["Fz_v"] - target_v) / abs(target_v)
    err_p = abs(d["Fz_p"] - target_p) / abs(target_p)
    assert err_v < 0.20, f"viscous force error {err_v:.2%}"
    assert err_p < 0.20, f"pressure force error {err_p:.2%}"
    ratio = abs(d["Fz_p"] / d["Fz_v"])
    assert 0.4 < ratio < 0.6, f"P/V ratio {ratio:.3f}"


@pytest.fixture(scope="module")
def poiseuille_drag_setup():
    nz = ny = nx = 40
    d = 20e-6
    mu = 1e-3
    coords = np.arange(40) * d
    z, y, x = np.meshgrid(coords, coords, coords, indexing="ij")
    cy = cx = coords.mean()
    radius = 15 * d
    r2 = (y - cy) ** 2 + (x - cx) ** 2
    mask_fluid = r2 < radius ** 2
    U_max = 1e-3
    w = U_max * (1 - r2 / radius ** 2)
    u = np.zeros_like(w)
    grad_p = -4 * mu * U_max / radius ** 2
    p = grad_p * z
    return dict(u=u, w=w, p=p, mask_fluid=mask_fluid, d=d, mu=mu,
                radius=radius, U_max=U_max, nz=nz)


def test_poiseuille_pipe_drag_mesh(poiseuille_drag_setup):
    """Wall drag F = τ_w·2πRL within 20%, shear fraction > 0.95
    (validate_analysis.py:363-428)."""
    s = poiseuille_drag_setup
    d, mu = s["d"], s["mu"]
    res = compute_interface_drag(s["u"], s["u"], s["w"], s["p"], mu,
                                 d, d, d, s["mask_fluid"].astype(int),
                                 method="mesh")
    dm = res[1]
    L = (s["nz"] - 1) * d
    tau_wall = mu * (-2 * s["U_max"] / s["radius"])
    target_f = tau_wall * 2 * np.pi * s["radius"] * L
    err = abs(dm["Fz_v"] - target_f) / abs(target_f)
    assert err < 0.20, f"mesh drag error {err:.2%}"
    assert abs(dm["Fz_p"]) < 1e-12
    shear_ratio = dm["Fz_v_tan"] / dm["Fz_v"]
    assert shear_ratio > 0.95, f"shear fraction {shear_ratio:.3f}"


def test_poiseuille_pipe_drag_staircase(poiseuille_drag_setup):
    """Staircase method: correct sign/scale (coarser than mesh) and the
    volume normalization that crashes the reference works here."""
    s = poiseuille_drag_setup
    d, mu = s["d"], s["mu"]
    mask_solid = (~s["mask_fluid"]).astype(int)
    total_volume = (40 * d) ** 3
    res = compute_interface_drag(s["u"], s["u"], s["w"], s["p"], mu,
                                 d, d, d, mask_solid, method="staircase",
                                 volume=total_volume)
    dm = res[1]
    L = (s["nz"] - 1) * d
    target_mag = abs(mu * (-2 * s["U_max"] / s["radius"])
                     * 2 * np.pi * s["radius"] * L)
    # integrating over the *solid* label yields the force ON the wall BY the
    # fluid: positive along flow. Staircase area inflation (~4/π) and the
    # one-sided gradient make it coarse — magnitude within a factor ~2.
    # (The reference's own validation comments its staircase check out,
    # validate_analysis.py:393-395.)
    assert dm["Fz_v"] > 0
    assert 0.5 < dm["Fz_v"] / target_mag < 2.0
    assert "Mz" in dm and np.isfinite(dm["Mz"])


def test_staircase_parity_vs_numpy_port(poiseuille_drag_setup):
    """Strongest staircase check: exact agreement with a literal numpy
    sweep implementing the reference's face logic
    (velocity_analysis.py:362-501)."""
    s = poiseuille_drag_setup
    d, mu = s["d"], s["mu"]
    mask_int = (~s["mask_fluid"]).astype(int)
    u, w, p = s["u"], s["w"], s["p"]

    want = {k: 0.0 for k in ("Fx_v", "Fy_v", "Fz_v", "Fz_p", "Area")}
    dA = [d * d] * 3
    comps = {"u": u, "v": u, "w": w}
    for axis in range(3):
        sc = [slice(None)] * 3
        sn = [slice(None)] * 3
        sc[axis] = slice(0, -1)
        sn[axis] = slice(1, None)
        m_c, m_n = mask_int[tuple(sc)], mask_int[tuple(sn)]
        for orient, (idx, fluid_slice, p_sign) in {
            "A": ((m_c == 0) & (m_n == 1), sc, +1),
            "B": ((m_c == 1) & (m_n == 0), sn, -1),
        }.items():
            if not idx.any():
                continue
            want["Area"] += idx.sum() * dA[axis]
            p_face = 0.5 * (p[tuple(sc)][idx] + p[tuple(sn)][idx])
            if axis == 0:
                want["Fz_p"] += p_sign * np.sum(p_face * dA[axis])
            for cname, f in comps.items():
                g = -2.0 * f[tuple(fluid_slice)][idx] / d
                factor = 2.0 if {0: "w", 1: "v", 2: "u"}[axis] == cname else 1.0
                key = {"u": "Fx_v", "v": "Fy_v", "w": "Fz_v"}[cname]
                want[key] -= np.sum(mu * factor * g * dA[axis])

    got = compute_interface_drag(u, u, w, p, mu, d, d, d, mask_int,
                                 method="staircase")[1]
    for k in ("Fx_v", "Fy_v", "Fz_v", "Area"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-15)


def test_multiphase_blob_classification():
    """Half-in-pore sphere: water/solid area split ≈ 50/50, zero drag for
    uniform internal velocity (validate_analysis.py:430-507)."""
    nn = 60
    d = 1e-5
    U_blob, mu = 0.1, 1e-3
    radius = 15.0 * d
    ax = (np.arange(nn) - nn / 2) * d
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2 + z ** 2)
    background = (x > 0).astype(int)       # pore for x>0, solid x<=0
    blob = (r <= radius).astype(int)
    u = np.zeros_like(x)
    w = np.full_like(x, U_blob)
    p = np.zeros_like(x)
    res = compute_interface_drag(u, u, w, p, mu, d, d, d, blob,
                                 method="mesh", background_mask=background)
    dm = res[1]
    split = dm["Area_water"] / dm["Area"]
    assert abs(split - 0.5) < 0.1, f"area split {split:.3f}"
    assert abs(dm["Fz_v"]) < 1e-10, "uniform flow must give zero drag"


def test_trapped_blob_drag_direction():
    """Stationary oil in a cavity under plug water flow: positive X drag of
    the right order (validate_analysis.py:509-711, simplified geometry)."""
    nx, ny, nz = 100, 60, 3
    d = 1e-6
    mu = 1e-3
    U_water = 1e-4
    x_vox = np.arange(nx)
    y_vox = np.arange(ny) - ny // 2
    cavity_h, depth = 25, 12
    x_start, x_end = 20, 80
    mid_x = (x_start + x_end) / 2
    x_rel = (x_vox - mid_x) / ((x_end - x_start) / 2)
    y_men = np.where((x_vox >= x_start) & (x_vox <= x_end),
                     -depth * (1 - x_rel ** 2), 0)
    y3 = np.broadcast_to(y_vox[None, :, None], (nz, ny, nx))
    x3 = np.broadcast_to(x_vox[None, None, :], (nz, ny, nx))
    men3 = np.broadcast_to(y_men[None, None, :], (nz, ny, nx))
    blob = ((y3 > -cavity_h) & (y3 <= men3)
            & (x3 >= x_start) & (x3 <= x_end)).astype(int)
    pore = ((y3 > 0) | (y3 > -cavity_h)).astype(int)
    u = np.where(y3 > men3, U_water, 0.0)
    v = np.zeros_like(u)
    w = np.zeros_like(u)
    p = np.zeros_like(u)
    res = compute_interface_drag(u, v, w, p, mu, d, d, d, blob,
                                 method="mesh", background_mask=pore)
    dm = res[1]
    tau_scale = mu * U_water / d
    f_scale = tau_scale * dm["Area"]
    assert dm["Fx_v"] > 0, "water must drag the oil forward"
    assert 0.01 * f_scale < dm["Fx_v"] < 10 * f_scale


def test_marching_tetrahedra_device_matches_host():
    """The device extractor must produce the same triangle SET as the
    host sweep (same Kuhn subdivision + case tables; only the emission
    order differs)."""
    from ptv_interpolation_tpu.surface import (
        marching_tetrahedra, marching_tetrahedra_device)

    rng = np.random.default_rng(4)
    zz, yy, xx = np.mgrid[0:24, 0:24, 0:24]
    vol = (((zz - 12.0) ** 2 + (yy - 11.0) ** 2 + (xx - 13.0) ** 2)
           < 8.0 ** 2).astype(np.float64)
    host = marching_tetrahedra(vol, level=0.5)
    dev = marching_tetrahedra_device(vol, level=0.5)
    assert dev.shape == host.shape
    # set comparison at 3-decimal rounding: the device path interpolates
    # crossings in f32 (device) vs the host's f64, so a razor-thin fraction
    # of vertices rounds differently (22/6936 at this fixture)
    hs = set(map(tuple, np.round(host.reshape(-1, 9), 3).tolist()))
    ds = set(map(tuple, np.round(dev.reshape(-1, 9), 3).tolist()))
    common = len(hs & ds)
    assert common / len(hs) > 0.99, f"only {common}/{len(hs)} shared"
    # and the total surface area must agree tightly (f32-rounding level)
    from ptv_interpolation_tpu.surface import triangle_geometry
    _, a_h, _ = triangle_geometry(host)
    _, a_d, _ = triangle_geometry(dev)
    np.testing.assert_allclose(a_d.sum(), a_h.sum(), rtol=1e-4)


def test_marching_tetrahedra_device_corner_cube_not_duplicated():
    """Regression: padded cube slots in the device extractor point at
    cube 0 (``jnp.nonzero`` fill_value=0). If cube (0,0,0) itself has a
    level crossing, every padded lane used to re-emit cube 0's triangles
    as valid, double-counting area and drag integrals. Validity must be
    masked with ``lane < m``."""
    from ptv_interpolation_tpu.surface import (
        marching_tetrahedra, marching_tetrahedra_device,
        mesh_geometry_device, triangle_geometry)

    # a blob overlapping the (0,0,0) corner so cube 0 is active; small
    # volume so the active count is far below the pow2 pad (lots of
    # padded lanes aliasing cube 0)
    zz, yy, xx = np.mgrid[0:8, 0:8, 0:8]
    vol = ((zz + yy + xx) < 6.5).astype(np.float64)
    host = marching_tetrahedra(vol, level=0.5)
    dev = marching_tetrahedra_device(vol, level=0.5)
    assert dev.shape == host.shape, (
        f"device emitted {dev.shape[0]} triangles vs host "
        f"{host.shape[0]} — padded cube-0 lanes leaked")
    _, a_h, _ = triangle_geometry(host)
    _, a_d, _ = triangle_geometry(dev)
    np.testing.assert_allclose(a_d.sum(), a_h.sum(), rtol=1e-4)

    geo, n_tri = mesh_geometry_device(vol, level=0.5)
    assert n_tri == len(host)
    np.testing.assert_allclose(
        float(np.asarray(geo["areas"]).sum()), a_h.sum(), rtol=1e-4)


def test_mesh_geometry_device_matches_host_pipeline():
    """Device mesh pipeline (extract + geometry + orient, lane-major)
    vs the host trio on the same volume: total area, centroid cloud,
    and oriented-normal flux must agree."""
    from ptv_interpolation_tpu.surface import (
        marching_tetrahedra, mesh_geometry_device, orient_normals,
        triangle_geometry)

    zz, yy, xx = np.mgrid[0:20, 0:22, 0:24]
    vol = (((zz - 10.0) ** 2 + (yy - 11.0) ** 2 + (xx - 12.0) ** 2)
           < 7.0 ** 2).astype(np.float64)
    spacing = (1.5, 1.0, 0.5)

    host_t = marching_tetrahedra(vol, level=0.5)
    c_h, a_h, n_h = triangle_geometry(host_t, spacing=spacing)
    n_h = orient_normals(n_h, c_h, vol, spacing=spacing)

    geo, n_tri = mesh_geometry_device(vol, level=0.5, spacing=spacing)
    assert n_tri == len(host_t)
    a_d = np.asarray(geo["areas"])
    assert np.isclose(a_d.sum(), a_h.sum(), rtol=1e-4)
    # oriented normals: for a solid sphere the area-weighted normal flux
    # through each axis ~0 and every normal points inward/outward
    # consistently — compare the area-weighted first moments
    for comp, nd in (("z", "nzp"), ("y", "nyp"), ("x", "nxp")):
        i = "zyx".index(comp)
        m_h = (n_h[:, i] * a_h).sum()
        m_d = float((np.asarray(geo[nd]) * a_d).sum())
        np.testing.assert_allclose(m_d, m_h, rtol=1e-3, atol=1e-3)
    # centroid cloud centers agree (area-weighted)
    for comp, cd in (("z", "cz"), ("y", "cy"), ("x", "cx")):
        i = "zyx".index(comp)
        m_h = (c_h[:, i] * a_h).sum() / a_h.sum()
        m_d = float((np.asarray(geo[cd]) * a_d).sum() / a_d.sum())
        np.testing.assert_allclose(m_d, m_h, rtol=1e-4)
