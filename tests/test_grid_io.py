"""Grid conventions, mask resampling, morphology, and I/O round-trips —
parity-checked against scipy/reference semantics."""

import numpy as np
import pytest

from ptv_interpolation_tpu.grid import (
    Grid, binary_dilation6, binary_erosion6, create_grid,
    extract_boundary_particles, sample_mask_on_grid,
)
from ptv_interpolation_tpu.io import (
    PointCloud, load_mask, load_velocity_field, save_field_npz, save_field_tiff,
)
from ptv_interpolation_tpu.io.tiff import read_tiff, write_tiff
from ptv_interpolation_tpu.io.npz import FieldResult


def test_create_grid_matches_reference_convention():
    bounds = ((0, 64), (0, 32), (0, 16))
    g = create_grid(bounds, (64, 32, 16))
    # reference: x = linspace(xmin, xmax-1, nx)  (interpolator.py:54-56)
    np.testing.assert_allclose(g.x, np.linspace(0, 63, 64))
    np.testing.assert_allclose(g.y, np.linspace(0, 31, 32))
    np.testing.assert_allclose(g.z, np.linspace(0, 15, 16))
    assert g.shape == (16, 32, 64)
    X, Y, Z = g.meshgrid()
    assert X.shape == (16, 32, 64)
    # meshgrid (z,y,x) 'ij' layout: X varies along last axis
    np.testing.assert_allclose(np.asarray(X)[0, 0, :], g.x)
    np.testing.assert_allclose(np.asarray(Z)[:, 0, 0], g.z)
    dx, dy, dz = g.spacing
    assert dx == pytest.approx(1.0) and dz == pytest.approx(1.0)


def test_isotropic_resolution():
    g = create_grid(((0, 10), (0, 10), (0, 10)), 10)
    assert g.shape == (10, 10, 10)


def test_flat_coords_order():
    g = create_grid(((0, 4), (0, 3), (0, 2)), (4, 3, 2))
    pts = np.asarray(g.flat_coords())
    assert pts.shape == (24, 3)
    # first row is (x0, y0, z0); second advances x (C-order of (nz,ny,nx))
    np.testing.assert_allclose(pts[0], [0, 0, 0])
    np.testing.assert_allclose(pts[1], [1, 0, 0])
    np.testing.assert_allclose(pts[4], [0, 1, 0])


def test_sample_mask_on_grid_matches_scipy(rng):
    from scipy.interpolate import RegularGridInterpolator
    nz, ny, nx = 13, 17, 11
    mask_raw = rng.random((nz, ny, nx)) > 0.5
    bounds = ((2.0, 2.0 + nx), (1.0, 1.0 + ny), (0.0, float(nz)))
    grid = create_grid(bounds, (23, 9, 19))

    got = np.asarray(sample_mask_on_grid(mask_raw, grid, bounds))

    (xmin, xmax), (ymin, ymax), (zmin, zmax) = bounds
    z_c = np.linspace(zmin, zmax - 1, nz)
    y_c = np.linspace(ymin, ymax - 1, ny)
    x_c = np.linspace(xmin, xmax - 1, nx)
    interp = RegularGridInterpolator((z_c, y_c, x_c), mask_raw.astype(float),
                                     method="nearest", bounds_error=False, fill_value=0)
    X, Y, Z = (np.asarray(a) for a in grid.meshgrid())
    pts = np.stack([Z.ravel(), Y.ravel(), X.ravel()], axis=-1)
    want = interp(pts).reshape(X.shape) > 0.5
    assert (got == want).mean() > 0.999  # allow f32 rounding on exact .5 ties


def test_dilation_erosion_match_scipy(rng):
    import scipy.ndimage
    m = rng.random((10, 12, 9)) > 0.7
    struct = scipy.ndimage.generate_binary_structure(3, 1)
    for it in (1, 2):
        want = scipy.ndimage.binary_dilation(m, structure=struct, iterations=it)
        got = np.asarray(binary_dilation6(m, iterations=it))
        np.testing.assert_array_equal(got, want)
        want_e = scipy.ndimage.binary_erosion(m, structure=struct, iterations=it)
        got_e = np.asarray(binary_erosion6(m, iterations=it))
        np.testing.assert_array_equal(got_e, want_e)


def test_extract_boundary_particles_reference_semantics():
    # solid slab at x<3 in a 8^3 volume, fluid elsewhere
    nz = ny = nx = 8
    fluid = np.ones((nz, ny, nx), bool)
    fluid[:, :, :3] = False
    bounds = ((0.0, 8.0), (0.0, 8.0), (0.0, 8.0))
    bx, by, bz = extract_boundary_particles(fluid, bounds, sampling_step=1, thickness=1)
    # boundary = the x=2 plane of solid voxels adjacent to fluid at x=3
    assert len(bx) == nz * ny
    np.testing.assert_allclose(np.unique(bx), [2.0])
    # thickness=2 adds the x=1 layer
    bx2, _, _ = extract_boundary_particles(fluid, bounds, thickness=2)
    np.testing.assert_allclose(np.unique(bx2), [1.0, 2.0])
    # sampling
    bx3, _, _ = extract_boundary_particles(fluid, bounds, sampling_step=4)
    assert len(bx3) == int(np.ceil(nz * ny / 4))


def test_tiff_roundtrip(tmp_path):
    for dtype in (np.uint8, np.uint16, np.float32):
        arr = (np.arange(3 * 5 * 7).reshape(3, 5, 7) % 200).astype(dtype)
        p = str(tmp_path / f"vol_{np.dtype(dtype).name}.tif")
        write_tiff(p, arr)
        back = read_tiff(p)
        np.testing.assert_array_equal(back, arr)
        assert back.dtype == dtype


def test_tiff_zcyx_roundtrip(tmp_path):
    arr = np.random.default_rng(0).normal(size=(4, 3, 6, 5)).astype(np.float32)
    p = str(tmp_path / "stack.tif")
    write_tiff(p, arr, imagej=True, axes="ZCYX")
    back = read_tiff(p)
    assert back.shape == (4, 3, 6, 5)
    np.testing.assert_array_equal(back, arr)


def test_load_mask_nonzero_is_fluid(tmp_path):
    vol = np.zeros((4, 4, 4), np.uint8)
    vol[1, 2, 3] = 255
    p = str(tmp_path / "mask.tif")
    write_tiff(p, vol)
    m = load_mask(p)
    assert m.dtype == bool and m.sum() == 1 and m[1, 2, 3]


def test_npz_contract_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    shape = (4, 5, 6)
    res = FieldResult(
        x=np.arange(6.0), y=np.arange(5.0), z=np.arange(4.0),
        u=rng.normal(size=shape), v=rng.normal(size=shape), w=rng.normal(size=shape),
        mask=rng.random(shape) > 0.3,
        u_init=rng.normal(size=shape), v_init=rng.normal(size=shape),
        w_init=rng.normal(size=shape),
    )
    p = str(tmp_path / "field.npz")
    save_field_npz(p, res)
    back = load_velocity_field(p)
    np.testing.assert_array_equal(back.u, res.u)
    np.testing.assert_array_equal(back.mask, res.mask)
    assert back.has_dual
    np.testing.assert_array_equal(back.w_init, res.w_init)
    # raw npz keys match the reference contract
    raw = np.load(p)
    assert set(raw.keys()) == {"x", "y", "z", "u", "v", "w", "mask",
                               "u_init", "v_init", "w_init"}


def test_save_field_tiff(tmp_path):
    rng = np.random.default_rng(4)
    u, v, w = (rng.normal(size=(3, 4, 5)).astype(np.float32) for _ in range(3))
    p = str(tmp_path / "field.tif")
    save_field_tiff(p, u, v, w)
    back = read_tiff(p)
    assert back.shape == (3, 3, 4, 5)
    np.testing.assert_array_equal(back[:, 0], u)
    np.testing.assert_array_equal(back[:, 2], w)


def test_pointcloud_ops(tmp_path):
    cloud = PointCloud.from_arrays(
        np.array([0.0, 1.0, 5.0]), np.array([0.0, 2.0, 5.0]), np.array([0.0, 3.0, 5.0]),
        np.array([1.0, 2.0, 3.0]), np.array([4.0, 5.0, 6.0]), np.array([7.0, 8.0, 9.0]))
    off = cloud.offset(1, 2, 3)
    np.testing.assert_allclose(off.points[0], [1, 2, 3])
    sw = cloud.swap_xy()
    np.testing.assert_allclose(sw.x, cloud.y)
    np.testing.assert_allclose(sw.u, cloud.v)
    clipped = cloud.clip_to_bounds(((0, 2), (0, 3), (0, 4)))
    assert len(clipped) == 2


def test_csv_loader_aliases(tmp_path):
    p = str(tmp_path / "pts.csv")
    with open(p, "w") as f:
        f.write("x,y,z,vx,vy,vz\n1,2,3,0.1,0.2,0.3\n4,5,6,0.4,0.5,0.6\n")
    from ptv_interpolation_tpu.io import load_ptv_data
    cloud = load_ptv_data(p)
    assert len(cloud) == 2
    np.testing.assert_allclose(cloud.u, [0.1, 0.4], rtol=1e-6)
    with open(p, "w") as f:
        f.write("x,y,z,u\n1,2,3,0.1\n")
    with pytest.raises(IOError):
        load_ptv_data(p)


def test_native_csv_parser(tmp_path):
    """The C++ fast parser (if built) must agree with the numpy path."""
    import pytest as _pytest
    np_rng = np.random.default_rng(9)
    arr = np.concatenate([np_rng.uniform(0, 50, (500, 3)),
                          np_rng.normal(0, 1, (500, 3))], axis=1)
    p = str(tmp_path / "pts.csv")
    np.savetxt(p, arr, delimiter=",", header="x,y,z,vx,vy,vz",
               comments="", fmt="%.7g")
    try:
        from ptv_interpolation_tpu.io import fastcsv
        cloud = fastcsv.load(p)
    except OSError:
        _pytest.skip("native/libptvcsv.so not built")
    np.testing.assert_allclose(cloud.points, arr[:, :3], rtol=1e-5)
    np.testing.assert_allclose(cloud.values, arr[:, 3:], rtol=1e-5, atol=1e-6)
    # malformed numeric field → error → csvio falls back to numpy,
    # which raises the IOError contract
    with open(p, "w") as f:
        f.write("x,y,z,u,v,w\n1,2,3,oops,5,6\n")
    from ptv_interpolation_tpu.io import load_ptv_data
    with pytest.raises(IOError):
        load_ptv_data(p)


def test_orbax_checkpoint_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    from ptv_interpolation_tpu.io.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    rng = np.random.default_rng(11)
    shape = (4, 5, 6)
    res = FieldResult(
        x=np.arange(6.0), y=np.arange(5.0), z=np.arange(4.0),
        u=rng.normal(size=shape).astype(np.float32),
        v=rng.normal(size=shape).astype(np.float32),
        w=rng.normal(size=shape).astype(np.float32),
        mask=rng.random(shape) > 0.3,
    )
    p = str(tmp_path / "ckpt")
    save_checkpoint(p, res)
    back = load_checkpoint(p)
    np.testing.assert_allclose(np.asarray(back.u), res.u)
    np.testing.assert_array_equal(np.asarray(back.mask), res.mask)
    assert not back.has_dual


# ---------------------------------------------------------------------------
# Compressed TIFF reading (round-2: real tomography exports use LZW/deflate)
# ---------------------------------------------------------------------------

def _lzw_encode(data: bytes) -> bytes:
    """Test-local TIFF LZW encoder (independent of the production decoder):
    MSB-first packing, ClearCode emitted first, early-change width bumps."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    bitbuf, nbits = 0, 0
    width = 9
    table = {bytes((i,)): i for i in range(256)}
    next_code = 258

    def emit(code):
        nonlocal bitbuf, nbits
        bitbuf = (bitbuf << width) | code
        nbits += width
        while nbits >= 8:
            out.append((bitbuf >> (nbits - 8)) & 0xFF)
            nbits -= 8

    emit(CLEAR)
    w = b""
    for byte in data:
        c = w + bytes((byte,))
        if c in table:
            w = c
        else:
            emit(table[w])
            table[c] = next_code
            next_code += 1
            # early change: width grows when the NEXT code would not fit
            if next_code + 1 > (1 << width) and width < 12:
                width += 1
            if next_code >= 4094:
                emit(CLEAR)
                table = {bytes((i,)): i for i in range(256)}
                next_code = 258
                width = 9
            w = bytes((byte,))
    if w:
        emit(table[w])
    emit(EOI)
    if nbits:
        out.append((bitbuf << (8 - nbits)) & 0xFF)
    return bytes(out)


def _write_single_page_tiff(path, page: np.ndarray, compression: int,
                            predictor: int = 1):
    """Test-local minimal TIFF writer, independent of the production one."""
    import struct as _s
    import zlib as _z

    arr = np.ascontiguousarray(page)
    if predictor == 2:
        d = arr.astype(arr.dtype)
        d = np.concatenate([d[:, :1], np.diff(d, axis=1)], axis=1)
        raw = d.astype(d.dtype.newbyteorder("<")).tobytes()
    else:
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    if compression == 8:
        strip = _z.compress(raw)
    elif compression == 5:
        strip = _lzw_encode(raw)
    elif compression == 32773:
        # trivial PackBits: all-literal runs of <=128 bytes
        strip = b"".join(
            bytes((len(raw[i:i + 128]) - 1,)) + raw[i:i + 128]
            for i in range(0, len(raw), 128))
    else:
        strip = raw
    h, wdt = arr.shape
    bits = arr.dtype.itemsize * 8
    fmt = 3 if arr.dtype.kind == "f" else (2 if arr.dtype.kind == "i" else 1)
    tags = [
        (256, 4, 1, wdt), (257, 4, 1, h), (258, 3, 1, bits),
        (259, 3, 1, compression), (262, 3, 1, 1),
        (273, 4, 1, 0),  # patched below
        (277, 3, 1, 1), (278, 4, 1, h), (279, 4, 1, len(strip)),
        (317, 3, 1, predictor), (339, 3, 1, fmt),
    ]
    ifd_size = 2 + len(tags) * 12 + 4
    data_start = 8 + ifd_size
    blob = _s.pack("<2sHI", b"II", 42, 8)
    blob += _s.pack("<H", len(tags))
    for tag, typ, cnt, val in tags:
        if tag == 273:
            val = data_start
        blob += _s.pack("<HHII", tag, typ, cnt, val)
    blob += _s.pack("<I", 0)
    blob += strip
    with open(path, "wb") as f:
        f.write(blob)


@pytest.mark.parametrize("comp", [5, 8, 32773])
def test_tiff_compressed_read(tmp_path, comp):
    rng = np.random.default_rng(3)
    page = (rng.random((37, 53)) < 0.3).astype(np.uint8) * 255
    p = str(tmp_path / f"c{comp}.tif")
    _write_single_page_tiff(p, page, compression=comp)
    back = read_tiff(p)
    np.testing.assert_array_equal(back, page)


@pytest.mark.parametrize("comp", [5, 8])
def test_tiff_compressed_predictor2_read(tmp_path, comp):
    rng = np.random.default_rng(4)
    page = rng.integers(0, 65535, size=(23, 41), dtype=np.uint16)
    p = str(tmp_path / f"pred{comp}.tif")
    _write_single_page_tiff(p, page, compression=comp, predictor=2)
    back = read_tiff(p)
    np.testing.assert_array_equal(back, page)


def test_tiff_deflate_write_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    vol = rng.integers(0, 255, size=(6, 19, 31), dtype=np.uint8)
    p = str(tmp_path / "defl.tif")
    write_tiff(p, vol, compression="deflate")
    back = read_tiff(p)
    np.testing.assert_array_equal(back, vol)
    import os
    raw = str(tmp_path / "raw.tif")
    write_tiff(raw, np.zeros_like(vol))
    assert os.path.getsize(p) != os.path.getsize(raw)


def test_load_mask_deflate_compressed(tmp_path):
    """A real-world compressed mask must load
    (`/root/reference/interpolator.py:28-39` reads through tifffile)."""
    rng = np.random.default_rng(6)
    vol = (rng.random((8, 16, 16)) < 0.5).astype(np.uint8)
    p = str(tmp_path / "mask.tif")
    write_tiff(p, vol, compression="deflate")
    mask = load_mask(p)
    np.testing.assert_array_equal(mask, vol.astype(bool))


def test_tiff_exotic_compression_clear_error(tmp_path):
    page = np.zeros((4, 4), np.uint8)
    p = str(tmp_path / "jpeg.tif")
    _write_single_page_tiff(p, page, compression=7)  # JPEG
    with pytest.raises(IOError, match="compression 7"):
        read_tiff(p)


def test_lzw_multi_strip_and_big_stream(tmp_path):
    """Exercise LZW table resets (>4094 codes) on a larger page."""
    rng = np.random.default_rng(7)
    # structured data so LZW actually builds a deep table
    page = np.repeat(rng.integers(0, 8, size=(64, 128), dtype=np.uint8), 2,
                     axis=1)
    p = str(tmp_path / "big.tif")
    _write_single_page_tiff(p, page, compression=5)
    np.testing.assert_array_equal(read_tiff(p), page)


def test_tiff_compressed_external_tool(tmp_path):
    """Round-trip masks written by an EXTERNAL encoder (PIL), covering the
    real-world case of compressed tomography exports."""
    PIL_Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(8)
    page = (rng.random((64, 96)) < 0.4).astype(np.uint8) * 7
    for comp in ("tiff_lzw", "tiff_adobe_deflate", "packbits"):
        p = str(tmp_path / f"{comp}.tif")
        PIL_Image.fromarray(page).save(p, compression=comp)
        np.testing.assert_array_equal(read_tiff(p), page)


def _lzw_encode_tiff(data: bytes) -> bytes:
    """Reference TIFF-LZW encoder (tests only): standard dictionary LZW
    with the decoder's early-change width schedule — the decoder's table
    lags the encoder by one emission, so ``code == len(table)`` (KwKwK)
    streams are produced naturally on runs."""
    out = bytearray()
    bitbuf = 0
    nbits = 0
    width = 9

    def emit(code):
        nonlocal bitbuf, nbits
        bitbuf = (bitbuf << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append((bitbuf >> nbits) & 0xFF)

    def fresh():
        return {bytes([i]): i for i in range(256)}

    emit(256)                       # CLEAR
    table = fresh()
    nxt = 258
    sim_len = 258                   # decoder's table length
    first = True
    w = b""
    for byte in data:
        c = w + bytes([byte])
        if c in table:
            w = c
            continue
        emit(table[w])
        if first:
            first = False
        else:
            sim_len += 1
        if sim_len + 1 >= (1 << width) and width < 12:
            width += 1
        table[c] = nxt
        nxt += 1
        if nxt >= 4000:             # re-prime well before 12-bit overflow
            emit(256)
            if not first:
                sim_len += 1        # decoder appends on the code pre-CLEAR?
            table = fresh()
            nxt = 258
            sim_len = 258
            width = 9
            first = True
        w = bytes([byte])
    if w:
        emit(table[w])
    emit(257)                       # EOI
    if nbits:
        out.append((bitbuf << (8 - nbits)) & 0xFF)
    return bytes(out)


def test_lzw_decoders_roundtrip_real_streams():
    """Python and native LZW decoders on real dictionary streams (long
    runs → KwKwK cases, width bumps through 10/11/12 bits, clear
    resets)."""
    from ptv_interpolation_tpu.io import fasttiff
    from ptv_interpolation_tpu.io.tiff import lzw_decode

    rng = np.random.default_rng(7)
    # binary-mask-like data: long runs + noise patches; > 64 KB so the
    # dictionary cycles through every width and several resets
    parts = []
    for _ in range(60):
        parts.append(bytes([255]) * int(rng.integers(50, 2000)))
        parts.append(bytes(rng.integers(0, 255, int(rng.integers(20, 300)),
                                        dtype=np.uint8)))
        parts.append(bytes([0]) * int(rng.integers(50, 2000)))
    data = b"".join(parts)
    enc = _lzw_encode_tiff(data)
    assert len(enc) < len(data)     # actually compresses

    py = lzw_decode(enc)
    assert py == data
    nat = fasttiff.lzw_decode(enc, len(data))
    if nat is not None:             # native lib built in this checkout
        assert nat == data
