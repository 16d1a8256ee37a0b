"""Memory-level sharding of the CSR candidate store by z-slab ownership.

SURVEY.md §2.2 prescribes "particles sharded by tile ownership with halo
exchange" as the multi-device equivalent of the reference's only parallel
path (`/root/reference/interpolator.py:173-182`). Replicating the particle
store caps the framework at one chip's HBM; this module removes that cap
for the block-centric grid kernels:

* **Ownership**: the grid's z-axis is cut into one slab per device; device
  ``d`` owns the cell-list cells whose z-range intersects its slab plus a
  halo of ``1.6 × margin`` — the widened margin the repair stage probes —
  so both the main kernel and per-slab repair are served entirely from
  local HBM. The halo plays the role of the neighbor all-gather: it is
  materialized once at build time instead of exchanged every step (the
  point stores are static for a whole interpolation, unlike training
  activations, so a build-time halo strictly dominates a per-step
  collective).
* **Layout**: cell ids are z-major (``(cz·ncy + cy)·ncx + cx``), so a
  slab+halo cell window is one *contiguous* range of the cell-sorted
  particle rows. Each device gets (a) the global ``starts`` offsets
  **rebased** into its window — ``clip(starts - row0, 0, n_loc)``, so
  out-of-window cells read as empty while in-window cells keep their exact
  global counts; the kernels' f32 cell-index arithmetic is untouched and
  therefore bit-identical to the single-chip path — and (b) the contiguous
  slice of the sorted point/value stores, sentinel-padded to the uniform
  window capacity ``capW`` (row ``capW`` is always a far-sentinel row, so
  it serves as the local invalid-slot index).

Per-device bytes for the O(N) stores are ≈ ``total/n_dev + halo``; the
O(#cells) ``starts`` vector (bounded at 2²² cells = 16 MB by
``build_cell_list``) stays replicated — it is the cheap, shape-bounded
part of the store, and rebasing it on-device costs one clip.

Scope note: :func:`build_slab_store` slices the windows out of the
single-process global build (one gather), so the *eval-time* residency is
sharded while the build transits the default device once. On a multi-host
pod the same windows would be built per-host from each host's CSV shard
(the cell quantization and sort are already device-side,
``ops/neighbors._device_csr_build``) — the eval-time layout, which is
what the kernels and this module define, is unchanged by that.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ptv_interpolation_tpu.ops.neighbors import CellList, cell_meta_np

REPAIR_MARGIN_FACTOR = 1.6   # must match fused_grid_knn.fused_repair


@dataclasses.dataclass
class SlabStore:
    """Per-device slab+halo slices of the cell-sorted candidate store."""

    points_l: jax.Array    # (n_dev, capW + pad, 3) f32, sentinel-padded
    values_l: jax.Array    # (n_dev, capW + pad, V) f32, zero-padded
    row0: jax.Array        # (n_dev, 1) i32 — global row offset per window
    n_loc: jax.Array       # (n_dev, 1) i32 — real rows per window
    capW: int              # static uniform window capacity = sentinel index
    n_loc_np: np.ndarray   # host copy of per-device real row counts
    halo: float            # physical halo width (1.6 × margin)

    def per_device_bytes(self) -> int:
        """Eval-time candidate-store bytes resident per device (the O(N)
        arrays only; the replicated ``starts`` adds a bounded O(#cells))."""
        W = self.points_l.shape[1]
        V = self.values_l.shape[2]
        return W * (3 + V) * 4


@functools.partial(jax.jit, static_argnames=("W", "n_sent"))
def _gather_windows(points_sorted, values_sorted, row0, n_loc, W: int,
                    n_sent: int):
    lane = jnp.arange(W, dtype=jnp.int32)[None, :]
    idx = jnp.where(lane < n_loc, row0 + lane, n_sent)     # (n_dev, W)
    return points_sorted[idx], values_sorted[idx]


def build_slab_store(cells: CellList, values_sorted, z_slabs_np: np.ndarray,
                     bz: int, dz: float, margin: float,
                     pad: int = 1024) -> SlabStore:
    """Cut the cell-sorted store into per-device z-slab windows + halo.

    ``z_slabs_np``: (n_dev, slab) grid z-coordinates per device (the same
    padded slabs the sharded kernel evaluates). ``bz``/``dz``: block
    z-extent and grid z-spacing (the repair window geometry). The window
    arithmetic mirrors the device kernels' f32 ops with one cell of slack
    on each side, and the halo covers the repair stage's widened margin so
    per-slab repair needs no cross-device candidates.
    """
    n_dev, slab = z_slabs_np.shape
    origin, inv = cell_meta_np(cells)
    cell_size = 1.0 / inv
    ncx, ncy, ncz = cells.dims
    R = ncy * ncx
    n = cells.n_points

    margin2 = np.float32(REPAIR_MARGIN_FACTOR * float(margin))
    mc2z = int(math.ceil((bz * dz + 2.0 * float(margin2)) / cell_size)) + 1
    inv32 = np.float32(inv)
    oz = np.float32(origin[2])

    cz0 = np.empty(n_dev, np.int64)
    cz1 = np.empty(n_dev, np.int64)
    for d in range(n_dev):
        z_first = np.float32(z_slabs_np[d, 0])
        z_last = np.float32(z_slabs_np[d, slab - bz]) if slab >= bz else z_first
        b0 = int(np.floor(((z_first - margin2) - oz) * inv32))
        b1 = int(np.floor(((z_last - margin2) - oz) * inv32))
        cz0[d] = np.clip(b0 - 1, 0, ncz)
        cz1[d] = np.clip(b1 + mc2z + 1, 0, ncz)
        cz1[d] = max(cz1[d], cz0[d])

    if cells.starts_host is not None:
        starts_at = lambda i: int(cells.starts_host[i])           # noqa: E731
        row0_np = np.array([starts_at(int(c * R)) for c in cz0], np.int64)
        row1_np = np.array([starts_at(int(c * R)) for c in cz1], np.int64)
    else:
        idx = jnp.asarray(np.concatenate([cz0 * R, cz1 * R]), jnp.int32)
        vals = np.asarray(cells.starts[idx]).astype(np.int64)
        row0_np, row1_np = vals[:n_dev], vals[n_dev:]

    n_loc_np = row1_np - row0_np
    capW = int(max(int(n_loc_np.max()) if n_dev else 0, 8))
    W = capW + pad

    pts_l, vals_l = _gather_windows(
        cells.points_sorted, values_sorted,
        jnp.asarray(row0_np[:, None], jnp.int32),
        jnp.asarray(n_loc_np[:, None], jnp.int32), W, n)
    return SlabStore(points_l=pts_l, values_l=vals_l,
                     row0=jnp.asarray(row0_np[:, None], jnp.int32),
                     n_loc=jnp.asarray(n_loc_np[:, None], jnp.int32),
                     capW=capW, n_loc_np=n_loc_np.astype(np.int64),
                     halo=float(margin2))


def rebase_cells(starts_global, origin, inv_cell, points_local, row0_l,
                 n_loc_l, dims, cap: int, capW: int) -> CellList:
    """Per-device local :class:`CellList` (traced — runs inside shard_map).

    ``starts_global``: the replicated (n_cells+1,) offsets; ``row0_l`` /
    ``n_loc_l``: this device's scalar window offset/occupancy. The rebase
    is one clip: cells before the window floor at 0, cells after saturate
    at ``n_loc`` (both read as empty); in-window cells keep their exact
    global counts pointing into ``points_local``. ``capW`` (≥ every
    device's ``n_loc``) is the uniform static sentinel row index —
    ``points_local`` rows ≥ ``n_loc`` hold far-sentinel coordinates."""
    starts_reb = jnp.clip(starts_global - row0_l, 0, n_loc_l).astype(jnp.int32)
    return CellList(
        table=jnp.zeros((1, 1), jnp.int32),
        points_padded=jnp.full((1, 3), 1e19, jnp.float32),
        origin=origin,
        inv_cell=inv_cell,
        starts=starts_reb,
        order=jnp.zeros((1,), jnp.int32),
        points_sorted=points_local,
        dims=dims,
        cap=cap,
        n_pts=capW,
    )
