"""Device-mesh construction helpers.

The framework's scaling axis is problem size (particles N × grid points M),
parallelized SPMD-style: grid queries and z-slabs of fields are sharded
over a 1D mesh, and the at-scale grid kernels shard the cell-sorted
particle store by z-slab ownership + halo too (`parallel/slab_store.py`),
so neither the grid nor the particle cloud is bounded by one device's
memory. The generic query-sharded paths keep small particle sets
replicated (1M tracks ≈ 24 MB — one cheap broadcast). This replaces the
reference's only parallelism, the fork-based process pool chunking RBF
evaluation (`/root/reference/interpolator.py:173-182`).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"

_DISTRIBUTED_INITIALIZED = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Multi-host bootstrap: `jax.distributed.initialize()` driven by
    arguments or environment.

    The reference is single-host (its only parallelism is a fork pool,
    `/root/reference/interpolator.py:173-182`); the distributed backend
    here is JAX's built-in one, whose GSPMD collectives XLA hands to NCCL.
    Nothing discovers a cluster by itself: pass the coordinator address
    (``host:port``), the process count and this process's id, or set the
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` environment variables JAX reads itself.

    Call once per process, before :func:`make_mesh` — afterwards
    ``jax.devices()`` spans the whole job and every mesh/jit path in
    ``parallel/`` works unchanged across hosts. The 1-D mesh suits cards
    joined all to all (NVLink within a host): every pair of devices
    talks at the same rate, so the mesh follows the algorithm alone.
    Returns True if initialization ran, False if it was already done or
    this is a plainly single-process environment.
    """
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED:
        return False
    import os
    env_hints = "JAX_COORDINATOR_ADDRESS" in os.environ
    if coordinator_address is None and num_processes is None and not env_hints:
        return False  # single-process: nothing to do
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    jax.distributed.initialize(**kwargs)
    _DISTRIBUTED_INITIALIZED = True
    return True


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """A 1D mesh over (the first ``n_devices``) available devices.

    In a multi-host job (after :func:`initialize_distributed`) this spans
    every device in the job, not just the local ones."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading dimension (query rows / z-slabs) over the mesh."""
    return NamedSharding(mesh, P(axis_name))


def shard_fields(mesh: Mesh, *fields, axis_name: str = DATA_AXIS):
    """device_put (nz, ny, nx) fields with z sharded over the mesh — the
    layout under which the stencil/CG physics runs SPMD with XLA inserting
    one-voxel halo exchanges (collective-permute) automatically."""
    sharding = row_sharded(mesh, axis_name)
    out = tuple(jax.device_put(f, sharding) for f in fields)
    return out if len(out) > 1 else out[0]
