"""ptv_interpolation_tpu — a JAX scattered-data interpolation framework for GPUs.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
``tombultreys/ptv_interpolation`` (3D Particle Tracking Velocimetry
post-processing for porous media): scattered-vector loading & filtering,
six interpolation methods onto regular grids, divergence-free cleaning,
pressure/permeability/drag analysis, and interactive visualization —
designed SPMD-first for device meshes rather than translated from the
reference's scipy/process-pool architecture.

Layer map (bottom-up):
  grid, io          — core types, conventions, artifacts (host+device)
  ops               — neighbor search, stencils, solvers, sampling (device)
  interpolate       — IDW / sibson / local+global RBF / Delaunay-linear
  filtering         — outlier rejection (threshold + kNN-MAD)
  physics           — FV divergence, projection & variational cleaning, Poisson
  analysis, drag    — strain/vorticity/dissipation/ξ/permeability/pressure/drag
  parallel          — mesh sharding of the hot paths
  pipeline, analyze — end-to-end drivers (CLI-compatible with the reference)
  viz               — matplotlib slice viewers over the same NPZ contract
"""

__version__ = "0.1.0"

from ptv_interpolation_tpu.grid import (
    Grid,
    create_grid,
    extract_boundary_particles,
    grid_from_mask_shape,
    sample_mask_on_grid,
)
from ptv_interpolation_tpu.io import (
    FieldResult,
    PointCloud,
    load_mask,
    load_ptv_data,
    load_velocity_field,
    save_field_npz,
    save_field_tiff,
)

__all__ = [
    "Grid",
    "create_grid",
    "grid_from_mask_shape",
    "sample_mask_on_grid",
    "extract_boundary_particles",
    "PointCloud",
    "FieldResult",
    "load_ptv_data",
    "load_mask",
    "load_velocity_field",
    "save_field_npz",
    "save_field_tiff",
]
