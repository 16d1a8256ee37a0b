"""Checkpoint / resume for sharded intermediates (orbax-backed).

The reference's checkpointing is file-level: the NPZ field contract joins
its two pipelines (`/root/reference/main.py:221-226`, SURVEY §5). That
contract is kept (`io/npz.py`) as the portable artifact; this module adds
a device-native layer on top — orbax array checkpoints that preserve device
shardings, so a multi-device run can resume without gathering fields to one
host. Falls back with a clear error when orbax isn't installed.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ptv_interpolation_tpu.io.npz import FieldResult


def _ocp():
    try:
        import orbax.checkpoint as ocp
        return ocp
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "orbax-checkpoint is required for sharded checkpoints; "
            "use save_field_npz for the portable NPZ artifact instead") from e


def save_checkpoint(path: str, result: FieldResult):
    """Write a FieldResult as an orbax checkpoint (sharding-preserving)."""
    ocp = _ocp()
    path = os.path.abspath(path)
    tree = {
        "x": np.asarray(result.x), "y": np.asarray(result.y),
        "z": np.asarray(result.z),
        "u": result.u, "v": result.v, "w": result.w,
    }
    if result.mask is not None:
        tree["mask"] = result.mask
    if result.has_dual:
        tree.update(u_init=result.u_init, v_init=result.v_init,
                    w_init=result.w_init)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree, force=True)
    ckptr.wait_until_finished()


def load_checkpoint(path: str, shardings=None) -> FieldResult:
    """Load a FieldResult checkpoint; pass a dict of jax shardings to
    restore fields directly onto a device mesh."""
    ocp = _ocp()
    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    if shardings is None:
        tree = ckptr.restore(path)
    else:
        import jax
        meta = ckptr.metadata(path)
        # StepMetadata (orbax >= 0.11) carries the array tree under
        # item_metadata.tree; older releases returned the tree directly.
        tree_meta = getattr(getattr(meta, "item_metadata", meta), "tree", meta)
        targets = jax.tree_util.tree_map(
            lambda m: jax.ShapeDtypeStruct(
                m.shape, m.dtype,
                sharding=shardings.get("field") if m.shape and len(m.shape) == 3
                else None) if hasattr(m, "shape") else m,
            dict(tree_meta))
        tree = ckptr.restore(path, targets)
    return FieldResult(
        x=np.asarray(tree["x"]), y=np.asarray(tree["y"]),
        z=np.asarray(tree["z"]),
        u=tree["u"], v=tree["v"], w=tree["w"],
        mask=tree.get("mask"),
        u_init=tree.get("u_init"), v_init=tree.get("v_init"),
        w_init=tree.get("w_init"),
    )
