"""The one place that picks kernels by platform.

* ``gpu`` → ``"triton"``: the hand-written Pallas kernels compiled through
  Triton (``ops/fused_grid_knn.py``, ``ops/fused_mad.py``), the single-
  dispatch device repair, and the device-resident mesh pipeline of the
  drag analysis.
* ``cpu`` → ``"xla"``: the plain XLA forms of the same math, and the host
  mesh extraction.
* any other platform is an error: no kernel has been written or checked
  for it.

``interpret=True`` selects the Triton kernels on any platform, run by the
Pallas interpreter — the CPU tests' way into the kernel code. Interpret
mode is never chosen implicitly.
"""

from __future__ import annotations

import jax

_ROUTES = {"gpu": "triton", "cpu": "xla"}


def select_kernels(interpret: bool = False) -> str:
    """``"triton"`` or ``"xla"`` for the default JAX backend."""
    if interpret:
        return "triton"
    platform = jax.default_backend()
    try:
        return _ROUTES[platform]
    except KeyError:
        raise RuntimeError(
            f"no kernels for platform {platform!r}; supported: "
            f"{sorted(_ROUTES)}") from None
