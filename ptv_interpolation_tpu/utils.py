"""Observability utilities: per-stage wall-clock timers and profiler traces.

The reference's only observability is progress prints
(`/root/reference/interpolator.py:192-193`) and solver verbosity
(`physics.py:186`). Here every pipeline run can record stage timings
(:class:`StageTimings`) and wrap device work in a ``jax.profiler`` trace
(:func:`profiler_trace`) for TensorBoard-compatible timelines.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    — a fixed path, because the path is part of the cache's key: a cache
    that moves between runs never hits."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compilation_cache_dir` and return that path.

    Called by every CLI entry point and benchmark: each CLI run is a new
    process, and the cache turns its compiles into disk loads. Safe to call
    repeatedly."""
    import jax
    path = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_stamp(require: str | None = "gpu") -> dict:
    """``{"platform", "kind", "count"}`` of the default JAX devices, as a
    measurement must report them. With ``require`` (default ``"gpu"``) a
    different platform is an error: a timing taken on another device says
    nothing about this one, so there is no fallback."""
    import jax
    devs = jax.devices()
    stamp = {"platform": devs[0].platform, "kind": devs[0].device_kind,
             "count": len(devs)}
    if require is not None and stamp["platform"] != require:
        raise RuntimeError(f"needs a {require} device; JAX found {stamp}")
    return stamp


class StageTimings:
    """Accumulates named stage durations; used by the pipeline drivers."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self._order = []

    @contextlib.contextmanager
    def stage(self, name: str, verbose: bool = False):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            if name not in self._order:
                self._order.append(name)
            if verbose:
                print(f"  [timing] {name}: {dt:.3f}s")

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = ["--- Stage timings ---"]
        for name in self._order:
            dt = self.stages[name]
            lines.append(f"  {name:30s} {dt:8.3f}s ({dt / max(total, 1e-9):5.1%})")
        lines.append(f"  {'total':30s} {total:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Wrap a block in a ``jax.profiler`` trace when ``log_dir`` is given
    (view with TensorBoard / xprof); no-op otherwise."""
    if not log_dir:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield
