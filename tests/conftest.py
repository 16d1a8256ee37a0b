"""Test configuration.

By default every test runs on the CPU, with an 8-device virtual mesh
(``xla_force_host_platform_device_count=8``) standing in for several cards
in the multi-device tests; the Triton kernels run there in the Pallas
interpreter. Tests marked ``gpu`` need an NVIDIA card. They run when
``JAX_PLATFORMS`` names the GPU::

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernels.py

and skip elsewhere — the ``gpu`` fixture decides, when the test runs.
"""

import os

_ON_GPU = os.environ.get("JAX_PLATFORMS", "cpu") in ("cuda", "gpu")
if not _ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not _ON_GPU:
    # pin through jax.config as well: a GPU the machine may have must not
    # be initialized by the CPU suite
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

if not _ON_GPU:
    assert len(jax.devices()) >= 8, (
        f"expected 8 virtual CPU devices, got {jax.devices()}")


def pytest_configure(config):
    """Build the native loaders when absent so their parity tests and
    load-time known-answer self-tests actually run (the binaries are not
    committed; the build is a few seconds of g++)."""
    import pathlib
    import subprocess

    native = pathlib.Path(__file__).resolve().parent.parent / "native"
    libs = [native / "libptvcsv.so", native / "libptvtiff.so"]
    if native.is_dir() and not all(p.exists() for p in libs):
        try:
            subprocess.run(["sh", str(native / "build.sh")], check=True,
                           capture_output=True, timeout=120)
        except Exception as e:  # tests that need the libs will skip/fail
            print(f"warning: native build failed: {e}")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The GPU the ``gpu``-marked tests run on; skips without one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/test_gpu_kernels.py")
    return dev
