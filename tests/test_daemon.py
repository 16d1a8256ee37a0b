"""Serving daemon: warm-process dispatch for the CLIs.

The reference is a one-shot script with no compile step; our pipeline
pays a fresh-process warm-up per invocation (imports, device init,
tracing + compilation), so the framework ships a resident server
(`ptv_interpolation_tpu/daemon.py`) that the CLIs opt into with
``--daemon`` / ``PTV_DAEMON=1``. These tests run the real server as a
subprocess on the CPU backend."""

import os
import sys

import numpy as np
import pytest

from ptv_interpolation_tpu import daemon
from ptv_interpolation_tpu.datasets import sphere_pack


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("daemon_data")
    csv = str(d / "pts.csv")
    tif = str(d / "mask.tif")
    sphere_pack.generate(n_points=1500, size=32, filename=csv, maskname=tif,
                         voxel_units=True)
    return d, csv, tif


@pytest.fixture()
def daemon_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PTV_DAEMON_DIR", str(tmp_path / "sock"))
    monkeypatch.setenv("PTV_DAEMON_PLATFORM", "cpu")
    monkeypatch.setenv("PTV_DAEMON_IDLE_S", "300")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PYTHONPATH",
                       repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    yield
    daemon.main(["stop"])  # never leave a server behind


def test_daemon_dispatch_twice_and_control(dataset, daemon_env, capsys):
    d, csv, tif = dataset

    # no daemon yet
    assert daemon.main(["status"]) == 1

    npz1 = str(d / "d1.npz")
    rc = daemon.dispatch("interpolate", [
        "--input", csv, "--mask", tif, "--invert-mask",
        "--method", "nearest", "--output-npz", npz1, "--no-plot"])
    assert rc == 0
    assert os.path.exists(npz1)
    out = capsys.readouterr().out
    assert "Done." in out  # stdout was streamed back to this process

    # the server stayed up; the second job reuses the warm process
    assert daemon.main(["status"]) == 0
    npz2 = str(d / "d2.npz")
    rc = daemon.dispatch("interpolate", [
        "--input", csv, "--mask", tif, "--invert-mask",
        "--method", "nearest", "--output-npz", npz2, "--no-plot"])
    assert rc == 0
    assert os.path.exists(npz2)

    # both runs produced identical fields (same warm process, same inputs)
    a = np.load(npz1)
    b = np.load(npz2)
    np.testing.assert_array_equal(a["u"], b["u"])

    # bad argv → nonzero rc, daemon survives
    rc = daemon.dispatch("interpolate", ["--definitely-not-a-flag"])
    assert rc not in (0, None)
    assert daemon.main(["status"]) == 0

    assert daemon.main(["stop"]) == 0
    assert daemon.main(["status"]) == 1


def test_cli_daemon_flag_falls_back_inline(dataset, tmp_path, monkeypatch):
    """--daemon with an unreachable spawn falls back to the inline path."""
    d, csv, tif = dataset
    monkeypatch.setenv("PTV_DAEMON_DIR", str(tmp_path / "nosock"))
    # make spawning fail fast: point the daemon at an unusable interpreter
    monkeypatch.setattr(daemon, "_spawn", lambda *a, **k: False)
    from ptv_interpolation_tpu.cli.main import main as cli_main
    npz = str(d / "inline.npz")
    rc = cli_main(["--input", csv, "--mask", tif, "--invert-mask",
                   "--method", "nearest", "--output-npz", npz,
                   "--no-plot", "--daemon"])
    assert rc in (0, None)
    assert os.path.exists(npz)


def test_spawn_kills_a_server_that_never_answers(tmp_path, monkeypatch):
    """A spawned server that misses the start deadline is killed, so it
    cannot take the device while the CLI falls back to running inline."""
    import subprocess

    procs = []
    real_popen = subprocess.Popen

    def popen(*a, **k):
        p = real_popen([sys.executable, "-c", "import time; time.sleep(60)"],
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        procs.append(p)
        return p

    monkeypatch.setattr(subprocess, "Popen", popen)
    path = str(tmp_path / "daemon.sock")
    assert daemon._spawn(path, wait_s=0.3) is False
    assert len(procs) == 1
    assert procs[0].poll() is not None, "slow server left running"


def test_cli_refuses_inline_while_daemon_holds_device(dataset, tmp_path,
                                                      monkeypatch, capsys):
    """With a live server recorded beside the socket, the CLIs refuse to
    open the device a second time in-process."""
    d, csv, tif = dataset
    sock_dir = tmp_path / "held"
    sock_dir.mkdir()
    monkeypatch.setenv("PTV_DAEMON_DIR", str(sock_dir))
    monkeypatch.delenv("PTV_DAEMON", raising=False)
    (sock_dir / "daemon.sock.pid").write_text(str(os.getpid()))
    assert daemon.holder_pid() == os.getpid()
    from ptv_interpolation_tpu.cli.analyze_flow import main as analyze_main
    from ptv_interpolation_tpu.cli.main import main as cli_main
    npz = str(d / "refused.npz")
    rc = cli_main(["--input", csv, "--mask", tif, "--invert-mask",
                   "--method", "nearest", "--output-npz", npz, "--no-plot"])
    assert rc == 1 and not os.path.exists(npz)
    assert analyze_main(["--input", npz, "--no-interactive"]) == 1
    assert "holds the device" in capsys.readouterr().err
    # a stale record (dead pid) does not block
    (sock_dir / "daemon.sock.pid").write_text("999999999")
    assert daemon.holder_pid() is None
