"""Persistent serving daemon: keep one warm process holding the JAX client.

Why this exists: a CLI-shaped tool pays a fresh-process "first call" cost on
every invocation — Python imports, device initialization, per-program
tracing, and compiling (or loading from the persistent cache) every
program. The reference has the same shape (`/root/reference/main.py` is a
one-shot script) but its scipy path has no compile step to amortize; ours
does, so the answer is a resident server: the first request pays the
warm-up once, every later request runs at warm-process speed.

One process per card: a JAX process reserves most of the device's memory
when it starts, so a second one on the same card fails for want of memory.
The server therefore records its pid beside its socket, and the CLIs refuse
to run inline while a live server holds the device (:func:`inline_blocked`).

Protocol (newline-delimited JSON over a Unix socket, one request per
connection, served strictly serially — ONE process owns the device):

  client → server: {"entry": "interpolate"|"analyze", "argv": [...],
                    "cwd": "/abs/path"}
  server → client: {"t": "out", "d": "<chunk>"}   (stdout/stderr, streamed)
                   {"t": "rc", "d": <int>}         (final)

Special entries: "ping" (readiness / status) and "shutdown".

Opt-in only: the CLIs dispatch here when ``--daemon`` is passed or
``PTV_DAEMON=1`` is set, spawning the server on first use.  The server
exits after ``PTV_DAEMON_IDLE_S`` (default 1800 s) without requests.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import time

__all__ = ["socket_path", "dispatch", "serve", "main"]

_IDLE_DEFAULT = 1800.0


def socket_path() -> str:
    import tempfile
    d = (os.environ.get("PTV_DAEMON_DIR")
         or os.path.join(tempfile.gettempdir(), f"ptv-daemon-{os.getuid()}"))
    return os.path.join(d, "daemon.sock")


def _pid_path(path: str) -> str:
    return path + ".pid"


def holder_pid(path: str | None = None) -> int | None:
    """Pid of a live server that owns the socket ``path``, else None."""
    try:
        with open(_pid_path(path or socket_path())) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return None
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return None
    except PermissionError:
        pass                      # alive, owned by another user
    return pid


def inline_blocked() -> bool:
    """True (after saying why on stderr) when a live server holds the
    device, so running a job in this process would open it a second time."""
    if os.environ.get("PTV_IN_DAEMON"):
        return False
    pid = holder_pid()
    if pid is None:
        return False
    print(f"ptv-daemon (pid {pid}) holds the device; run through it with "
          f"--daemon, or stop it first (ptv-daemon stop)", file=sys.stderr)
    return True


def _ensure_sock_dir(path: str) -> None:
    d = os.path.dirname(path)
    os.makedirs(d, mode=0o700, exist_ok=True)
    os.chmod(d, 0o700)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class _StreamWriter(io.TextIOBase):
    """File-like that frames writes as {"t":"out"} messages to the client."""

    def __init__(self, conn: socket.socket):
        self._conn = conn

    def writable(self):  # pragma: no cover - io protocol
        return True

    def write(self, s: str) -> int:
        if s:
            try:
                msg = json.dumps({"t": "out", "d": s}) + "\n"
                self._conn.sendall(msg.encode())
            except OSError:
                pass  # client went away; keep running the job
        return len(s)


def _run_entry(entry: str, argv: list[str]) -> int:
    os.environ["PTV_IN_DAEMON"] = "1"  # CLIs must not re-dispatch to us
    if entry == "interpolate":
        from ptv_interpolation_tpu.cli.main import main as fn
    elif entry == "analyze":
        from ptv_interpolation_tpu.cli.analyze_flow import main as fn
    else:
        raise ValueError(f"unknown entry {entry!r}")
    try:
        rc = fn(argv)
        return 0 if rc is None else int(rc)
    except SystemExit as e:  # argparse errors etc.
        code = e.code
        return code if isinstance(code, int) else (0 if code is None else 1)


def serve(path: str | None = None, idle_s: float | None = None) -> None:
    path = path or socket_path()
    if idle_s is None:
        idle_s = float(os.environ.get("PTV_DAEMON_IDLE_S", _IDLE_DEFAULT))
    _ensure_sock_dir(path)
    with contextlib.suppress(FileNotFoundError):
        os.unlink(path)

    # Pin the platform before any backend use when asked (tests use cpu).
    plat = os.environ.get("PTV_DAEMON_PLATFORM")
    if plat:
        import jax
        jax.config.update("jax_platforms", plat)
    from ptv_interpolation_tpu.utils import enable_compilation_cache
    enable_compilation_cache()

    with open(_pid_path(path), "w") as f:
        f.write(str(os.getpid()))
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    os.chmod(path, 0o600)
    srv.listen(8)
    srv.settimeout(min(idle_s, 60.0))
    last = time.time()
    try:
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                if time.time() - last > idle_s:
                    return
                continue
            last = time.time()
            with conn:
                try:
                    stop = _handle(conn)
                except Exception:
                    stop = False
            if stop:
                return
    finally:
        srv.close()
        for p in (path, _pid_path(path)):
            with contextlib.suppress(FileNotFoundError):
                os.unlink(p)


def _handle(conn: socket.socket) -> bool:
    """Serve one request; returns True if the server should shut down."""
    buf = b""
    conn.settimeout(30.0)
    while not buf.endswith(b"\n"):
        chunk = conn.recv(1 << 16)
        if not chunk:
            return False
        buf += chunk
    req = json.loads(buf.decode())
    entry = req.get("entry")

    def reply(rc: int) -> None:
        with contextlib.suppress(OSError):
            conn.sendall((json.dumps({"t": "rc", "d": rc}) + "\n").encode())

    if entry == "ping":
        reply(0)
        return False
    if entry == "shutdown":
        reply(0)
        return True

    conn.settimeout(None)  # jobs can run for minutes
    cwd = req.get("cwd")
    prev_cwd = os.getcwd()
    out = _StreamWriter(conn)
    try:
        if cwd:
            os.chdir(cwd)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            rc = _run_entry(entry, list(req.get("argv") or []))
    except Exception as e:
        out.write(f"daemon: job failed: {type(e).__name__}: {e}\n")
        rc = 1
    finally:
        os.chdir(prev_cwd)
    reply(rc)
    return False


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

def _connect(path: str, timeout: float = 1.0) -> socket.socket | None:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(path)
        return s
    except OSError:
        s.close()
        return None


def _request(sock: socket.socket, req: dict,
             echo: bool = True) -> int:
    try:
        sock.sendall((json.dumps(req) + "\n").encode())
    except OSError:
        return 1  # server tore down between connect and send
    sock.settimeout(None)
    buf = b""
    while True:
        try:
            chunk = sock.recv(1 << 16)
        except OSError:
            return 1  # reset during server shutdown = daemon gone
        if not chunk:
            return 1  # daemon died mid-job
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if not line.strip():
                continue
            msg = json.loads(line.decode())
            if msg["t"] == "out":
                if echo:
                    sys.stdout.write(msg["d"])
                    sys.stdout.flush()
            elif msg["t"] == "rc":
                return int(msg["d"])


def _spawn(path: str, wait_s: float = 120.0) -> bool:
    """Start a server and wait for it to answer. A server that has not
    answered within ``wait_s`` is killed: left running, it would take the
    device while the caller falls back to running inline."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ptv_interpolation_tpu.daemon", "serve", path],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    deadline = time.time() + wait_s
    while time.time() < deadline:
        if proc.poll() is not None:
            return False
        s = _connect(path)
        if s is not None:
            with s:
                if _request(s, {"entry": "ping"}, echo=False) == 0:
                    return True
        time.sleep(0.1)
    proc.kill()
    proc.wait()
    for p in (path, _pid_path(path)):
        with contextlib.suppress(FileNotFoundError):
            os.unlink(p)
    return False


def dispatch(entry: str, argv: list[str],
             spawn: bool = True) -> int | None:
    """Run `entry(argv)` on the daemon; None = unavailable (run inline)."""
    path = socket_path()
    s = _connect(path)
    if s is None and spawn:
        if not _spawn(path):
            return None
        s = _connect(path)
    if s is None:
        return None
    with s:
        return _request(s, {"entry": entry, "argv": argv,
                            "cwd": os.getcwd()})


def wants_daemon(args_daemon_flag: bool) -> bool:
    return bool(args_daemon_flag) or os.environ.get("PTV_DAEMON") == "1"


# ---------------------------------------------------------------------------
# ptv-daemon control CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = argv[0] if argv else "status"
    path = argv[1] if len(argv) > 1 else socket_path()
    if cmd == "serve":                       # foreground server (internal)
        serve(path)
        return 0
    if cmd == "start":
        s = _connect(path)
        if s is not None:
            with s:
                if _request(s, {"entry": "ping"}, echo=False) == 0:
                    print(f"daemon already running at {path}")
                    return 0
        ok = _spawn(path)
        print(f"daemon {'started' if ok else 'FAILED to start'} at {path}")
        return 0 if ok else 1
    if cmd == "stop":
        s = _connect(path)
        if s is None:
            print("no daemon running")
            return 0
        with s:
            _request(s, {"entry": "shutdown"}, echo=False)
        # The server unlinks the socket on its way out; wait for that so a
        # status/start issued right after `stop` can't hit the closing
        # listener and read a half-dead daemon.
        deadline = time.time() + 10.0
        while time.time() < deadline and os.path.exists(path):
            time.sleep(0.05)
        print("daemon stopped")
        return 0
    if cmd == "status":
        s = _connect(path)
        if s is not None:
            with s:
                if _request(s, {"entry": "ping"}, echo=False) == 0:
                    print(f"daemon running at {path}")
                    return 0
        print("no daemon running")
        return 1
    print(f"usage: ptv-daemon start|stop|status [socket]", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
