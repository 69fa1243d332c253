"""The port's service daemon, `python -m distributed_plonk_tpu_torch.service`,
as an operator starts it, on the CPU (`--device cpu`), with the live
console against it. The console is `scripts/console.py`: it uses the
standard library only and renders any ObsServer, so it serves the port's
daemon unchanged; it runs as a child process and nothing imports it.

- `--autoscale dry --slo-standard-s 30`: the start line says
  "autoscale": "dry"; /autoscale reports the mode, the tick
  (autoscale.TICK_S), the SLO target and ticks that keep counting, and
  no decision is applied and no actuation counter is published;
  `console.py --once --logs 3` exits 0 and prints the service's
  readiness and the dry controller;
- the default mode attaches nothing: "autoscale": "0" in the start line,
  /autoscale answers 404 and the console shows the controller off;
- an unknown mode is a flag error (exit 2, nothing listens), where the
  JAX package reads an unknown DPT_AUTOSCALE as off;
- SIGTERM drains a daemon whose dry autoscaler ticks, and it exits 0.
"""

import json
import os
import select
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from distributed_plonk_tpu_torch.service.autoscale import TICK_S

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
CONSOLE = os.path.join(REPO, "scripts", "console.py")
DAEMON = [sys.executable, "-m", "distributed_plonk_tpu_torch.service",
          "--port", "0", "--obs-port", "0", "--device", "cpu"]
START_LIMIT_S = 120
ENV = dict(os.environ, OMP_NUM_THREADS="1")


class Daemon:
    """One daemon process; `start` holds its start line (JSON)."""

    def __init__(self, log_path, *flags):
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(DAEMON + list(flags), cwd=REPO,
                                     stdout=subprocess.PIPE, stderr=self.log,
                                     text=True, env=ENV)
        self.start = self._start_line()
        self.obs = "http://" + self.start["obs"]

    def _start_line(self):
        deadline = time.monotonic() + START_LIMIT_S
        while time.monotonic() < deadline:
            ready, _, _ = select.select([self.proc.stdout], [], [], 1.0)
            if ready:
                line = self.proc.stdout.readline()
                if line.startswith("{"):
                    return json.loads(line)
            assert self.proc.poll() is None, "the daemon exited"
        raise AssertionError("no start line in %d s" % START_LIMIT_S)

    def get(self, path):
        with urllib.request.urlopen(self.obs + path, timeout=30) as r:
            return json.loads(r.read())

    def stop(self):
        """SIGTERM; returns the exit code and the rest of stdout."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            rest, _ = self.proc.communicate(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.log.close()
        return self.proc.returncode, rest


def console(daemon, *flags):
    return subprocess.run(
        [sys.executable, CONSOLE, "--obs", daemon.start["obs"], *flags],
        cwd=REPO, capture_output=True, text=True, timeout=60)


def wait_ticks(daemon, at_least, timeout_s=30):
    deadline = time.monotonic() + timeout_s
    while True:
        state = daemon.get("/autoscale")
        if state["ticks"] >= at_least:
            return state
        assert time.monotonic() < deadline, state
        time.sleep(0.1)


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    d = Daemon(tmp_path_factory.mktemp("dry") / "daemon.log",
               "--autoscale", "dry", "--slo-standard-s", "30")
    yield d
    if d.proc.poll() is None:
        d.proc.kill()
        d.proc.wait()
    d.log.close()


def test_dry_daemon_ticks_and_applies_nothing(dry):
    assert dry.start["autoscale"] == "dry"
    assert dry.start["device"] == "cpu"
    assert dry.start["listening"].startswith("127.0.0.1:")
    first = wait_ticks(dry, 1)
    assert first["mode"] == "dry" and first["tick_s"] == TICK_S
    assert first["targets"]["slo_p95_standard_s"] == 30.0
    later = wait_ticks(dry, first["ticks"] + 1)
    assert all(not d["applied"] for d in later["last_decisions"]), later
    with urllib.request.urlopen(dry.obs + "/metrics", timeout=30) as r:
        text = r.read().decode()
    assert "autoscale_ticks" in text
    for applied in ("autoscale_scale_ups", "autoscale_scale_downs",
                    "autoscale_lease_resizes", "autoscale_sheds",
                    "autoscale_actuator_errors"):
        assert applied not in text, applied


def test_console_once_shows_readiness_and_the_dry_controller(dry):
    out = console(dry, "--once", "--logs", "3")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("service  ok=True"), out.stdout
    assert "draining=False" in lines[0]
    assert any(ln.startswith("autoscale mode=dry") for ln in lines)
    assert any(ln.startswith("logs     (last 3") for ln in lines)
    assert any("autoscale/start" in ln for ln in lines), out.stdout


def test_default_mode_attaches_nothing(tmp_path):
    d = Daemon(tmp_path / "daemon.log")
    try:
        assert d.start["autoscale"] == "0"
        with pytest.raises(urllib.error.HTTPError) as e:
            d.get("/autoscale")
        assert e.value.code == 404
        out = console(d, "--once")
        assert out.returncode == 0, out.stderr[-2000:]
        assert "autoscale (off)" in out.stdout.splitlines()
    finally:
        rc, _ = d.stop()
    assert rc == 0


def test_unknown_mode_is_a_flag_error():
    out = subprocess.run(DAEMON + ["--autoscale", "bogus"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=ENV)
    assert out.returncode == 2
    assert "--autoscale" in out.stderr and "invalid choice" in out.stderr
    assert "listening" not in out.stdout


def test_sigterm_drains_and_exits_0(tmp_path):
    d = Daemon(tmp_path / "daemon.log", "--autoscale", "dry")
    wait_ticks(d, 1)
    rc, rest = d.stop()
    assert rc == 0
    drained = json.loads(rest.strip().splitlines()[-1])
    assert drained["drained"] == "SIGTERM" and drained["clean"] is True
