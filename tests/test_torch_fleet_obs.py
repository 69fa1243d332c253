"""The port's fleet observability plane on the CPU, over real TCP (a
mirror of tests/test_fleet_obs.py at a small size).

- METRICS_FETCH: two port workers (`--device cpu`) scraped by the port's
  Dispatcher after serving an NTT and an MSM: served_* counters,
  worker_*_s histograms and kernel_*_gflops gauges (no mfu_* on the CPU:
  no peak is invented), the identity fields (backend "torch", device),
  breaker/suspect awareness, and the fleet aggregates;
- `render_prom` gives exactly the JAX package's text on the same entries;
- across packages: a JAX Dispatcher scrapes, log-fetches and profiles a
  port worker, and the port's Dispatcher a JAX `--backend python` worker,
  each snapshot not None;
- LOG_FETCH and PROFILE (format pystacks-json) on a port worker, and a
  worker that predates the tags degrading to empty results;
- a ProofService with the fleet attached: /metrics with the per-worker
  series, /fleet, /profile/capture -> /profile/<id> (a profile:<id>
  artifact in its store) over HTTP;
- the workers' kernel shares folded into mfu_fleet_<stage>_pct, which the
  autoscaler's mfu_pct then reads.

Ports 23000 + 3 * (pid % 300): below the ephemeral range, clear of the
other fleet tests.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from distributed_plonk_tpu.obs import fleet as JOF
from distributed_plonk_tpu.runtime.dispatcher import \
    Dispatcher as JaxDispatcher
from distributed_plonk_tpu.runtime.netconfig import \
    NetworkConfig as JaxNetworkConfig
from distributed_plonk_tpu_torch import curve as C
from distributed_plonk_tpu_torch import poly as P
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.obs import fleet as OF
from distributed_plonk_tpu_torch.runtime import native, protocol
from distributed_plonk_tpu_torch.runtime.dispatcher import Dispatcher
from distributed_plonk_tpu_torch.runtime.netconfig import NetworkConfig
from distributed_plonk_tpu_torch.service import autoscale as AS
from distributed_plonk_tpu_torch.service.metrics import Metrics

torch.set_num_threads(1)

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
RNG = random.Random(0x0B5E)


def _up(cfg):
    """A Dispatcher over cfg once every worker answers (a fresh one per
    attempt: a failed dial opens the worker's breaker)."""
    deadline = time.time() + 90
    while time.time() < deadline:
        d = Dispatcher(cfg)
        try:
            d.ping()
            return d
        except (ConnectionError, OSError):
            for w in d.workers:
                w.close()
            d.pool.shutdown(wait=False)
            time.sleep(0.3)
    raise AssertionError("workers did not come up")


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """(port Dispatcher over two port CPU workers, its config path, port
    Dispatcher over one JAX --backend python worker, its config path)."""
    root = tmp_path_factory.mktemp("fleet-obs")
    base = 23000 + (os.getpid() % 300) * 3
    port_cfg = NetworkConfig(["127.0.0.1:%d" % (base + i) for i in range(2)])
    jax_cfg = NetworkConfig(["127.0.0.1:%d" % (base + 2)])
    port_path, jax_path = str(root / "port.json"), str(root / "jax.json")
    port_cfg.save(port_path)
    jax_cfg.save(jax_path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_plonk_tpu_torch.runtime.worker",
         str(i), port_path, "--device", "cpu"], cwd=REPO, env=env)
        for i in range(2)]
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "distributed_plonk_tpu.runtime.worker", "0",
         jax_path, "--backend", "python"], cwd=REPO, env=env))
    try:
        d, dj = _up(port_cfg), _up(jax_cfg)
        yield d, port_path, dj, jax_path
        d.shutdown()
        dj.shutdown()
        for p in procs:
            p.wait(timeout=10)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def served(fleets):
    """The port fleet after one NTT and one MSM."""
    d = fleets[0]
    values = [RNG.randrange(R_MOD) for _ in range(16)]
    assert d.ntt(values) == P.fft(P.Domain(16), values)
    bases = [C.g1_mul(C.G1_GEN, k + 2) for k in range(8)]
    scalars = [RNG.randrange(R_MOD) for _ in range(8)]
    d.init_bases(bases)
    assert d.msm(scalars) == C.g1_msm(bases, scalars)
    return d


def test_scrape_render_and_suspect_awareness(served):
    d = served
    entries = d.fleet_metrics()
    assert [e["index"] for e in entries] == [0, 1]
    assert all(e["reachable"] for e in entries)
    snaps = [e["snapshot"] for e in entries]
    assert all(s is not None for s in snaps)
    assert sum(s["counters"].get("served_ntt", 0) for s in snaps) == 1
    # one range per worker, and any duplicate the integrity plane sampled
    msms = [s["counters"].get("served_msm", 0) for s in snaps]
    assert min(msms) >= 1
    for s in snaps:
        assert s["backend"] == "torch" and s["device"] == "cpu"
        assert {"index", "uptime_s", "epoch", "log_seq"} <= set(s)
        assert not any(k.startswith("mfu_") for k in s["gauges"])
    ntt = [s for s in snaps if s["counters"].get("served_ntt")][0]
    assert ntt["gauges"]["kernel_ntt_gflops"] > 0
    assert ntt["histograms"]["worker_ntt_s"]["count"] == 1
    assert all(s["gauges"]["kernel_msm_gflops"] > 0
               and s["histograms"]["worker_msm_s"]["count"] == k
               for s, k in zip(snaps, msms))
    text = OF.render_prom(entries)
    assert 'dpt_fleet_up{worker="0"' in text
    assert 'dpt_fleet_up{worker="1"' in text
    assert "dpt_fleet_served_ntt_total{" in text
    assert "dpt_fleet_kernel_msm_gflops{" in text
    m = Metrics()
    assert OF.aggregate(entries, m) == {"width": 2, "reachable": 2,
                                        "scraped": 2}
    # a quarantined worker is reported, never dialed
    d.tracker.mark_suspect(1)
    try:
        entries = d.fleet_metrics()
    finally:
        d.tracker.clear_suspect(1)
    assert entries[1]["suspect"] and not entries[1]["usable"]
    assert entries[1]["snapshot"] is None
    assert entries[0]["snapshot"] is not None
    assert 'dpt_fleet_suspect{worker="1",' in OF.render_prom(entries)
    OF.aggregate(entries, m)
    snap = m.snapshot()
    assert snap["gauges"]["fleet_width"] == 2
    assert snap["gauges"]["fleet_suspects"] == 1
    assert snap["counters"]["fleet_scrapes"] == 2


def test_render_prom_equals_the_jax_render(served):
    entries = served.fleet_metrics()
    planted = [dict(entries[0], addr="h:1"),
               {"index": 7, "addr": "a b\"c:9", "usable": False,
                "suspect": True, "left": False, "reachable": False,
                "snapshot": None},
               {"index": 8, "addr": "x:2", "usable": True, "suspect": False,
                "left": False, "reachable": True,
                "snapshot": {"counters": {"served_msm": 3, "z": True},
                             "gauges": {"mfu_msm_pct": 12.5, "s": "txt"},
                             "uptime_s": 4.5, "epoch": 2,
                             "sdc_injected": 1}}]
    for ents in (entries, planted, []):
        assert OF.render_prom(ents) == JOF.render_prom(ents)


def test_jax_dispatcher_reads_port_workers(fleets, served):
    _d, port_path, _dj, _jp = fleets
    jd = JaxDispatcher(JaxNetworkConfig.load(port_path))
    try:
        entries = jd.fleet_metrics()
        assert all(e["snapshot"] is not None for e in entries)
        assert entries[0]["snapshot"]["backend"] == "torch"
        logs = jd.fetch_logs(worker=0)
        assert logs[0]["worker"] == 0 and "events" in logs[0]
        meta, blob = jd.profile_worker(0, duration_ms=30)
        assert meta["format"] == "pystacks-json" and meta["worker"] == 0
        assert json.loads(blob)["samples"] >= 1
    finally:
        for w in jd.workers:
            w.close()
        jd.pool.shutdown()


def test_port_dispatcher_reads_a_jax_worker(fleets):
    _d, _pp, dj, _jp = fleets
    values = [RNG.randrange(R_MOD) for _ in range(16)]
    assert dj.ntt(values) == P.fft(P.Domain(16), values)
    entries = dj.fleet_metrics()
    snap = entries[0]["snapshot"]
    assert snap is not None and snap["backend"] == "python"
    assert snap["counters"]["served_ntt"] == 1
    assert dj.fetch_logs(worker=0)[0]["worker"] == 0
    meta, blob = dj.profile_worker(0, duration_ms=30)
    assert meta["format"] == "pystacks-json" and blob


def test_port_worker_logs_and_profiles(served):
    d = served
    before = d.fleet_metrics()[0]["snapshot"]["counters"].get(
        "profiles_captured", 0)
    meta, blob = d.profile_worker(0, duration_ms=40)
    assert meta["format"] == "pystacks-json" and meta["worker"] == 0
    assert meta["bytes"] == len(blob) and json.loads(blob)["samples"] >= 1
    snap = d.fleet_metrics()[0]["snapshot"]
    assert snap["counters"]["profiles_captured"] == before + 1
    logs = d.fetch_logs(worker=0)
    assert any(ev.get("event") == "profile_captured"
               for ev in logs[0]["events"])
    tail = d.fetch_logs(worker=0, since_seq=logs[0]["seq"])
    assert tail[0]["events"] == []


def _stub_old_worker():
    """A worker from before these tags: PING and HEALTH, ERR on the rest.
    Returns (host, port, closer)."""
    listener = native.Listener("127.0.0.1", 0)
    port = native.listener_port(listener)

    def serve_conn(conn):
        try:
            while True:
                try:
                    tag, _payload = conn.recv()
                except ConnectionError:
                    return
                tag &= ~protocol.TRACED
                if tag == protocol.PING:
                    conn.send(protocol.OK)
                elif tag == protocol.HEALTH:
                    conn.send(protocol.OK, json.dumps(
                        {"uptime_s": 1.0, "served": 0,
                         "now": time.time()}).encode())
                else:
                    conn.send(protocol.ERR, b"unknown tag")
        finally:
            conn.close()

    def accept_loop():
        while True:
            try:
                conn = listener.accept()
            except Exception:
                return
            if conn.fd < 0:
                return
            threading.Thread(target=serve_conn, args=(conn,),
                             daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()
    return "127.0.0.1", port, listener.close


def test_old_worker_degrades_to_empty_results():
    host, port, close = _stub_old_worker()
    d = Dispatcher(NetworkConfig(["%s:%d" % (host, port)]))
    try:
        entries = d.fleet_metrics()
        assert entries[0]["reachable"] and entries[0].get("unsupported")
        assert entries[0]["snapshot"] is None
        assert d.fetch_logs(worker=0) == [{"worker": 0, "events": [],
                                           "seq": 0}]
        meta, blob = d.profile_worker(0)
        assert meta["format"] == "unsupported" and blob == b""
        assert d.tracker.usable(0)
    finally:
        for w in d.workers:
            w.close()
        d.pool.shutdown()
        close()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_service_serves_fleet_and_profiles_over_http(tmp_path, served):
    from distributed_plonk_tpu_torch.service import ObsServer, ProofService
    from distributed_plonk_tpu_torch.store import keycache as KC

    svc = ProofService(port=0, prover_workers=1, device="cpu",
                       store_dir=str(tmp_path / "store")).start()
    obs = ObsServer(svc).start()
    base = "http://%s:%d" % (obs.host, obs.port)
    try:
        assert _get(base + "/fleet")[0] == 404      # no fleet attached
        svc.attach_fleet(served, interval_s=60.0)
        code, body = _get(base + "/metrics")
        text = body.decode()
        assert code == 200 and "dpt_fleet_width 2" in text
        assert 'dpt_fleet_up{worker="0"' in text
        assert "dpt_fleet_served_ntt_total{" in text
        code, body = _get(base + "/fleet")
        fl = json.loads(body)
        assert code == 200 and fl["width"] == 2
        for m in fl["members"]:
            assert {"index", "addr", "usable", "suspect", "left",
                    "reachable", "snapshot"} <= set(m)
            assert m["reachable"] and m["snapshot"]
        code, body = _get(base + "/profile/capture?worker=1&ms=40")
        cap = json.loads(body)
        assert code == 200 and cap["format"] == "pystacks-json"
        code, blob = _get(base + "/profile/" + cap["profile_id"])
        assert code == 200 and json.loads(blob)["samples"] >= 1
        assert svc.store.get_entry(
            KC.profile_store_key(cap["profile_id"])) is not None
        assert svc.metrics.snapshot()["counters"]["profiles_stored"] == 1
        assert _get(base + "/profile/deadbeef00000000")[0] == 404
        assert svc.autotune == {"source": "none",
                                "fingerprint": svc.autotune["fingerprint"],
                                "measure_runs": 0}
    finally:
        obs.close()
        svc.shutdown()


def test_fleet_kernel_shares_feed_the_autoscaler():
    entries = [{"index": i, "addr": "h:%d" % i, "usable": True,
                "suspect": False, "left": False, "reachable": True,
                "snapshot": {"counters": {},
                             "gauges": {"mfu_msm_pct": v, "mfu_ntt_pct": 4.0,
                                        "kernel_msm_gflops": 9.0}}}
               for i, v in enumerate((10.0, 30.0))]
    m = Metrics()
    OF.aggregate(entries, m)
    g = m.snapshot()["gauges"]
    assert g["mfu_fleet_msm_pct"] == 20.0 and g["mfu_fleet_ntt_pct"] == 4.0

    class _Svc:
        metrics = m
        fleet_dispatcher = None

        class queue:
            max_depth = 4

            @staticmethod
            def depth():
                return 0

            @staticmethod
            def depth_by_class():
                return {}

        class pool:
            @staticmethod
            def busy():
                return []

    assert AS.Autoscaler(service=_Svc(), mode="dry").read_sensors()[
        "mfu_pct"] == 12.0
