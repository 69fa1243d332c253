"""The port's incident plane on the CPU, held to the JAX package's: after a
fault in a fleet, one artifact holds the job's timeline together with the
dispatcher's, supervisor's and workers' log events.

- `Dispatcher._trace_logs` gives the JAX package's list on the same merged
  dump and log sets (offset correction, 6-decimal rounding, the trace-id
  filter and the padded time window for untagged events);
- `ProofService.merge_fleet_trace` with a stub dispatcher gives the JAX
  service's merged dump on the same job dump and fleet dump; a failed
  store write counts `store_write_errors` in both;
- one pane over a supervised fleet: three CPU workers, worker 1 SIGKILLed
  at its first FFT1 under a ProofService job; the proof equals the JAX
  package's, and the merged artifact passes chip_smoke.py's
  incident_checks (the chip's own assertions), also over HTTP, the job
  submitted with a client tracer's context (the client's trace id wins
  over the dispatcher tracer's; the pool's spans chain to its span);
- `collect_trace` names a worker whose connection is lost in
  `lost_workers` (counter trace_workers_lost), and raises on an ERR reply;
- a malformed frame raises a worker's `serve_errors` to 1 in
  METRICS_FETCH, on a port worker as on a JAX worker;
- the LogBuffer ring, filter and sink (with `close_sink`, and a second
  `open_sink` that closes the first handle), against the JAX LogBuffer;
- `Tracer.to_json` and `Tracer.to_chrome_trace`.

Ports 21000 + 3 * (pid % 300) for the static workers: below the ephemeral
range, clear of the other fleet tests. Supervised workers take free ports.
"""

import copy
import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributed_plonk_tpu.obs import log as jlog
from distributed_plonk_tpu.runtime.dispatcher import \
    Dispatcher as JaxDispatcher
from distributed_plonk_tpu.service.server import \
    ProofService as JaxProofService
from distributed_plonk_tpu.trace import merge_traces as jax_merge_traces
from distributed_plonk_tpu_torch.obs import log as olog
from distributed_plonk_tpu_torch.runtime import protocol
from distributed_plonk_tpu_torch.runtime.dispatcher import (Dispatcher,
                                                            RemoteBackend,
                                                            WorkerError,
                                                            WorkerHandle)
from distributed_plonk_tpu_torch.runtime.netconfig import NetworkConfig
from distributed_plonk_tpu_torch.service.metrics import Metrics
from distributed_plonk_tpu_torch.service.server import ProofService
from distributed_plonk_tpu_torch.trace import Tracer, to_chrome_trace

torch.set_num_threads(1)

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
WAIT_S = 120


@pytest.fixture(autouse=True)
def fast_failures(monkeypatch):
    """Short reconnect backoff; one intra-op thread per CPU worker."""
    monkeypatch.setattr(WorkerHandle, "RECONNECT_TRIES", 2)
    monkeypatch.setattr(WorkerHandle, "BACKOFF_BASE_S", 0.01)
    monkeypatch.setattr(WorkerHandle, "BACKOFF_MAX_S", 0.05)
    monkeypatch.setattr(WorkerHandle, "TIMEOUT_MS", 120000)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def wait_for(cond, timeout_s=WAIT_S, msg=""):
    deadline = time.monotonic() + timeout_s
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() >= deadline:
            raise AssertionError("timed out waiting for %s" % msg)
        time.sleep(0.05)


def counter(metrics, name):
    return metrics.snapshot()["counters"].get(name, 0)


# --- canned dumps, made from a seed ------------------------------------------

def _events(rng, n, t0, proc):
    return [{"span": "s%d" % i, "ts": round(t0 + float(rng.uniform(0, 5)), 6),
             "dur_s": round(float(rng.uniform(0, 1)), 6), "sid": "%016x" % i,
             "tid": 7, "proc": proc, "host": "h", "pid": 100 + len(proc)}
            for i in range(n)]


def _merged(rng, tid, t0, procs=("dispatcher", "worker/0")):
    events = sorted((ev for p in procs for ev in _events(rng, 4, t0, p)),
                    key=lambda ev: ev["ts"])
    return {"trace_id": tid,
            "processes": [{"proc": p, "host": "h", "pid": 100 + len(p),
                           "offset_s": 0.0, "spans": 4} for p in procs],
            "events": events}


def _log_events(rng, n, t0, tids, subsystem):
    """Log events spread from 4 s before t0 to 11 s after it: tagged with
    one of `tids` or untagged (None), inside and outside a prove window."""
    out = []
    for i in range(n):
        ev = {"ts": float(t0 + rng.uniform(-4.0, 11.0)), "level": "info",
              "subsystem": subsystem, "event": "e%d" % i, "proc": subsystem,
              "pid": 9, "seq": i + 1}
        tid = tids[int(rng.integers(len(tids)))]
        if tid is not None:
            ev["trace_id"] = tid
        out.append(ev)
    return out


def _trace_logs_case(seed):
    rng = np.random.default_rng(seed)
    t0 = 1.7e9 + float(rng.uniform(0, 1000))
    merged = _merged(rng, "aa" * 16, t0)
    tids = ["aa" * 16, "bb" * 16, None]
    log_sets = [(_log_events(rng, 24, t0, tids, "worker"),
                 float(rng.normal(0, 0.3))),
                (_log_events(rng, 24, t0, tids, "worker"),
                 float(rng.normal(0, 0.3))),
                (_log_events(rng, 24, t0, tids, "supervisor"), 0.0)]
    return merged, log_sets


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_trace_logs_equals_the_jax_selection(seed):
    merged, log_sets = _trace_logs_case(seed)
    want = JaxDispatcher._trace_logs(None, copy.deepcopy(merged),
                                     copy.deepcopy(log_sets))
    got = Dispatcher._trace_logs(None, copy.deepcopy(merged),
                                 copy.deepcopy(log_sets))
    assert got == want
    # the case reaches every branch: kept tagged, attributed untagged,
    # dropped (another trace, outside the window)
    kept = sum(len(evs) for evs, _ in log_sets)
    assert 0 < len(got) < kept
    assert any(e["subsystem"] == "supervisor" for e in got)
    assert all(e["trace_id"] == "aa" * 16 for e in got)


def test_trace_logs_of_an_empty_timeline_equals_the_jax_selection():
    rng = np.random.default_rng(9)
    merged = {"trace_id": "cc" * 16, "processes": [], "events": []}
    log_sets = [(_log_events(rng, 16, 0.0, ["cc" * 16, None], "worker"),
                 0.25)]
    want = JaxDispatcher._trace_logs(None, merged, copy.deepcopy(log_sets))
    assert Dispatcher._trace_logs(None, merged, log_sets) == want


# --- merge_fleet_trace against the JAX service -------------------------------

class _StubFleet:
    """A dispatcher whose collect_trace returns a canned fleet dump."""

    def __init__(self, dump):
        self.dump = dump

    def collect_trace(self, logs=True):
        return copy.deepcopy(self.dump)


def _fleet_dump(rng, t0):
    d = _merged(rng, "dd" * 16, t0, procs=("dispatcher", "worker/0",
                                            "worker/1"))
    d["logs"] = sorted(
        [dict(e, ts=round(e["ts"], 6)) for e in _log_events(
            rng, 6, t0, ["dd" * 16], "dispatcher")]
        + [dict(e, ts=round(e["ts"], 6)) for e in _log_events(
            rng, 4, t0, ["dd" * 16], "supervisor")],
        key=lambda e: e["ts"])
    return d


def _job_dump(rng, t0, tid):
    d = _merged(rng, tid, t0, procs=("service",))
    d["logs"] = [dict(e, ts=round(e["ts"], 6)) for e in _log_events(
        rng, 3, t0, [tid], "service")]
    return d


def _services(tmp_path, fleet):
    port = ProofService(port=0, device="cpu", prover_workers=1,
                        store_dir=str(tmp_path / "port"))
    jax = JaxProofService(port=0, prover_workers=1,
                          store_dir=str(tmp_path / "jax"))
    for svc in (port, jax):
        svc.fleet_dispatcher = _StubFleet(fleet)
    return port, jax


def _job(svc, tid, dump):
    job = svc.submit_local({"kind": "toy", "gates": 4, "seed": 3})
    job.trace_id = tid
    job.trace_dump = copy.deepcopy(dump)
    return job


@pytest.mark.parametrize("case", ["both", "no_fleet_dump", "no_job_dump",
                                  "unknown_job"])
def test_merge_fleet_trace_equals_the_jax_merge(tmp_path, case):
    rng = np.random.default_rng(20)
    t0 = 1.7e9 + 123.0
    tid = "ee" * 16
    fleet = None if case == "no_fleet_dump" else _fleet_dump(rng, t0)
    base = None if case == "no_job_dump" else _job_dump(rng, t0, tid)
    port, jax = _services(tmp_path, fleet)
    jobs = [_job(svc, tid, base) for svc in (port, jax)]
    ids = ["j-unknown"] * 2 if case == "unknown_job" else \
        [job.id for job in jobs]
    want = jax.merge_fleet_trace(ids[1])
    got = port.merge_fleet_trace(ids[0])
    assert got == want
    assert got is not None and got["events"]
    if case == "unknown_job":
        assert got["trace_id"] == "dd" * 16
        return
    assert got["trace_id"] == tid
    assert all(e["trace_id"] == tid for e in got["logs"])
    # stored as trace:<job_id> and served back from the store
    assert port.load_trace_merged(ids[0]) == got
    assert counter(port.metrics, "store_write_errors") == 0


def test_merge_fleet_trace_carries_lost_workers(tmp_path):
    rng = np.random.default_rng(21)
    t0 = 1.7e9
    fleet = _fleet_dump(rng, t0)
    base = _job_dump(rng, t0, "ff" * 16)
    port, jax = _services(tmp_path, dict(fleet, lost_workers=[1]))
    jobs = [_job(svc, "ff" * 16, base) for svc in (port, jax)]
    got = port.merge_fleet_trace(jobs[0].id)
    want = jax.merge_fleet_trace(jobs[1].id)
    assert got.pop("lost_workers") == [1]
    assert got == want


def test_merge_fleet_trace_counts_a_failed_store_write(tmp_path,
                                                       monkeypatch):
    from distributed_plonk_tpu.store import keycache as JKC
    from distributed_plonk_tpu_torch.store import keycache as KC

    def refuse(*_a, **_k):
        raise OSError("disk full")
    monkeypatch.setattr(KC, "store_trace", refuse)
    monkeypatch.setattr(JKC, "store_trace", refuse)
    rng = np.random.default_rng(22)
    port, jax = _services(tmp_path, _fleet_dump(rng, 1.7e9))
    base = _job_dump(rng, 1.7e9, "ab" * 16)
    jobs = [_job(svc, "ab" * 16, base) for svc in (port, jax)]
    assert port.merge_fleet_trace(jobs[0].id) == \
        jax.merge_fleet_trace(jobs[1].id)
    assert counter(port.metrics, "store_write_errors") == 1
    assert jax.metrics.snapshot()["counters"]["store_write_errors"] == 1
    # the job keeps the merged dump in memory all the same
    assert port.load_trace_merged(jobs[0].id) == jobs[0].trace_dump


def test_merge_traces_rounds_as_the_jax_merge():
    rng = np.random.default_rng(23)
    dumps = [{"trace_id": "t", "proc": p, "host": "h", "pid": 1,
              "events": [{"span": "x", "ts": 1.7e9 + float(rng.uniform()),
                          "dur_s": 0.5, "sid": "%d" % i}
                         for i in range(5)]} for p in ("a", "b")]
    offsets = [0.0, float(rng.normal(0, 0.1))]
    from distributed_plonk_tpu_torch.trace import merge_traces
    assert merge_traces(copy.deepcopy(dumps), offsets) == \
        jax_merge_traces(copy.deepcopy(dumps), offsets)


# --- one pane over a supervised fleet with a kill ----------------------------

def test_supervised_fleet_kill_reads_off_one_artifact(tmp_path):
    """A 3-worker supervised CPU fleet proving a ProofService job; worker
    1 is SIGKILLed at its first FFT1. The proof equals the JAX package's,
    and merge_fleet_trace passes chip_smoke.py's incident checks, the
    client's trace context among them."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    from distributed_plonk_tpu import proof_io as JIO
    from distributed_plonk_tpu.backend.python_backend import \
        PythonBackend as JaxPythonBackend
    from distributed_plonk_tpu.prover import prove as jax_prove
    from distributed_plonk_tpu.service import jobs as JJ
    from distributed_plonk_tpu.store import keycache as JKC
    from distributed_plonk_tpu.store.artifacts import \
        ArtifactStore as JaxArtifactStore
    from distributed_plonk_tpu_torch.runtime.faults import (FaultInjector,
                                                            Rule)
    from distributed_plonk_tpu_torch.runtime.health import LivenessTracker
    from distributed_plonk_tpu_torch.runtime.supervisor import \
        WorkerSupervisor
    from distributed_plonk_tpu_torch.service.jobs import (JobSpec,
                                                          build_circuit)
    from distributed_plonk_tpu_torch.service.server import ObsServer

    olog.reset()
    spec_obj = {"kind": "toy", "gates": 4, "seed": 7}
    jspec = JJ.JobSpec.from_wire(spec_obj)
    srs, pk, vk = JJ.build_bucket_keys(jspec, backend=JaxPythonBackend())
    want = JIO.serialize_proof(jax_prove(
        random.Random(7), JJ.build_circuit(jspec), pk, JaxPythonBackend()))
    # the service proves on the JAX package's bucket blob, written into its
    # store (the port reads it back to the keys it would build itself:
    # tests/test_torch_store.py), which saves a CPU key build
    JKC.store_bucket(JaxArtifactStore(str(tmp_path / "store")),
                     JJ.shape_key(jspec), srs, pk, vk)
    n = build_circuit(JobSpec.from_wire(spec_obj)).n

    metrics = Metrics()
    faults = FaultInjector(
        [Rule.parse("kill:at=proc:tag=FFT1:worker=1:nth=1")], metrics=metrics)
    d = Dispatcher(NetworkConfig([]), metrics=metrics, faults=faults,
                   tracer=Tracer(proc="dispatcher"))
    d.tracker = LivenessTracker(0, breaker_k=2, probe_base_s=0.05,
                                probe_max_s=0.5, metrics=metrics)
    mserver = d.enable_membership()
    sup = WorkerSupervisor("127.0.0.1", mserver.port, n=3, device="cpu",
                           metrics=metrics, cwd=REPO, probe_interval_s=0.1,
                           backoff_base_s=0.05, backoff_max_s=0.5)
    sup.attach_registry(d.membership)
    sup.start()
    faults.proc_kill_cb = sup.proc_killer(d)
    svc = ProofService(port=0, device="cpu", prover_workers=1,
                       max_retries=4, store_dir=str(tmp_path / "store"),
                       backend_factory=lambda: RemoteBackend(
                           d, dist_fft_min=n))
    svc.attach_fleet(d, interval_s=0.5)
    obs = ObsServer(svc).start()
    try:
        svc.start()
        wait_for(lambda: len(d.workers) == 3
                 and len(d.tracker.usable_set()) == 3, msg="fleet up")
        # submitted inside a client's span with its context, as on the
        # card: the job, its merged artifact and its pool spans carry it
        client = Tracer(proc="client")
        with client.span("client/submit_wait"):
            client_ctx = client.context()
            job = svc.submit_local(dict(spec_obj, trace_ctx=client_ctx))
            assert job.done_event.wait(WAIT_S) and job.state == "done", \
                (job.state, job.error)
        assert job.proof_bytes == want      # byte-identical through the kill
        assert counter(metrics, "faults_injected_kill") == 1
        # the heal (respawn and rejoin), so the supervisor's events exist
        # before the timeline is collected
        wait_for(lambda: counter(metrics, "worker_respawns") >= 1
                 and counter(metrics, "membership_rejoins") >= 1
                 and len(d.tracker.usable_set()) == 3, msg="heal")
        merged = chip_smoke.incident_checks(svc, obs, job, print, client_ctx)
        # the artifact is stored as trace:<job_id>
        assert svc.load_trace_merged(job.id) == merged
        events = {(e["subsystem"], e["event"]) for e in merged["logs"]}
        assert ("worker", "served") in events, events
    finally:
        obs.close()
        svc.shutdown()
        sup.stop()
        try:
            d.shutdown()
        finally:
            d.pool.shutdown(wait=False)


# --- static workers: lost workers, ERR replies, serve_errors -----------------

@pytest.fixture(scope="module")
def static_fleet(tmp_path_factory):
    """{"port": (host, port), "jax": (host, port), "dead": (host, port)}:
    one port CPU worker and one JAX --backend python worker, each on its
    own static config, and an address where nothing listens."""
    root = tmp_path_factory.mktemp("incident")
    base = 21000 + (os.getpid() % 300) * 3
    addrs = {"port": ("127.0.0.1", base), "dead": ("127.0.0.1", base + 1),
             "jax": ("127.0.0.1", base + 2)}
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = []
    for name, mod, extra in (
            ("port", "distributed_plonk_tpu_torch", ["--device", "cpu"]),
            ("jax", "distributed_plonk_tpu", ["--backend", "python"])):
        cfg = str(root / ("%s.json" % name))
        NetworkConfig(["%s:%d" % addrs[name]]).save(cfg)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", mod + ".runtime.worker", "0", cfg,
             *extra], cwd=REPO, env=env))
    try:
        for name in ("port", "jax"):
            wait_for(lambda: WorkerHandle(*addrs[name]).probe(),
                     msg="the %s worker" % name)
        yield addrs
    finally:
        for p in procs:
            p.kill()
            p.wait()


def _metrics_fetch(addr):
    return protocol.decode_json(WorkerHandle(*addr).call(
        protocol.METRICS_FETCH, traced=False))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_malformed_frame_counts_serve_errors(static_fleet, pkg):
    addr = static_fleet[pkg]
    assert _metrics_fetch(addr)["counters"].get("serve_errors", 0) == 0
    with pytest.raises(WorkerError):
        WorkerHandle(*addr).call(protocol.TRACE_DUMP, b"{", traced=False)
    assert _metrics_fetch(addr)["counters"]["serve_errors"] == 1


def test_collect_trace_names_a_lost_worker_and_raises_on_err(static_fleet):
    metrics = Metrics()
    tr = Tracer(proc="dispatcher")
    d = Dispatcher(NetworkConfig(["%s:%d" % static_fleet["port"],
                                  "%s:%d" % static_fleet["dead"]]),
                   metrics=metrics, tracer=tr)
    try:
        values = list(range(1, 17))
        d.workers[0].call(protocol.NTT, protocol.encode_ntt_request(
            values, False, False))
        merged = d.collect_trace()
        assert merged["lost_workers"] == [1]
        assert counter(metrics, "trace_workers_lost") == 1
        assert merged["trace_id"] == tr.trace_id
        assert {p["proc"] for p in merged["processes"]} == \
            {"dispatcher", "worker/0"}
        served = [e for e in merged["logs"]
                  if (e["subsystem"], e["event"]) == ("worker", "served")]
        assert len(served) == 1 and served[0]["tag"] == "NTT"
        assert served[0]["proc"] == "worker/0"
        assert served[0]["trace_id"] == tr.trace_id

        # an ERR reply is a live worker failing: it raises, never a loss
        call = d.workers[0].call

        def malformed(tag, payload=b"", **kw):
            if tag == protocol.TRACE_DUMP:
                payload = b"{"
            return call(tag, payload, **kw)
        d.workers[0].call = malformed
        with pytest.raises(WorkerError):
            d.collect_trace()
        # worker 0's ERR raised before worker 1 was reached
        assert counter(metrics, "trace_workers_lost") == 1
    finally:
        for w in d.workers:
            w.close()
        d.pool.shutdown(wait=False)


# --- the log buffer and the tracer's exports ---------------------------------

def test_log_buffer_ring_filter_sink(tmp_path):
    bufs = (olog.LogBuffer(cap=4, proc="t"), jlog.LogBuffer(cap=4, proc="t"))
    for buf in bufs:
        for i in range(6):
            buf.emit("service", "retry", job_id=f"j{i}",
                     trace_id="aa" if i % 2 else None)
    buf, jbuf = bufs

    def key(out):
        return [(e["seq"], e["event"], e.get("trace_id"), e["job_id"])
                for e in out["events"]]
    out = buf.fetch()
    assert out["seq"] == 6
    assert [e["seq"] for e in out["events"]] == [3, 4, 5, 6]  # ring cap 4
    assert all(e["trace_id"] == "aa"
               for e in buf.fetch(trace_id="aa")["events"])
    assert [e["seq"] for e in buf.fetch(since_seq=5)["events"]] == [6]
    assert len(buf.fetch(limit=2)["events"]) == 2
    for kw in ({}, {"trace_id": "aa"}, {"since_seq": 4}, {"limit": 3}):
        assert key(buf.fetch(**kw)) == key(jbuf.fetch(**kw))
    # file sink: one JSON object per line, events recorded after open
    path = buf.open_sink(str(tmp_path / "logs"), proc="t2")
    first = buf._file
    assert path and os.path.exists(path)
    buf.emit("service", "shed", level="warn", job_id="jx", reason="ttl")
    # a second sink closes the handle it replaces
    path2 = buf.open_sink(str(tmp_path / "logs2"))
    assert first.closed and path2 != path
    buf.emit("service", "drain", clean=True)
    buf.close_sink()
    assert buf._file is None
    buf.close_sink()                # idempotent
    lines = [json.loads(line) for line in open(path)]
    assert lines and lines[-1]["event"] == "shed"
    assert lines[-1]["subsystem"] == "service"
    assert [json.loads(line)["event"] for line in open(path2)] == ["drain"]
    buf.reset()
    assert buf.fetch() == {"events": [], "seq": 0}


def test_module_reset_drops_the_ring_and_closes_the_sink(tmp_path):
    olog.configure(log_dir=str(tmp_path / "logs"))
    sink = olog.buffer()._file
    olog.emit("obs", "profile_stored")
    assert olog.fetch()["seq"] >= 1
    olog.reset()
    assert olog.fetch() == {"events": [], "seq": 0}
    assert sink.closed and olog.buffer()._file is None


def test_tracer_to_json_and_chrome_trace():
    tr = Tracer(proc="dispatcher")
    with tr.span("round1"):
        with tr.span("commit", n=8):
            pass
    assert json.loads(tr.to_json()) == json.loads(json.dumps(tr.dump()))
    chrome = tr.to_chrome_trace()
    assert chrome == to_chrome_trace(tr.dump())
    spans = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["name"] for e in spans) == ["commit", "round1"]
    assert chrome["otherData"]["trace_id"] == tr.trace_id
