"""The port's service fault planes on the CPU, each held to the JAX
package's bytes for the same spec (its bucket keys and its host-oracle
prove):

- a worker killed right after round 2's snapshot resumes from it (one
  retry, the respawned slot) to the uninterrupted bytes;
- a journal-plane FaultInjector crash at ROUND2, then a restart on the
  same journal and store, serves the DONE job from its proof artifact and
  resumes the in-flight one from its StoreCheckpoint without re-proving
  round 1;
- a proof-plane corruption (corrupt:at=proof) is blocked by
  verify-before-serve, and the re-prove serves the right bytes.

The pools prove on the port's PythonBackend (the service logic does not
depend on the backend, as in the JAX package's tests); the bucket keys
are the port's, built on the CPU once and loaded from a store copy.
"""

import pytest

from distributed_plonk_tpu_torch.runtime.faults import FaultInjector, Rule
from distributed_plonk_tpu_torch.backend.python_backend import PythonBackend
from distributed_plonk_tpu_torch.service import ProofService

from test_torch_service import TOY_A, jax_proof, store_with, wait_for


def _service(tmp_path, store, **kw):
    return ProofService(port=0, prover_workers=1, device="cpu",
                        backend_factory=PythonBackend, store_dir=store,
                        journal_dir=str(tmp_path / "journal"), **kw)


def test_kill_at_round_2_resumes_to_the_uninterrupted_bytes(tmp_path):
    svc = _service(tmp_path, store_with(tmp_path, TOY_A), chaos=True).start()
    try:
        assert svc.pool.kill_worker(worker="w0g1", at_round=2) == "w0g1"
        spec = dict(TOY_A, seed=11)
        job = svc.submit_local(spec)
        assert job.done_event.wait(240) and job.state == "done", job.error
        assert job.retries == 1
        assert [a["outcome"] for a in job.attempts] == ["killed", "ok"]
        assert [a["worker"] for a in job.attempts] == ["w0g1", "w0g2"]
        assert job.proof_bytes == jax_proof(spec)
        m = svc.metrics.snapshot()["counters"]
        assert m["workers_killed"] == 1 and m["job_retries"] == 1
        assert m["checkpoint_resumes"] == 1
    finally:
        svc.shutdown()


def test_journal_crash_at_round_2_then_restart_recovers(tmp_path):
    store = store_with(tmp_path, TOY_A)
    done_spec = dict(TOY_A, seed=1)
    crash_spec = dict(TOY_A, seed=2, job_key="crash-1")

    svc = _service(tmp_path, store).start()
    try:
        first = svc.submit_local(done_spec)
        assert first.done_event.wait(240) and first.state == "done"
    finally:
        svc.shutdown()

    box = {}
    faults = FaultInjector([Rule("kill", tag="ROUND2", plane="journal")],
                           kill_cb=lambda _label: box["svc"].crash())
    svc = box["svc"] = _service(tmp_path, store, chaos=True, faults=faults)
    svc.start()
    job = svc.submit_local(crash_spec)
    wait_for(svc._stopped.is_set, 240, "the journal-plane crash")
    assert job.state != "done"
    assert faults.counts() == {"kill@ROUND2": {"seen": 1, "fired": 1}}
    # the crashed pool's thread parks at its next round boundary
    wait_for(lambda: not svc.pool.busy(), 60, "the crashed worker")

    svc = _service(tmp_path, store).start()
    try:
        old = svc.get_job(first.id)
        assert old.state == "done" and old.proof_bytes == first.proof_bytes
        again, deduped = svc.submit_ex(crash_spec)
        assert deduped and again.id == job.id
        assert again.done_event.wait(240) and again.state == "done"
        assert again.proof_bytes == jax_proof(crash_spec)
        m = svc.metrics.snapshot()
        assert m["counters"]["jobs_recovered_finished"] == 1
        assert m["counters"]["jobs_recovered"] == 1
        assert m["counters"]["checkpoint_resumes"] == 1
        assert m["counters"]["bucket_disk_hits"] == 1
        assert "bucket_misses" not in m["counters"]
        assert "prove_round/round1" not in m["histograms"]
        assert m["histograms"]["prove_round/round3"]["count"] == 1
    finally:
        svc.shutdown()


def test_corrupted_proof_is_blocked_and_reproved(tmp_path):
    faults = FaultInjector([Rule.parse("corrupt:at=proof")])
    svc = _service(tmp_path, store_with(tmp_path, TOY_A), chaos=True,
                   faults=faults, self_verify="1").start()
    try:
        spec = dict(TOY_A, seed=5)
        job = svc.submit_local(spec)
        assert job.done_event.wait(240) and job.state == "done", job.error
        assert job.proof_bytes == jax_proof(spec)
        assert job.retries == 1
        m = svc.metrics.snapshot()["counters"]
        assert m["proofs_blocked"] == 1 and m["self_verify_failures"] == 1
        assert m["self_verify_checks"] == 2
        assert m["faults_injected_corrupt"] == 1
        # the blocked proof was never journaled as done: one DONE record
        assert svc.journal.state[job.id]["done"]["retries"] == 1
    finally:
        svc.shutdown()


def test_rule_parse_reads_the_jax_text_form():
    assert Rule.parse("kill:at=journal:tag=ROUND2").plane == "journal"
    assert Rule.parse("kill:at=journal:tag=ROUND2").tag == "ROUND2"
    assert Rule.parse("corrupt_ckpt:tag=2").plane == "round"


def test_obs_server_serves_metrics_health_logs_and_traces(tmp_path):
    """ObsServer over a port service: /metrics (Prometheus text),
    /healthz, /logs, /trace/<job_id> (Chrome trace events, the job's
    queue-wait span with its placement attrs), /autoscale (the attached
    autoscaler's state), and 404 for /fleet without an attached fleet
    and for a profile that was never stored."""
    import json
    import urllib.error
    import urllib.request
    from distributed_plonk_tpu_torch.service import ObsServer

    svc = _service(tmp_path, store_with(tmp_path, TOY_A)).start()
    obs = ObsServer(svc).start()
    try:
        job = svc.submit_local(dict(TOY_A, seed=3))
        assert job.done_event.wait(240) and job.state == "done"

        def get(path):
            url = "http://%s:%d%s" % (obs.host, obs.port, path)
            try:
                with urllib.request.urlopen(url, timeout=30) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()
        code, body = get("/metrics")
        assert code == 200 and b"dpt_jobs_completed_total 1" in body
        assert b'dpt_prove_round_round1_seconds{quantile="0.5"}' in body
        code, body = get("/healthz")
        health = json.loads(body)
        assert code == 200 and health["device"] == "cpu"
        assert health["jobs_by_kind"] == {"toy": {"done": 1}}
        code, body = get("/trace/" + job.id)
        events = json.loads(body)["traceEvents"]
        queued = [e for e in events if e.get("name") == "service/queued"]
        assert code == 200 and queued
        assert queued[0]["args"]["placement"] == "pool"
        assert {"round1", "round5"} <= {e.get("name") for e in events}
        assert get("/logs")[0] == 200
        assert get("/autoscale")[0] == 404      # off until attached
        asc = svc.attach_autoscaler(mode="dry", start=False)
        asc.tick()
        code, body = get("/autoscale")
        state = json.loads(body)
        assert code == 200 and state["mode"] == "dry"
        assert state["ticks"] == 1 and state["queue"]["depth"] == 0
        assert state["bounds"] == {"min_workers": 1, "max_workers": 8}
        code, body = get("/fleet")
        assert code == 404 and b"no fleet attached" in body
        code, body = get("/profile/x")
        assert code == 404 and b"no profile" in body
    finally:
        obs.close()
        svc.shutdown()
