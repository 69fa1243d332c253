"""A client's trace context through the port's proof service on the CPU,
held to the JAX package's service where the two can run the same call:

- SUBMIT adopts a context's trace id and parent as the JAX service does,
  garbage contexts included (an unstarted service of each package);
- a toy job submitted with a context is journaled, the service crashes
  before it starts, and a restart on the same journal recovers the job
  under the adopted trace id and parent; its stored trace:<job_id> chains
  every span up to the context's parent (the JAX tests/test_obs.py
  restart case);
- a TCP round trip with the context a client tracer injects inside its
  span: the SUBMIT and STATUS replies carry the client's trace id and the
  pool's spans are parented to the client's span.

Toy specs (n = 16) on the port's PythonBackend; the bucket keys are the
port's, built once per process (test_torch_service.store_with).
"""

import os
import re
import sys

import pytest

from distributed_plonk_tpu.service import ProofService as JaxProofService

from distributed_plonk_tpu_torch.backend.python_backend import PythonBackend
from distributed_plonk_tpu_torch.service import ProofService, ServiceClient
from distributed_plonk_tpu_torch.store import keycache as KC
from distributed_plonk_tpu_torch.trace import Tracer

from test_torch_service import TOY_A, store_with
from test_torch_trace_context import GARBAGE

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from chip_smoke import chained_to  # noqa: E402  (the card's own check)

HEX32 = re.compile(r"[0-9a-f]{32}\Z")
CTX = {"trace_id": "5a" * 16, "parent_id": "6b" * 8}


def _service(tmp_path, store=None, journal=True):
    return ProofService(port=0, prover_workers=1, device="cpu",
                        backend_factory=PythonBackend, store_dir=store,
                        journal_dir=str(tmp_path / "journal")
                        if journal else None)


def _adopted(svc, ctx):
    job, _ = svc.submit_ex(dict(TOY_A, seed=1, trace_ctx=ctx))
    given = isinstance(ctx, dict) and ctx.get("trace_id") == job.trace_id
    assert given or HEX32.match(job.trace_id), job.trace_id
    return (job.trace_id if given else "fresh", job.trace_parent)


@pytest.mark.parametrize("ctx", GARBAGE + [CTX], ids=repr)
def test_submit_adopts_a_context_like_jax(tmp_path, ctx):
    port = _service(tmp_path, journal=False)
    jax = JaxProofService(port=0, prover_workers=1)
    try:
        assert _adopted(port, ctx) == _adopted(jax, ctx)
    finally:
        # never started: crash() stops them without joining a thread
        port.crash()
        jax.crash()


def test_context_survives_a_journal_restart(tmp_path):
    store = store_with(tmp_path, TOY_A)
    spec = dict(TOY_A, seed=21, job_key="tr-k", trace_ctx=CTX)
    svc = _service(tmp_path, store)
    # crash BEFORE the scheduler starts: the job is journaled, never proved
    job, deduped = svc.submit_ex(spec)
    assert not deduped
    assert (job.trace_id, job.trace_parent) == (CTX["trace_id"],
                                                CTX["parent_id"])
    rec = svc.journal.state[job.id]
    assert (rec["trace"], rec["trace_parent"]) == (CTX["trace_id"],
                                                   CTX["parent_id"])
    svc.crash()

    # the JAX service adopts the same ids from the same spec
    jsvc = JaxProofService(port=0, prover_workers=1)
    try:
        jjob, _ = jsvc.submit_ex(spec)
        assert (jjob.trace_id, jjob.trace_parent) == (job.trace_id,
                                                      job.trace_parent)
    finally:
        jsvc.crash()

    svc2 = _service(tmp_path, store).start()
    try:
        # recovered from the journal before any resubmission
        rec = svc2.get_job(job.id)
        assert (rec.trace_id, rec.trace_parent) == (CTX["trace_id"],
                                                    CTX["parent_id"])
        again, deduped = svc2.submit_ex(dict(spec, trace_ctx=None))
        assert deduped and again is rec
        assert again.done_event.wait(120) and again.state == "done", \
            again.error
        assert svc2.metrics.snapshot()["counters"]["jobs_recovered"] == 1
        merged = KC.load_trace(svc2.store, again.id)
        assert merged["trace_id"] == CTX["trace_id"]
        events = merged["events"]
        roots = [e for e in events if e.get("parent") == CTX["parent_id"]]
        assert {"round1", "service/queued"} <= {e["span"] for e in roots}
        assert chained_to(events, CTX["parent_id"]) == events
        assert all(e["proc"].startswith("pool/") for e in events)
    finally:
        svc2.shutdown()


def test_tcp_submit_carries_the_client_context(tmp_path):
    svc = _service(tmp_path, store_with(tmp_path, TOY_A)).start()
    client = Tracer(proc="client")
    try:
        with ServiceClient("127.0.0.1", svc.port) as c:
            with client.span("client/prove_request") as root:
                r = c.submit(dict(TOY_A, seed=22),
                             trace_ctx=client.context())
                assert r["trace_id"] == client.trace_id
                st = c.wait(r["job_id"], timeout_s=120)
        assert st["state"] == "done" and st["trace_id"] == client.trace_id
        job = svc.get_job(r["job_id"])
        assert (job.trace_id, job.trace_parent) == (client.trace_id, root)
        dump = job.trace_dump
        assert dump["trace_id"] == client.trace_id
        pool = [e for e in dump["events"] if e["proc"].startswith("pool/")]
        assert any(e.get("parent") == root for e in pool)
        assert chained_to(pool, root) == pool
        # the client's own span closes the tree: one merged timeline
        assert client.events[0]["sid"] == root and \
            "parent" not in client.events[0]
    finally:
        svc.shutdown()
