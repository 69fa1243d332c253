"""The port's proof service on the CPU, held to the JAX package's service on
the same seeded inputs at toy sizes (n = 16).

- `JobSpec.from_wire`, `shape_key` and every validation error equal the
  JAX package's, kind by kind; the queue pops in the JAX queue's order; a
  journal written by either package replays to the same state in the
  other;
- `ProofService()`, `build_bucket_keys()` and the entry point raise on a
  machine without a card unless given device="cpu";
- a TCP round trip on TorchBackend(device="cpu") (the pool's default
  backend): two toy-A jobs and one toy-B job prove to the JAX package's
  bytes, with two bucket builds and one batch placement, the batch one
  prove_many call;
- single jobs queued behind one another on a worker prove as one
  round pipeline, to the JAX package's bytes;
- a mesh-placed toy job on four "cpu" slots (LARGE_MIN lowered) proves to
  the pool-placed bytes, and the leaser grants distinct slots of one
  repeated device.

The kill, crash and corruption planes are in test_torch_service_recovery.py.
The service logic that does not depend on the backend runs on the port's
PythonBackend there, as the JAX tests run on theirs; keys are built on the
CPU (device="cpu") once per process and shared through a store copy.
"""

import functools
import os
import random
import shutil
import subprocess
import sys
import threading
import time

import pytest
import torch

from distributed_plonk_tpu.backend.python_backend import \
    PythonBackend as JaxPythonBackend
from distributed_plonk_tpu.proof_io import serialize_proof as jax_serialize
from distributed_plonk_tpu.prover import prove as jax_prove
from distributed_plonk_tpu.service import jobs as JJ
from distributed_plonk_tpu.service import journal as JJN
from distributed_plonk_tpu.service.queue import JobQueue as JaxJobQueue

from distributed_plonk_tpu_torch.backend.python_backend import PythonBackend
from distributed_plonk_tpu_torch.proof_io import deserialize_proof
from distributed_plonk_tpu_torch.service import (JobQueue, ProofService,
                                                 ServiceClient)
from distributed_plonk_tpu_torch.service import jobs as PJ
from distributed_plonk_tpu_torch.service import journal as PJN
from distributed_plonk_tpu_torch.service import placement as PL
from distributed_plonk_tpu_torch.store import ArtifactStore, store_bucket
from distributed_plonk_tpu_torch.verifier import verify

torch.set_num_threads(1)

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
TOY_A = {"kind": "toy", "gates": 8}     # n = 16
TOY_B = {"kind": "toy", "gates": 4}     # n = 16, another shape


# --- shared references ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_bucket(kind, params):
    spec = JJ.JobSpec(kind, dict(params), seed=0)
    return JJ.build_bucket_keys(spec)


def jax_proof(spec_obj):
    """The JAX package's bytes for one spec: its bucket keys (host SRS,
    host preprocess) and its host-oracle prove with Random(seed)."""
    return _jax_proof(tuple(sorted(spec_obj.items())))


@functools.lru_cache(maxsize=None)
def _jax_proof(items):
    spec = JJ.JobSpec.from_wire(dict(items))
    _, pk, _ = _jax_bucket(spec.kind, tuple(sorted(spec.params.items())))
    return jax_serialize(jax_prove(random.Random(spec.seed),
                                   JJ.build_circuit(spec), pk,
                                   JaxPythonBackend()))


@functools.lru_cache(maxsize=None)
def port_bucket(kind, params):
    """The port's bucket keys for a shape, built once per process on the
    CPU's plain kernels."""
    spec = PJ.JobSpec(kind, dict(params), seed=0)
    return PJ.build_bucket_keys(spec, device="cpu")


def store_with(tmp_path, *specs):
    """A fresh artifact store under tmp_path holding the port's bucket
    keys for each spec's shape (the service then loads them from disk
    instead of building)."""
    root = str(tmp_path / "store")
    store = ArtifactStore(root)
    for obj in specs:
        spec = PJ.JobSpec.from_wire(obj)
        srs, pk, vk = port_bucket(spec.kind,
                                  tuple(sorted(spec.params.items())))
        store_bucket(store, PJ.shape_key(spec), srs, pk, vk)
    return root


def wait_for(pred, timeout_s=120, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# --- specs, queue, journal: the JAX package's behaviour ----------------------

SPECS = [
    {"kind": "toy", "gates": 8, "seed": 3, "priority": 2},
    {"kind": "merkle", "height": 2, "seed": 9},
    {"kind": "merkle", "height": 32, "num_proofs": 50, "seed": 11},
    {"kind": "range", "bits": 8, "count": 2, "seed": 1},
    {"kind": "preimage", "count": 1, "seed": 4, "slo": "flagship"},
    {"kind": "rollup", "height": 16, "updates": 8, "seed": 3,
     "job_key": "k-1", "ttl_s": 30},
    # every error path: the reason string is the JAX package's
    [1, 2],
    {"kind": "nope"},
    {"kind": "toy", "gates": 0},
    {"kind": "toy", "gates": 8, "seed": "x"},
    {"kind": "toy", "gates": 8, "job_key": ""},
    {"kind": "toy", "gates": 8, "ttl_s": -1},
    {"kind": "toy", "gates": 8, "slo": "gold"},
    {"kind": "merkle", "height": 0},
    {"kind": "merkle", "height": 4, "num_proofs": 0},
    {"kind": "merkle", "height": 4, "num_leaves": 0},
    {"kind": "range", "bits": 0},
    {"kind": "preimage", "count": -1},
    {"kind": "rollup", "height": 1},
]


def _parse(mod, obj):
    try:
        spec = mod.JobSpec.from_wire(obj)
    except ValueError as e:
        return ("error", str(e))
    return (spec.to_wire(), mod.shape_key(spec), spec.seed, spec.priority,
            spec.job_key, spec.ttl_s, spec.slo)


@pytest.mark.parametrize("obj", SPECS, ids=lambda o: str(o)[:48])
def test_spec_parse_and_errors_match_jax(obj):
    assert _parse(PJ, obj) == _parse(JJ, obj)


def test_queue_pops_in_the_jax_order():
    """Class, priority and FIFO order, shape batching and the batch cap,
    on interleaved shapes and classes."""
    rng = random.Random(5)
    objs = [dict(rng.choice((TOY_A, TOY_B)), seed=i,
                 priority=rng.randrange(3),
                 slo=rng.choice(("batch", "standard", "flagship")))
            for i in range(24)]
    orders = []
    for mod, qcls in ((PJ, JobQueue), (JJ, JaxJobQueue)):
        q = qcls(max_depth=64)
        jobs = [mod.Job(mod.JobSpec.from_wire(o), job_id="j%02d" % i)
                for i, o in enumerate(objs)]
        for j in jobs:
            q.submit(j)
        out = []
        while True:
            batch = q.pop_batch(max_batch=3, timeout=0)
            if not batch:
                break
            out.append([j.id for j in batch])
        stolen = [mod.Job(mod.JobSpec.from_wire(dict(TOY_A, slo="batch")),
                          job_id="s%d" % i) for i in range(2)]
        for j in stolen:
            q.submit(j)
        out.append(q.steal_lowest(2).id)
        orders.append(out)
    assert orders[0] == orders[1]
    assert len(orders[0]) > 8


def test_journal_replays_across_packages(tmp_path):
    """Records appended by either package replay to the same state in the
    other, torn tail and compaction included."""
    def fill(jn_mod, d):
        j = jn_mod.JobJournal(d, fsync=False)
        j.append(jn_mod.SUBMIT, "job-1", spec=dict(TOY_A, seed=1), key="k1",
                 deadline=None, trace="t1", ts=1.0)
        j.append(jn_mod.START, "job-1", worker="w0g1")
        j.append(jn_mod.ROUND, "job-1", round=2)
        j.append(jn_mod.SUBMIT, "job-2", spec=dict(TOY_B, seed=2), key=None,
                 deadline=9e9, ts=2.0)
        j.append(jn_mod.DONE, "job-2", store_key="proof:job-2",
                 digest="ab", pub=["0x5"], retries=0)
        j.append(jn_mod.AGG, "agg-1", members=["job-2"], agg_hex="00",
                 ts=3.0)
        j.close()
        with open(os.path.join(d, "journal.log"), "ab") as f:
            f.write(b"deadbeef {torn")
    for writer, reader in ((PJN, JJN), (JJN, PJN)):
        d = str(tmp_path / writer.__name__)
        fill(writer, d)
        shutil.copytree(d, d + "-copy")
        a = reader.JobJournal(d, fsync=False)
        b = writer.JobJournal(d + "-copy", fsync=False)
        assert a.state == b.state
        assert a.state["job-1"]["phase"] == "round"
        assert a.state["job-1"]["round"] == 2
        assert a.state["job-2"]["phase"] == "done"
        a.compact()
        b.compact()
        with open(os.path.join(d, "journal.log"), "rb") as f, \
                open(os.path.join(d + "-copy", "journal.log"), "rb") as g:
            assert f.read() == g.read()
        a.close()
        b.close()


# --- no card, no service ---------------------------------------------------------

def test_entry_points_need_the_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProofService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PJ.build_bucket_keys(PJ.JobSpec.from_wire(TOY_A))
    out = subprocess.run(
        [sys.executable, "-m", "distributed_plonk_tpu_torch.service",
         "--port", "0", "--store-dir", str(tmp_path / "s")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "listening" not in out.stdout


# --- the TCP round trip on TorchBackend(device="cpu") --------------------------

def test_tcp_round_trip_on_torch_cpu_matches_jax():
    """Two toy-A jobs and one toy-B job over TCP, proved on the pool's
    default backend (TorchBackend on the service's device). Submission
    order makes the batch deterministic: toy-B goes first, and the two
    toy-A jobs are submitted while the single scheduler thread builds
    toy-B's keys, so its next pop takes both."""
    svc = ProofService(port=0, prover_workers=1, device="cpu").start()
    try:
        with ServiceClient("127.0.0.1", svc.port) as c:
            c.ping()
            ids = [c.submit(dict(TOY_B, seed=3))["job_id"]]
            wait_for(lambda: c.metrics()["counters"].get("bucket_misses"),
                     what="toy-B's key build")
            ids += [c.submit(dict(TOY_A, seed=s))["job_id"] for s in (1, 2)]
            for jid, obj in zip(ids, (dict(TOY_B, seed=3),
                                      dict(TOY_A, seed=1),
                                      dict(TOY_A, seed=2))):
                st = c.wait(jid, timeout_s=300)
                assert st["state"] == "done", st
                header, blob = c.result(jid)
                assert blob == jax_proof(obj), obj
                spec = PJ.JobSpec.from_wire(header["spec"])
                vk = port_bucket(spec.kind,
                                 tuple(sorted(spec.params.items())))[2]
                pub = [int(x, 16) for x in header["public_input"]]
                assert verify(vk, pub, deserialize_proof(blob),
                              rng=random.Random(1))
            m = c.metrics()
        assert m["counters"]["circuit_kind_toy"] == 3
        assert m["counters"]["bucket_misses"] == 2
        assert m["counters"]["placement_batch"] == 1
        assert m["counters"]["placement_pool"] == 1
        assert m["counters"]["batch_jobs"] == 2
        assert m["counters"]["batch_proves"] == 1
        assert "pipelined_proves" not in m["counters"]
        assert m["counters"]["jobs_completed"] == 3
        assert m["histograms"]["prove_round/round1"]["count"] >= 3
        assert svc.get_job(ids[1]).placement == "batch"
    finally:
        svc.shutdown()


def test_queued_single_jobs_prove_as_one_pipeline(tmp_path):
    """Two single jobs (two shapes, so each is its own pool-placed batch
    of one) wait in the dispatch queue while the only worker is held at
    its start; released, it pops the first and coalesces the second into
    one prove_pipelined attempt. Both bytes are the JAX package's."""
    gate = threading.Event()

    def held_backend():
        assert gate.wait(60)
        return PythonBackend()

    specs = [dict(TOY_A, seed=1), dict(TOY_B, seed=3)]
    svc = ProofService(port=0, prover_workers=1, device="cpu",
                       backend_factory=held_backend,
                       store_dir=store_with(tmp_path, TOY_A, TOY_B)).start()
    try:
        jobs = []
        for k, spec in enumerate(specs, 1):
            jobs.append(svc.submit_local(spec))
            wait_for(lambda k=k: svc.pool._dispatch_q.qsize() == k,
                     what="dispatch %d" % k)
        gate.set()
        for job, spec in zip(jobs, specs):
            assert job.done_event.wait(240) and job.state == "done", \
                job.error
            assert job.placement == "pool"
            assert job.proof_bytes == jax_proof(spec), spec
        m = svc.metrics.snapshot()["counters"]
        assert m["pipelined_proves"] == 1 and m["pipelined_jobs"] == 2
        assert m["placement_pool"] == 2 and "batch_proves" not in m
    finally:
        gate.set()
        svc.shutdown()


# --- mesh placement over repeated slots -----------------------------------------

def test_leaser_grants_distinct_slots_of_one_repeated_device():
    leaser = PL.SubmeshLeaser(["cpu"] * 4)
    a = leaser.lease(2)
    b = leaser.lease(2)
    assert a.slots == (0, 1) and b.slots == (2, 3)
    assert a.devices == b.devices == ("cpu", "cpu")
    assert leaser.lease(1, timeout_s=0) is None
    leaser.release(a)
    leaser.release(a)               # double release tolerated
    assert leaser.free_count() == 2
    c = leaser.lease(2)
    assert c.slots == (0, 1)


def test_mesh_placed_job_on_four_cpu_slots_matches_pool_bytes(
        tmp_path, monkeypatch):
    """LARGE_MIN lowered so a toy job is mesh class: it leases 2 of the 4
    "cpu" slots (auto: half the pool), proves on MeshBackend over them,
    self-verifies (auto mode verifies mesh placements), and its bytes
    equal the pool path's (the JAX package's)."""
    monkeypatch.setattr(PL, "LARGE_MIN", 16)
    spec = dict(TOY_A, seed=7)
    svc = ProofService(port=0, prover_workers=1, device="cpu",
                       devices=["cpu"] * 4,
                       store_dir=store_with(tmp_path, TOY_A)).start()
    try:
        job = svc.submit_local(spec)
        assert job.done_event.wait(300) and job.state == "done", job.error
        assert job.placement == "mesh"
        assert job.proof_bytes == jax_proof(spec)
        backend, = svc.scheduler._mesh_backends.values()
        assert backend.name == "mesh" and backend.mesh.size == 2
        assert backend.mesh_msm_calls > 0
        m = svc.metrics.snapshot()["counters"]
        assert m["placement_mesh"] == 1 and m["submesh_leases"] == 1
        assert m["self_verify_checks"] == 1
        assert m["bucket_disk_hits"] == 1 and "bucket_misses" not in m
        assert svc.scheduler.leaser().free_count() == 4
    finally:
        svc.shutdown()
