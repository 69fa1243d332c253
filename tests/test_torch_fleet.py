"""The port's worker fleet on the CPU, over real TCP: two port workers
(`python -m distributed_plonk_tpu_torch.runtime.worker i cfg --device cpu`,
every kernel's plain torch version) driven by the port's Dispatcher.

- msm, whole-polynomial ntt and the sharded 4-step fft_dist in every
  (inverse, coset) mode equal the port's host oracle (poly, curve);
- a prove through RemoteBackend(d, dist_fft_min=ckt.n) (every NTT of the
  prove sharded across both workers) and through RemoteBackend(d) (whole
  NTTs round-robin) gives tests/fixtures/proof_small.hex and verifies,
  with the integrity plane on (its default), and both workers served
  FFT2, FFT_EXCHANGE, MSM and EVAL;
- the JAX package's Dispatcher drives the same workers (the wire protocol
  is shared): its fft_dist and msm equal the oracle;
- the observability tags (METRICS_FETCH, LOG_FETCH, PROFILE) answer on
  every worker, and the dispatcher methods that read them return each
  worker's snapshot and capture (test_torch_fleet_obs.py covers the
  plane; the membership plane's ROSTER, JOIN and LEAVE are tested in
  test_torch_membership.py); STORE_FETCH and STORE_LIST on a worker
  without --store answer the JAX worker's "no store" ERR.

Ports 20000 + 2 * (pid % 500): clear of the JAX package's fleet tests.
"""

import os
import random
import subprocess
import sys
import time

import pytest
import torch

from distributed_plonk_tpu.runtime import protocol as JP
from distributed_plonk_tpu.runtime.dispatcher import \
    Dispatcher as JaxDispatcher
from distributed_plonk_tpu.runtime.netconfig import \
    NetworkConfig as JaxNetworkConfig
from distributed_plonk_tpu_torch import curve as C
from distributed_plonk_tpu_torch import poly as P
from distributed_plonk_tpu_torch import proof_io
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.runtime import protocol
from distributed_plonk_tpu_torch.runtime.dispatcher import (Dispatcher,
                                                            RemoteBackend)
from distributed_plonk_tpu_torch.runtime.netconfig import NetworkConfig
from distributed_plonk_tpu_torch.trace import Tracer
from distributed_plonk_tpu_torch.verifier import verify

from test_torch_prove import golden, port_keys

torch.set_num_threads(1)

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
RNG = random.Random(0xF1EE7)


def _oracle(values, inverse, coset):
    domain = P.Domain(len(values))
    fn = {(False, False): P.fft, (True, False): P.ifft,
          (False, True): P.coset_fft, (True, True): P.coset_ifft}
    return fn[(inverse, coset)](domain, values)


def test_protocol_is_wire_identical():
    """The port's protocol copy has the JAX package's tags and codecs:
    the same numbers, the same bytes."""
    assert protocol.TAG_NAMES == JP.TAG_NAMES
    assert protocol.TRACED == JP.TRACED
    vals = [RNG.randrange(R_MOD) for _ in range(6)]
    pts = [C.g1_mul(C.G1_GEN, 5), None]
    cases = [
        ("encode_ntt_request", (vals, True, False)),
        ("encode_msm_request", (3, vals)),
        ("encode_init_bases", (7, pts)),
        ("encode_eval_request", (vals[0], vals[1:])),
        ("encode_fft2_request", (9, vals[2])),
        ("encode_fft2_partials", (vals[0], vals[1], b"\0" * 32)),
        ("encode_fft_init", (1, True, True, 64, 8, 8, 0, 4,
                             [(0, 4), (4, 8)], 0, True)),
    ]
    for name, args in cases:
        assert getattr(protocol, name)(*args) == getattr(JP, name)(*args)
    m = protocol.ints_to_matrix(vals)
    assert (m == JP.ints_to_matrix(vals)).all()
    assert protocol.matrix_to_ints(m) == vals
    panel = m.reshape(16, 2, 3)
    assert protocol.encode_fft1_matrix(4, 2, panel) == \
        JP.encode_fft1_matrix(4, 2, panel)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two port workers on the CPU and a connected port Dispatcher; the
    worker processes are always reaped."""
    base = 20000 + (os.getpid() % 500) * 2
    cfg = NetworkConfig([f"127.0.0.1:{base}", f"127.0.0.1:{base + 1}"])
    cfg_path = str(tmp_path_factory.mktemp("port-fleet") / "network.json")
    cfg.save(cfg_path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_plonk_tpu_torch.runtime.worker",
         str(i), cfg_path, "--device", "cpu"], cwd=REPO, env=env)
        for i in range(2)]
    try:
        d = None
        deadline = time.time() + 60
        while d is None and time.time() < deadline:
            try:
                d = Dispatcher(cfg)
                d.ping()
            except (ConnectionError, OSError):
                d = None
                time.sleep(0.3)
        assert d is not None, "port workers did not come up"
        d.cfg_path = cfg_path
        yield d
        d.shutdown()
        for p in procs:
            p.wait(timeout=10)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_workers_report_torch_backend(fleet):
    for snap in fleet.health():
        assert snap["backend"] == "torch" and snap["device"] == "cpu"
        assert set(snap["launches"]) >= {"mont_mul", "ntt"}


def test_msm_and_ntt_match_the_oracle(fleet):
    n = 48
    bases = [C.g1_mul(C.G1_GEN, RNG.randrange(1, R_MOD))
             for _ in range(n - 1)] + [None]
    scalars = [RNG.randrange(R_MOD) for _ in range(n - 1)] + [0]
    fleet.init_bases(bases)
    assert fleet.msm(scalars) == C.g1_msm(bases, scalars)
    values = [RNG.randrange(R_MOD) for _ in range(64)]
    for inverse in (False, True):
        for coset in (False, True):
            assert fleet.ntt(values, inverse, coset) == \
                _oracle(values, inverse, coset)


@pytest.mark.parametrize("coset", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_fft_matches_the_oracle(fleet, inverse, coset):
    """Square (n = 64: r = c = 8) and uneven (n = 128: r = 8, c = 16)
    splits, with the integrity plane's partials on every FFT2 reply."""
    for n in (64, 128):
        values = [RNG.randrange(R_MOD) for _ in range(n)]
        assert fleet.fft_dist(values, inverse, coset) == \
            _oracle(values, inverse, coset)


@pytest.fixture(scope="module")
def remote(fleet):
    """One RemoteBackend for both proves: the commit key's base ranges are
    pushed to the workers once."""
    return RemoteBackend(fleet)


@pytest.mark.parametrize("sharded", [True, False])
def test_fleet_prove_matches_golden(fleet, remote, sharded):
    ckt, _, pk, vk = port_keys()
    before = fleet.stats()
    remote.dist_fft_min = ckt.n if sharded else None
    proof = prove(random.Random(1), ckt, pk, remote)
    assert proof_io.serialize_proof(proof) == golden()
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(2))
    served = [{t: s.get(str(t), 0) - b.get(str(t), 0) for t in (
        protocol.FFT2, protocol.FFT_EXCHANGE, protocol.MSM, protocol.EVAL,
        protocol.NTT)} for s, b in zip(fleet.stats(), before)]
    tags = (protocol.FFT2, protocol.FFT_EXCHANGE) if sharded \
        else (protocol.NTT,)
    for counts in served:
        assert all(counts[t] > 0 for t in tags + (protocol.MSM,
                                                   protocol.EVAL)), served


def test_worker_spans_join_the_dispatchers_trace(fleet):
    """A traced dispatcher's calls carry its trace context; each worker
    records its serve spans under that trace, children of the rpc spans,
    and hands them back on TRACE_DUMP for the merged timeline."""
    tr = Tracer(proc="dispatcher")
    d = Dispatcher(NetworkConfig.load(fleet.cfg_path), tracer=tr)
    try:
        values = [RNG.randrange(R_MOD) for _ in range(64)]
        assert d.fft_dist(values, False, True) == \
            _oracle(values, False, True)
        merged = d.collect_trace()
    finally:
        for w in d.workers:
            w.close()
        d.pool.shutdown()
    assert merged["trace_id"] == tr.trace_id
    procs = {p["proc"] for p in merged["processes"]}
    assert procs == {"dispatcher", "worker/0", "worker/1"}
    rpc = {ev["sid"] for ev in merged["events"]
           if ev["span"].startswith("rpc/")}
    served = [ev for ev in merged["events"]
              if ev["proc"].startswith("worker")
              and ev["span"] == "serve/fft2"]
    assert len(served) == 2 and all(ev["parent"] in rpc for ev in served)


def test_jax_dispatcher_drives_port_workers(fleet):
    d = JaxDispatcher(JaxNetworkConfig.load(fleet.cfg_path))
    try:
        for inverse, coset in ((False, True), (True, True), (True, False)):
            values = [RNG.randrange(R_MOD) for _ in range(128)]
            assert d.fft_dist(values, inverse, coset) == \
                _oracle(values, inverse, coset)
        bases = [C.g1_mul(C.G1_GEN, k + 3) for k in range(20)]
        scalars = [RNG.randrange(R_MOD) for _ in range(20)]
        d.init_bases(bases)
        assert d.msm(scalars) == C.g1_msm(bases, scalars)
    finally:
        for w in d.workers:
            w.close()
        d.pool.shutdown()


@pytest.mark.parametrize("tag", ["METRICS_FETCH", "LOG_FETCH", "PROFILE"])
def test_observability_planes_answer(fleet, tag):
    import json
    req = {"duration_ms": 20} if tag == "PROFILE" else {}
    raw = fleet.workers[0].call(getattr(protocol, tag),
                                protocol.encode_json(req))
    if tag == "PROFILE":
        meta, blob = protocol.decode_result(raw)
        assert meta["format"] == "pystacks-json" and meta["worker"] == 0
        assert json.loads(blob)["samples"] >= 1
    elif tag == "LOG_FETCH":
        assert set(json.loads(raw)) == {"events", "seq"}
    else:
        snap = json.loads(raw)
        assert snap["index"] == 0 and snap["backend"] == "torch"
        assert snap["counters"]["served_metrics_fetch"] >= 1


@pytest.mark.parametrize("tag", ["STORE_FETCH", "STORE_LIST"])
def test_store_plane_without_a_store_answers_err(fleet, tag):
    """The store plane is ported: a worker launched without --store
    answers the JAX worker's ERR reason (test_torch_store.py fetches from
    one launched with it)."""
    with pytest.raises(RuntimeError, match="no store on this worker"):
        fleet.workers[0].call(getattr(protocol, tag),
                              protocol.encode_json({"key": "bucket:x"}))


@pytest.mark.parametrize("method", ["fleet_metrics", "profile_worker"])
def test_dispatcher_reads_the_observability_planes(fleet, method):
    if method == "profile_worker":
        meta, blob = fleet.profile_worker(1, duration_ms=20)
        assert meta["worker"] == 1 and meta["format"] == "pystacks-json"
        assert len(blob) == meta["bytes"]
    else:
        entries = fleet.fleet_metrics()
        assert [e["index"] for e in entries] == [0, 1]
        assert all(e["reachable"] and e["snapshot"]["device"] == "cpu"
                   for e in entries)


def test_worker_needs_the_card_unless_asked_for_cpu(tmp_path):
    """Without --device the worker builds TorchBackend() on the card and
    exits with the CUDA error where there is none."""
    cfg = tmp_path / "network.json"
    NetworkConfig(["127.0.0.1:1"]).save(str(cfg))
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "from distributed_plonk_tpu_torch.runtime import worker\n"
            "worker.main(['0', %r])\n" % str(cfg))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
