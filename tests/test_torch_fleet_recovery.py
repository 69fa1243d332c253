"""The port fleet's fault handling on the CPU, over real TCP: three port
workers (`--device cpu`) behind port Dispatchers whose worker handles a
test wraps to plant faults on the dispatcher's side of the wire.

- a worker's ERR reply (here: a frame the test cuts to 5 bytes, which
  the worker fails to decode) raises WorkerError from ntt, msm and eval_many,
  and nothing is routed around;
- a wrong FFT2 panel (one element off by one, the partials left honest)
  fails the sharded FFT's Schwartz-Zippel check: the worker is
  quarantined and the replan on the other two gives the oracle's answer;
- a wrong MSM partial, off the curve or on it (caught by duplicate
  execution), is quarantined and its range recomputed;
- a worker killed mid-prove (at its first FFT1 frame) is routed around:
  the FFT replans on the survivors, its MSM range is adopted, and the
  proof still equals tests/fixtures/proof_small.hex and verifies. Every
  recovery shows in the dispatcher's counters.

The kill runs last: it takes worker 2 down for the rest of the module.
Ports 22000 + 3 * (pid % 300): clear of the JAX package's fleet tests and
of test_torch_fleet.py's.
"""

import collections
import os
import random
import subprocess
import sys
import time

import pytest
import torch

from distributed_plonk_tpu_torch import curve as C
from distributed_plonk_tpu_torch import poly as P
from distributed_plonk_tpu_torch import proof_io
from distributed_plonk_tpu_torch.constants import Q_MOD, R_MOD
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.runtime import protocol
from distributed_plonk_tpu_torch.runtime.dispatcher import (
    Dispatcher, RemoteBackend, WorkerError)
from distributed_plonk_tpu_torch.runtime.netconfig import NetworkConfig
from distributed_plonk_tpu_torch.verifier import verify

from test_torch_prove import golden, port_keys

torch.set_num_threads(1)

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
RNG = random.Random(0x5ECF)


class Counts:
    """A metrics registry (inc / gauge / observe) that keeps the counts."""

    def __init__(self):
        self.c = collections.Counter()

    def inc(self, name, by=1):
        self.c[name] += by

    def gauge(self, name, value):
        pass

    def observe(self, name, seconds):
        pass


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Three port workers on the CPU: (config, processes); the processes
    are always reaped."""
    base = 22000 + (os.getpid() % 300) * 3
    cfg = NetworkConfig([f"127.0.0.1:{base + i}" for i in range(3)])
    cfg_path = str(tmp_path_factory.mktemp("port-fleet3") / "network.json")
    cfg.save(cfg_path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_plonk_tpu_torch.runtime.worker",
         str(i), cfg_path, "--device", "cpu"], cwd=REPO, env=env)
        for i in range(3)]
    try:
        deadline = time.time() + 60
        d = Dispatcher(cfg)
        while any(w.probe(timeout_ms=2000) is None for w in d.workers):
            assert time.time() < deadline, "port workers did not come up"
            time.sleep(0.3)
        d.pool.shutdown()
        yield cfg, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.fixture
def dispatcher(fleet):
    """A fresh Dispatcher (no quarantine, no adoption yet) and its
    counts."""
    counts = Counts()
    made = []

    def make():
        d = Dispatcher(fleet[0], metrics=counts)
        made.append(d)
        return d, counts.c

    yield make
    for d in made:
        for w in d.workers:
            w.close()
        d.pool.shutdown()


def _wrap(handle, fn):
    """Route handle.call through fn(call, tag, payload, **kw)."""
    call = handle.call
    handle.call = lambda tag, payload=b"", **kw: fn(call, tag, payload, **kw)


def _oracle(values, inverse, coset):
    fn = {(False, False): P.fft, (True, False): P.ifft,
          (False, True): P.coset_fft, (True, True): P.coset_ifft}
    return fn[(inverse, coset)](P.Domain(len(values)), values)


def _msm_case():
    bases = [C.g1_mul(C.G1_GEN, RNG.randrange(1, R_MOD)) for _ in range(24)]
    scalars = [RNG.randrange(R_MOD) for _ in range(24)]
    return bases, scalars


@pytest.mark.parametrize("op", ["ntt", "msm", "eval"])
def test_worker_error_fails_the_call(dispatcher, op):
    d, counts = dispatcher()
    tag = {"ntt": protocol.NTT, "msm": protocol.MSM,
           "eval": protocol.EVAL}[op]
    for w in d.workers:
        _wrap(w, lambda call, t, payload, **kw: call(
            t, payload[:5] if t == tag else payload, **kw))
    values = [RNG.randrange(R_MOD) for _ in range(64)]
    with pytest.raises(WorkerError, match="error"):
        if op == "ntt":
            d.ntt(values)
        elif op == "msm":
            bases, scalars = _msm_case()
            d.init_bases(bases)
            d.msm(scalars)
        else:
            d.eval_many([(values, 5)])
    assert not counts, counts          # nothing rerouted, nothing adopted
    assert d.tracker.usable_set() == [0, 1, 2]


@pytest.mark.parametrize("inverse,coset", [(False, True), (True, True)])
def test_wrong_fft2_panel_is_quarantined(dispatcher, inverse, coset):
    d, counts = dispatcher()

    def lie(call, tag, payload, **kw):
        raw = call(tag, payload, **kw)
        if tag != protocol.FFT2:
            return raw
        partials, panel = protocol.split_fft2_reply(raw)
        v = (protocol.decode_scalar(panel) + 1) % R_MOD
        panel = protocol.encode_scalar(v) + panel[protocol.FR_BYTES:]
        return protocol.encode_fft2_partials(*partials, panel)

    _wrap(d.workers[1], lie)
    values = [RNG.randrange(R_MOD) for _ in range(128)]
    assert d.fft_dist(values, inverse, coset) == \
        _oracle(values, inverse, coset)
    assert list(d.quarantined) == [1]
    assert counts["workers_quarantined"] == 1
    assert counts["fleet_fft_replans"] == 1
    assert d.tracker.usable_set() == [0, 2]


@pytest.mark.parametrize("wrong", ["off-curve", "on-curve"])
def test_wrong_msm_partial_is_quarantined(dispatcher, wrong):
    d, counts = dispatcher()
    # an on-curve lie is seen only by duplicate execution: sample it
    # always there, and never for the lie the group-law check sees
    d.integrity.msm_dup_rate = 1.0 if wrong == "on-curve" else 0.0

    def lie(call, tag, payload, **kw):
        raw = call(tag, payload, **kw)
        if tag != protocol.MSM:
            return raw
        x, y = protocol.decode_point(raw)
        bad = (x, (y + 1) % Q_MOD) if wrong == "off-curve" \
            else C.g1_add_affine((x, y), C.G1_GEN)
        return protocol.encode_point(bad)

    _wrap(d.workers[1], lie)
    bases, scalars = _msm_case()
    d.init_bases(bases)
    assert d.msm(scalars) == C.g1_msm(bases, scalars)
    assert list(d.quarantined) == [1]
    assert counts["workers_quarantined"] == 1
    assert not d.tracker.usable(1)


def test_prove_survives_a_worker_killed_mid_prove(fleet, dispatcher):
    """Runs last: worker 2 stays down."""
    _, procs = fleet
    ckt, _, pk, vk = port_keys()
    d, counts = dispatcher()

    def kill_at_fft1(call, tag, payload, **kw):
        if tag == protocol.FFT1 and procs[2].poll() is None:
            procs[2].kill()
            procs[2].wait()
        return call(tag, payload, **kw)

    _wrap(d.workers[2], kill_at_fft1)
    proof = prove(random.Random(1), ckt, pk,
                  RemoteBackend(d, dist_fft_min=ckt.n))
    assert procs[2].poll() is not None
    assert proof_io.serialize_proof(proof) == golden()
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(2))
    assert counts["fleet_fft_replans"] >= 1
    assert counts["fleet_range_adoptions"] >= 1
    assert counts["fleet_breaker_opens"] >= 1
    assert not d.quarantined and counts["workers_quarantined"] == 0
    assert d.tracker.usable_set() == [0, 1]
