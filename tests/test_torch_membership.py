"""The port's membership plane on the CPU, over real TCP: port workers
started with `--join` (`python -m distributed_plonk_tpu_torch.runtime.worker
--join H:P --listen H:P --device cpu`, every kernel's plain version) join
a port Dispatcher's membership server, most of them spawned by the port's
WorkerSupervisor.

- a worker joining a live 2-wide fleet widens the next sharded FFT to 3
  (the joiner serves FFT_INIT and FFT2), and a prove on the widened fleet
  gives the bytes of the JAX package's PythonBackend prove;
- a worker whose roster moved on refuses an FFT_INIT of another epoch
  (ERR "stale epoch", counted), and ignores an older roster push;
- a joiner with an empty store pulls the `bucket:` artifacts (only those)
  of the roster's store peers and shows the sync in HEALTH's `warm`;
- a ProofService attached to the membership registers a store member as
  a BucketCache peer, serves a bucket from it without a key build, and
  drops it when it LEAVEs;
- the known-answer challenge refuses a worker that still lies
  (`--faults corrupt:at=data:tag=MSM:rate=1`) and passes a clean one;
- quarantine -> LEAVE -> supervisor kill -> respawn -> challenge ->
  rejoin: a worker whose first incarnation lies about its MSM partials is
  caught by duplicate execution mid-prove, the proof still equals the JAX
  prove, and the fleet heals to full width through the challenge;
- a JAX worker joins the port dispatcher's membership server and a port
  worker the JAX dispatcher's (one wire protocol), and each mixed fleet's
  sharded FFT and MSM equal the oracle;
- `Rule.parse` reads the wire, proc and data planes' text forms as the
  JAX package does, and each plane's hook acts as the JAX injector's.

Every wait is event-driven against a deadline, never a fixed sleep.
"""

import os
import random
import subprocess
import sys
import time

import pytest
import torch

from distributed_plonk_tpu import proof_io as JIO
from distributed_plonk_tpu.runtime import faults as JF
from distributed_plonk_tpu.runtime.dispatcher import \
    Dispatcher as JaxDispatcher
from distributed_plonk_tpu.runtime.netconfig import \
    NetworkConfig as JaxNetworkConfig
from distributed_plonk_tpu_torch import curve as C
from distributed_plonk_tpu_torch import poly as P
from distributed_plonk_tpu_torch import proof_io
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.runtime import faults as F
from distributed_plonk_tpu_torch.runtime import protocol
from distributed_plonk_tpu_torch.runtime.dispatcher import (Dispatcher,
                                                            RemoteBackend,
                                                            WorkerHandle)
from distributed_plonk_tpu_torch.runtime.netconfig import NetworkConfig
from distributed_plonk_tpu_torch.runtime.supervisor import (WorkerSupervisor,
                                                            reserve_port)
from distributed_plonk_tpu_torch.service.metrics import Metrics

from test_torch_prove import golden, port_keys

torch.set_num_threads(1)

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
RNG = random.Random(0x5E1F)
WAIT_S = 120
LIAR = "corrupt:at=data:tag=MSM:rate=1"


@pytest.fixture(autouse=True)
def fast_failures(monkeypatch):
    """Short reconnect backoff; one intra-op thread per CPU worker (they
    share cores with the rest of the suite)."""
    monkeypatch.setattr(WorkerHandle, "RECONNECT_TRIES", 2)
    monkeypatch.setattr(WorkerHandle, "BACKOFF_BASE_S", 0.01)
    monkeypatch.setattr(WorkerHandle, "BACKOFF_MAX_S", 0.05)
    monkeypatch.setattr(WorkerHandle, "TIMEOUT_MS", 120000)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def wait_for(cond, timeout_s=WAIT_S, interval=0.05, msg=""):
    deadline = time.monotonic() + timeout_s
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() >= deadline:
            raise AssertionError("timed out waiting for %s" % (msg or cond))
        time.sleep(interval)


def member_dispatcher(metrics=None, faults=None):
    """An empty port Dispatcher with its membership plane armed."""
    metrics = metrics or Metrics()
    d = Dispatcher(NetworkConfig([]), metrics=metrics, faults=faults)
    return d, d.enable_membership(), metrics


def wait_width(d, n):
    wait_for(lambda: len(d.workers) >= n
             and len(d.tracker.usable_set()) >= n, msg="fleet width %d" % n)


def supervised(n, metrics=None, faults=None, **sup_kw):
    """A membership dispatcher and n supervised CPU port workers, joined."""
    d, mserver, metrics = member_dispatcher(metrics=metrics, faults=faults)
    sup = WorkerSupervisor("127.0.0.1", mserver.port, n=n, device="cpu",
                           metrics=metrics, cwd=REPO, **sup_kw).start()
    wait_width(d, n)
    return d, sup, metrics


def shutdown(d, sup=None):
    if sup is not None:
        sup.stop()
    try:
        d.shutdown()
    finally:
        d.pool.shutdown(wait=False)


def counter(metrics, name):
    return metrics.snapshot()["counters"].get(name, 0)


def jax_bytes(proven):
    return JIO.serialize_proof(proven[3])


def static_worker(tmp_path, port, faults=None):
    """One port worker on a static one-entry config (no membership)."""
    cfg = str(tmp_path / ("network-%d.json" % port))
    NetworkConfig(["127.0.0.1:%d" % port]).save(cfg)
    cmd = [sys.executable, "-m", "distributed_plonk_tpu_torch.runtime.worker",
           "0", cfg, "--device", "cpu"]
    if faults:
        cmd += ["--faults", faults]
    return subprocess.Popen(cmd, cwd=REPO)


# --- membership ------------------------------------------------------------

def test_join_mid_life_replans_fft_up(proven):
    ckt, _be, pk, vk = port_keys()
    d, sup, metrics = supervised(2)
    try:
        n = 64
        values = [RNG.randrange(R_MOD) for _ in range(n)]
        want = P.ifft(P.Domain(n), values)
        assert d.fft_dist(values, inverse=True) == want
        epoch_before = d.epoch

        assert sup.add_slot() == 2
        wait_width(d, 3)
        assert d.epoch > epoch_before
        assert counter(metrics, "membership_joins") == 3

        # the next phase boundary plans over the wider fleet: the joiner
        # serves the sharded FFT's frames
        assert d.fft_dist(values, inverse=True) == want
        assert d.workers[2].probe()["epoch"] == d.epoch
        served = d.stats()[2]
        assert served.get(str(protocol.FFT_INIT), 0) >= 1
        assert served.get(str(protocol.FFT2), 0) >= 1

        proof = prove(random.Random(1), ckt, pk,
                      RemoteBackend(d, dist_fft_min=ckt.n))
        blob = proof_io.serialize_proof(proof)
        assert blob == jax_bytes(proven) == golden()
        assert all(d.stats()[i].get(str(protocol.MSM)) for i in range(3))
    finally:
        shutdown(d, sup)


def test_stale_epoch_frame_rejected():
    d, sup, metrics = supervised(1)
    try:
        w = d.workers[0]
        cur = w.probe()["epoch"]
        assert cur == d.epoch >= 2
        newer = cur + 5
        w.call(protocol.ROSTER, protocol.encode_json(
            {"epoch": newer, "workers": ["%s:%d" % (w.host, w.port)]}),
            traced=False)

        def init(epoch):
            return w.call(protocol.FFT_INIT, protocol.encode_fft_init(
                RNG.getrandbits(63), False, False, 16, 4, 4, 0, 4,
                [(0, 4)], epoch=epoch))

        with pytest.raises(RuntimeError, match="stale epoch"):
            init(newer - 1)
        # a frame from AHEAD of the worker's roster names peers its table
        # lacks: refused as loudly
        with pytest.raises(RuntimeError, match="stale epoch"):
            init(newer + 3)
        init(0)        # a sender without membership: accepted
        init(newer)    # the current plan: accepted
        assert d.stats()[0]["stale_epoch"] == 2
        # an OLDER roster push is ignored (epochs only move forward)
        w.call(protocol.ROSTER, protocol.encode_json(
            {"epoch": 1, "workers": []}), traced=False)
        assert w.probe()["epoch"] == newer
    finally:
        shutdown(d, sup)


def test_warm_rejoin_pulls_bucket_artifacts(tmp_path):
    from distributed_plonk_tpu_torch.store import ArtifactStore
    warm_dir = str(tmp_path / "warm")
    warm = ArtifactStore(warm_dir)
    warm.put("bucket:toy-a", b"keys of shape a" * 64, meta={"kind": "t"})
    warm.put("bucket:toy-b", b"keys of shape b" * 32, meta={"kind": "t"})
    warm.put("proof:job-1", b"job-scoped, fetched on demand")
    cold_dir = str(tmp_path / "cold")
    d, sup, metrics = supervised(1, store_dirs=[warm_dir])
    try:
        assert sup.add_slot(store_dir=cold_dir) == 1
        wait_width(d, 2)
        assert d.membership.roster()["stores"] == [
            "127.0.0.1:%d" % s.port for s in sup.slots]
        warm_stats = wait_for(
            lambda: (d.workers[1].probe() or {}).get("warm"),
            interval=0.2, msg="warm rejoin stats")
        assert warm_stats["artifacts"] == 2 and warm_stats["peers"] == 1
        cold = ArtifactStore(cold_dir)
        assert sorted(cold.keys()) == ["bucket:toy-a", "bucket:toy-b"]
        assert cold.get("bucket:toy-a") == warm.get("bucket:toy-a")
        wait_for(lambda: counter(metrics, "warm_rejoins") >= 2,
                 msg="ready reports")
        assert "warm_rejoin_s" in metrics.snapshot()["histograms"]
    finally:
        shutdown(d, sup)


def test_store_member_registered_as_bucket_peer(tmp_path, monkeypatch):
    from distributed_plonk_tpu_torch.service import ProofService
    from distributed_plonk_tpu_torch.service import jobs as J
    from distributed_plonk_tpu_torch.store import ArtifactStore
    from distributed_plonk_tpu_torch.store import keycache as KC

    spec = J.JobSpec.from_wire({"kind": "toy", "gates": 16, "seed": 5})
    warm_dir = str(tmp_path / "warm")
    srs, pk, vk = J.build_bucket_keys(spec, device="cpu")
    KC.store_bucket(ArtifactStore(warm_dir), J.shape_key(spec), srs, pk, vk)

    d, mserver, metrics = member_dispatcher()
    svc = ProofService(port=0, prover_workers=1, device="cpu",
                       store_dir=str(tmp_path / "svc")).start()
    svc.attach_membership(d.membership)
    sup = None
    try:
        assert svc.buckets.peers == [] and svc.fleet_dispatcher is d
        sup = WorkerSupervisor("127.0.0.1", mserver.port, n=1, device="cpu",
                               store_dirs=[warm_dir], metrics=metrics,
                               cwd=REPO).start()
        wait_width(d, 1)
        wait_for(lambda: svc.buckets.peers, msg="peer registration")
        assert svc.buckets.peers == [("127.0.0.1", sup.slots[0].port)]

        def forbidden(*a, **kw):
            raise AssertionError("key build on the peer path")
        monkeypatch.setattr(J, "build_bucket_keys", forbidden)
        res = svc.buckets.get(spec)
        assert res.vk.domain_size == vk.domain_size
        ctr = svc.metrics.snapshot()["counters"]
        assert ctr.get("bucket_peer_hits") == 1
        assert ctr.get("bucket_peers_added") == 1
        # a LEAVEd store member stops being a peer
        d.membership.leave(host="127.0.0.1", port=sup.slots[0].port)
        wait_for(lambda: svc.buckets.peers == [], msg="peer removal")
    finally:
        try:
            svc.shutdown()
        finally:
            shutdown(d, sup)


# --- the integrity plane's way back ------------------------------------------

def test_challenge_rejects_still_corrupt_worker(tmp_path):
    liar_port, clean_port = reserve_port(), reserve_port()
    procs = [static_worker(tmp_path, liar_port, faults=LIAR),
             static_worker(tmp_path, clean_port)]
    metrics = Metrics()
    d = Dispatcher(NetworkConfig([]), metrics=metrics)
    try:
        for port in (liar_port, clean_port):
            wait_for(lambda: WorkerHandle("127.0.0.1", port).probe(),
                     interval=0.2, msg="worker %d" % port)
        assert d.run_challenge("127.0.0.1", liar_port) is False
        assert d.run_challenge("127.0.0.1", clean_port) is True
        assert counter(metrics, "integrity_challenges") == 2
        assert counter(metrics, "integrity_challenges_failed") == 1
        assert WorkerHandle("127.0.0.1", liar_port).probe()[
            "sdc_injected"] == 1
    finally:
        d.pool.shutdown(wait=False)
        for p in procs:
            p.kill()
            p.wait()


def test_quarantine_leave_respawn_challenge_rejoin(proven):
    ckt, _be, pk, vk = port_keys()
    d, mserver, metrics = member_dispatcher()
    # every MSM range is duplicate-executed until the first verdict, then
    # none: each duplicate pushes fresh bases, and a CPU worker's plain
    # MSM context build for them costs seconds
    d.integrity.msm_dup_rate = 1.0
    quarantine = d.quarantine

    def first_verdict(i, reason):
        d.integrity.msm_dup_rate = 0.0
        return quarantine(i, reason)
    d.quarantine = first_verdict
    liar_spawns = []

    def spawn_cmd(i, slot):
        cmd = sup.worker_cmd(i, slot)
        if i == 1 and not liar_spawns:
            # only the FIRST incarnation lies: the respawn is clean and
            # must pass the challenge
            liar_spawns.append(time.monotonic())
            cmd += ["--faults", LIAR]
        return cmd

    sup = WorkerSupervisor("127.0.0.1", mserver.port, n=3, device="cpu",
                           metrics=metrics, cwd=REPO, spawn_cmd=spawn_cmd)
    sup.attach_registry(d.membership)
    sup.start()
    try:
        wait_width(d, 3)
        liar = d.membership._find("127.0.0.1", sup.slots[1].port)
        proof = prove(random.Random(1), ckt, pk,
                      RemoteBackend(d, dist_fft_min=ckt.n))
        assert proof_io.serialize_proof(proof) == jax_bytes(proven)
        assert counter(metrics, "workers_quarantined") >= 1
        assert counter(metrics, "integrity_failures") >= 1
        assert counter(metrics, "membership_leaves") >= 1
        assert liar in d.quarantined

        # the supervisor kills the liar, the clean respawn rejoins in
        # place through the challenge, and the fleet is whole again
        wait_width(d, 3)
        assert len(d.workers) == 3
        assert counter(metrics, "worker_respawns") >= 1
        assert counter(metrics, "membership_rejoins") >= 1
        assert counter(metrics, "integrity_challenges") >= 1
        assert counter(metrics, "integrity_challenges_failed") == 0
        assert not d.tracker.is_suspect(liar)
        assert ("127.0.0.1", sup.slots[1].port) not in \
            d.membership.quarantined
        assert d.workers[liar].probe()["sdc_injected"] == 0
    finally:
        shutdown(d, sup)


# --- one wire protocol: each package's worker joins the other's dispatcher ---

def _jax_worker(join_port, port):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_plonk_tpu.runtime.worker",
         "--join", "127.0.0.1:%d" % join_port,
         "--listen", "127.0.0.1:%d" % port, "--backend", "python"],
        cwd=REPO, env=env)


def _port_worker(join_port, port):
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_plonk_tpu_torch.runtime.worker",
         "--join", "127.0.0.1:%d" % join_port,
         "--listen", "127.0.0.1:%d" % port, "--device", "cpu"], cwd=REPO)


@pytest.mark.parametrize("dispatcher_pkg", ["port", "jax"])
def test_workers_join_the_other_packages_dispatcher(dispatcher_pkg):
    """A port dispatcher's fleet of one port and one JAX worker, and a JAX
    dispatcher's fleet of one JAX and one port worker: both join through
    the dispatcher's membership server, and the mixed fleet's sharded FFT
    (over both) and MSM (one range each) equal the oracle."""
    if dispatcher_pkg == "port":
        d = Dispatcher(NetworkConfig([]))
    else:
        d = JaxDispatcher(JaxNetworkConfig([]))
    mserver = d.enable_membership()
    ports = [reserve_port(), reserve_port()]
    procs = [_port_worker(mserver.port, ports[0]),
             _jax_worker(mserver.port, ports[1])]
    try:
        wait_for(lambda: len(d.workers) == 2
                 and len(d.tracker.usable_set()) == 2, msg="both joined")
        assert sorted(p for _h, p in d.membership.addresses()) \
            == sorted(ports)
        backends = sorted(d.workers[i].probe()["backend"] for i in (0, 1))
        assert backends == ["python", "torch"]
        n = 64
        values = [RNG.randrange(R_MOD) for _ in range(n)]
        assert d.fft_dist(values, coset=True) == \
            P.coset_fft(P.Domain(n), values)
        bases = [C.g1_mul(C.G1_GEN, RNG.randrange(1, R_MOD))
                 for _ in range(12)]
        scalars = [RNG.randrange(R_MOD) for _ in range(12)]
        d.init_bases(bases)
        assert d.msm(scalars) == C.g1_msm(bases, scalars)
        assert d.epoch == 3
    finally:
        for p in procs:
            p.kill()
            p.wait()
        d.pool.shutdown(wait=False)
        if d._member_server is not None:
            d._member_server.close()


# --- the wire, proc and data fault planes ------------------------------------

RULE_TEXTS = [
    "kill:at=proc:tag=FFT1:worker=1:nth=1",
    "corrupt:at=data:tag=MSM:rate=1",
    "drop:tag=FFT2:nth=2",
    "delay:tag=MSM:ms=20",
    "corrupt:tag=NTT:worker=0:max=3",
    "kill:tag=9:worker=2",
    "kill:at=journal:tag=ROUND2",
    "corrupt_ckpt:tag=2",
]


@pytest.mark.parametrize("text", RULE_TEXTS)
def test_rule_parse_equals_the_jax_parse(text):
    keys = ("action", "tag", "worker", "nth", "rate", "ms", "max_fires",
            "plane")
    port, jax = F.Rule.parse(text), JF.Rule.parse(text)
    assert [getattr(port, k) for k in keys] == \
        [getattr(jax, k) for k in keys]


@pytest.mark.parametrize("plane", ["wire", "proc", "data"])
def test_fault_planes_act_as_the_jax_injector(plane):
    """The same rules and the same calls give the same effects and the
    same counts in both packages' injectors."""
    def run(mod):
        killed, proc_killed, effects = [], [], []
        if plane == "data":
            rules = [mod.Rule.parse("corrupt:at=data:tag=MSM:worker=1:nth=2")]
        else:
            at = ":at=proc" if plane == "proc" else ""
            rules = [mod.Rule.parse("kill%s:tag=FFT1:worker=1:nth=2" % at),
                     mod.Rule.parse("drop:tag=FFT2:nth=1"),
                     mod.Rule.parse("corrupt:tag=NTT:nth=1")]
        inj = mod.FaultInjector(rules, kill_cb=killed.append,
                                proc_kill_cb=proc_killed.append)
        for worker, tag in ((1, protocol.FFT1), (0, protocol.FFT1),
                            (1, protocol.FFT1), (1, protocol.MSM),
                            (1, protocol.MSM), (0, protocol.FFT2),
                            (0, protocol.NTT), (0, protocol.NTT)):
            if plane == "data":
                effects.append(inj.on_data(worker, tag))
                continue
            try:
                effects.append(inj.on_send(worker, tag, b""))
            except ConnectionError as e:
                effects.append(type(e).__name__)
        return killed, proc_killed, effects, inj.counts()

    assert run(F) == run(JF)
    killed, proc_killed, effects, _ = run(F)
    if plane == "wire":
        assert killed == [1] and proc_killed == []
    elif plane == "proc":
        assert killed == [] and proc_killed == [1]
    else:
        assert effects == [False] * 4 + [True] + [False] * 3
    if plane != "data":
        assert "InjectedDrop" in effects
        assert protocol.NTT ^ 0x40000000 in effects
