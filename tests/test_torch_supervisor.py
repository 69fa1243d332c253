"""The port's WorkerSupervisor on the CPU: it spawns port workers
(`python -m distributed_plonk_tpu_torch.runtime.worker --join H:P --listen
H:P --device cpu`) that join a port Dispatcher's membership server, and
keeps them alive.

- a SIGKILLed worker is respawned and re-joins at the same fleet index,
  and the MSM routing rebalances back onto it;
- a crash-looping slot hits the flap cap (FAILED, never respawned
  again), and a member that joined and then keeps dying is LEAVEd: the
  probe planes never revive a LEAVEd index;
- retire_slot drains, LEAVEs and SIGTERMs a worker, and is no flap;
- self-heal under `kill:at=proc:tag=FFT1:worker=1:nth=1` (the proc
  plane, through `proc_killer`): the prove replans and gives the bytes
  of the JAX package's PythonBackend prove, the victim re-joins at its
  index with HEALTH's `warm` stats, and the healed fleet serves at full
  width;
- backend/_build.load takes a cross-process lock: two processes that
  start it together on a tree with nothing built run the build once.
"""

import os
import random
import subprocess
import sys
import time

import torch

from distributed_plonk_tpu_torch import poly as P
from distributed_plonk_tpu_torch import curve as C
from distributed_plonk_tpu_torch import proof_io
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.runtime import protocol
from distributed_plonk_tpu_torch.runtime.dispatcher import RemoteBackend
from distributed_plonk_tpu_torch.runtime.faults import FaultInjector, Rule
from distributed_plonk_tpu_torch.runtime.supervisor import WorkerSupervisor
from distributed_plonk_tpu_torch.service.metrics import Metrics

from test_torch_membership import (REPO, counter, fast_failures,  # noqa
                                   jax_bytes, member_dispatcher, shutdown,
                                   supervised, wait_for, wait_width)
from test_torch_prove import port_keys

torch.set_num_threads(1)

RNG = random.Random(0x5AFE)


def test_worker_command_line():
    sup = WorkerSupervisor("127.0.0.1", 4321, n=2, device="cpu",
                           store_dirs=["/s0"])
    cmd = sup.worker_cmd(0, sup.slots[0])
    assert cmd[:3] == [sys.executable, "-m",
                       "distributed_plonk_tpu_torch.runtime.worker"]
    assert cmd[3:] == ["--join", "127.0.0.1:4321", "--listen",
                       "127.0.0.1:%d" % sup.slots[0].port,
                       "--device", "cpu", "--store", "/s0"]
    assert "--store" not in sup.worker_cmd(1, sup.slots[1])
    card = WorkerSupervisor("127.0.0.1", 4321, n=1)
    assert "--device" not in card.worker_cmd(0, card.slots[0])


def test_supervisor_respawns_and_rejoins_in_place():
    d, sup, metrics = supervised(2)
    try:
        bases = [C.g1_mul(C.G1_GEN, RNG.randrange(1, R_MOD))
                 for _ in range(16)]
        scalars = [RNG.randrange(R_MOD) for _ in range(16)]
        want = C.g1_msm(bases, scalars)
        d.init_bases(bases)
        assert d.msm(scalars) == want

        # slots join concurrently: slot 1's fleet index is its address's
        victim = d.membership._find("127.0.0.1", sup.slots[1].port)
        sup.kill(1)
        wait_for(lambda: counter(metrics, "membership_rejoins") >= 1,
                 msg="rejoin")
        wait_width(d, 2)
        assert len(d.workers) == 2          # the table did not grow
        assert d.membership._find("127.0.0.1", sup.slots[1].port) == victim
        assert counter(metrics, "worker_respawns") == 1
        assert sup.snapshot()[1]["respawns"] == 1
        assert d.msm(scalars) == want
        # the re-provision routes the victim's range back to it
        wait_for(lambda: victim not in d._adopted, msg="re-provision")
        assert d.msm(scalars) == want
    finally:
        shutdown(d, sup)


def test_flap_cap_gives_up():
    d, mserver, metrics = member_dispatcher()
    crash = [sys.executable, "-c", "raise SystemExit(1)"]
    sup = WorkerSupervisor(
        "127.0.0.1", mserver.port, n=1, metrics=metrics, cwd=REPO,
        spawn_cmd=lambda i, slot: crash, probe_interval_s=0.05,
        backoff_base_s=0.02, backoff_max_s=0.1, flap_cap=3,
        flap_window_s=60).start()
    try:
        wait_for(lambda: counter(metrics, "worker_flap_capped") == 1,
                 msg="flap cap")
        assert sup.snapshot()[0]["failed"]
        spawned = len(sup.slots[0].spawn_times)
        assert spawned == 3
        assert sup.active_count() == 0
        # respawning has stopped: a few more watch periods spawn nothing
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline:
            assert len(sup.slots[0].spawn_times) == spawned
            time.sleep(0.05)
        assert len(d.workers) == 0          # it never joined
    finally:
        shutdown(d, sup)


def test_flap_cap_after_join_leaves_the_fleet():
    d, sup, metrics = supervised(
        1, probe_interval_s=0.05, backoff_base_s=0.02, backoff_max_s=0.1,
        flap_cap=2, flap_window_s=3600.0)
    try:
        epoch_before = d.epoch

        def flapped():
            s = sup.snapshot()[0]
            if s["failed"]:
                return True
            if s["alive"]:
                sup.kill(0)   # keep the crash loop going until the cap
            return False
        wait_for(flapped, interval=0.2, msg="flap cap")
        assert counter(metrics, "worker_flap_capped") == 1
        wait_for(lambda: counter(metrics, "membership_leaves") >= 1,
                 msg="leave")
        assert d.epoch > epoch_before
        assert not d.tracker.usable(0)
        # a LEAVEd member is never revived by the probe planes, even if
        # its address answered: only a JOIN brings it back
        assert d.membership.is_left(0)
        d.tracker.force_probe(0)
        d._maybe_readmit()
        assert not d.tracker.usable(0)
        assert list(d._probe_readmit([0])) == []
    finally:
        shutdown(d, sup)


def test_retire_slot_drains_then_leaves():
    d, sup, metrics = supervised(2)
    try:
        retired = d.membership._find("127.0.0.1", sup.slots[1].port)
        assert sup.retire_slot(1) is True
        assert sup.retire_slot(1) is False      # once
        assert sup.active_count() == 1
        snap = sup.snapshot()[1]
        assert snap["retired"] and not snap["failed"] and not snap["alive"]
        assert d.membership.is_left(retired)
        assert d.tracker.usable_set() == [1 - retired]
        # no respawn follows a retire: watch a few periods
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline:
            assert not sup.snapshot()[1]["alive"]
            time.sleep(0.1)
        assert counter(metrics, "worker_retires") == 1
        assert counter(metrics, "worker_respawns") == 0
        assert counter(metrics, "worker_flap_capped") == 0
    finally:
        shutdown(d, sup)


def test_self_heal_under_a_proc_kill(proven, tmp_path):
    ckt, _be, pk, vk = port_keys()
    metrics = Metrics()
    kill_at = []
    faults = FaultInjector(
        [Rule.parse("kill:at=proc:tag=FFT1:worker=1:nth=1")],
        metrics=metrics)
    d, sup, metrics = supervised(
        3, metrics=metrics, faults=faults,
        store_dirs=[str(tmp_path / ("w%d" % i)) for i in range(3)])
    proc_kill = sup.proc_killer(d)

    def stamped_kill(i):
        kill_at.append(time.monotonic())
        proc_kill(i)
    faults.proc_kill_cb = stamped_kill
    try:
        victim_port = d.workers[1].port
        proof = prove(random.Random(1), ckt, pk,
                      RemoteBackend(d, dist_fft_min=ckt.n))
        assert proof_io.serialize_proof(proof) == jax_bytes(proven)
        assert counter(metrics, "faults_injected_kill") == 1
        assert len(kill_at) == 1
        assert counter(metrics, "fleet_fft_replans") >= 1

        def healed():
            return len(d.tracker.usable_set()) == 3 and all(
                w.probe(timeout_ms=2000) is not None for w in d.workers)
        wait_for(healed, interval=0.1, msg="heal to full width")
        assert len(d.workers) == 3 and d.workers[1].port == victim_port
        assert counter(metrics, "worker_respawns") == 1
        assert counter(metrics, "membership_rejoins") == 1
        warm = wait_for(lambda: (d.workers[1].probe() or {}).get("warm"),
                        interval=0.2, msg="warm stats on the rejoined worker")
        assert warm["peers"] == 2 and "warm_rejoin_s" in warm
        # the healed fleet serves a sharded FFT over all three
        stats0 = d.stats()[1].get(str(protocol.FFT2), 0)
        values = [RNG.randrange(R_MOD) for _ in range(64)]
        assert d.fft_dist(values) == P.fft(P.Domain(64), values)
        assert d.stats()[1].get(str(protocol.FFT2), 0) == stats0 + 1
    finally:
        shutdown(d, sup)


_LOCK_CHILD = r"""
import ctypes, os, sys, time
from distributed_plonk_tpu_torch.backend import _build as B
B.BUILD_DIR = sys.argv[1]

def stub_build(out_dir):
    with open(os.path.join(sys.argv[1], "builds"), "a") as f:
        f.write("%d\n" % os.getpid())
    time.sleep(1.0)                     # a build takes a while
    os.makedirs(out_dir, exist_ok=True)
    for name in B.SOURCES:
        open(os.path.join(out_dir, "lib%s.so" % name), "w").close()

class FakeLib:
    def __init__(self, path):
        assert os.path.exists(path), path
    def __getattr__(self, name):
        return type("Fn", (), {})()

B._build = stub_build
B.ctypes.CDLL = FakeLib
while not os.path.exists(os.path.join(sys.argv[1], "go")):
    time.sleep(0.01)
assert sorted(B.load()) == sorted(B.SOURCES)
"""


def test_build_lock_runs_one_build_across_processes(tmp_path):
    """Two processes start load() at the same instant on an empty build
    directory: one builds, the other waits on the lock and loads."""
    procs = [subprocess.Popen([sys.executable, "-c", _LOCK_CHILD,
                               str(tmp_path)], cwd=REPO)
             for _ in range(2)]
    (tmp_path / "go").touch()
    try:
        assert [p.wait(timeout=60) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    builds = (tmp_path / "builds").read_text().split()
    assert len(builds) == 1
