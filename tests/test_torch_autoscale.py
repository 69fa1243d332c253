"""The port's closed-loop autoscaler on the CPU.

- Control-law parity: the same sensor sequences, fake actuators and
  injected clock drive the JAX package's `Autoscaler.tick()` and the
  port's; their decision lists (timestamps aside), actuator calls and
  `state()` are equal, in every scenario: scale up after the hysteresis
  streak, the cooldown and the ceiling, scale down at the idle streak and
  the floor, the lease resize, the pressure shed, dry mode (decisions,
  zero actuator calls) and off (`attach` builds nothing).
- The sensors' sources: `JobQueue.depth_by_class` and
  `SubmeshLeaser.capacity` / `set_capacity` equal the JAX package's.
- The canary: a supervised fleet of one CPU port worker behind a
  ProofService proving through RemoteBackend, with the actuating
  autoscaler attached: a queue of toy jobs scales the fleet up (a JOIN),
  every proof equals the JAX package's bytes, and the idle service
  retires back to one worker by drain-then-LEAVE (no respawn, no flap).
"""

import random

import pytest
import torch

from distributed_plonk_tpu.service import autoscale as JAS
from distributed_plonk_tpu.service import jobs as JJ
from distributed_plonk_tpu.service import placement as JPL
from distributed_plonk_tpu.service.queue import JobQueue as JaxQueue
from distributed_plonk_tpu_torch.runtime.dispatcher import RemoteBackend
from distributed_plonk_tpu_torch.service import ProofService, ServiceClient
from distributed_plonk_tpu_torch.service import autoscale as AS
from distributed_plonk_tpu_torch.service import jobs as PJ
from distributed_plonk_tpu_torch.service import placement as PPL
from distributed_plonk_tpu_torch.service.metrics import Metrics
from distributed_plonk_tpu_torch.service.queue import JobQueue

from test_torch_membership import (counter, fast_failures,  # noqa
                                   shutdown, supervised, wait_for)
from test_torch_service import TOY_A, jax_proof

torch.set_num_threads(1)


class FakeActuators:
    def __init__(self, workers=1):
        self.workers = workers
        self.calls = []

    def worker_count(self):
        return self.workers

    def add_worker(self):
        self.calls.append("add")
        self.workers += 1
        return self.workers - 1

    def retire_worker(self):
        self.calls.append("retire")
        self.workers -= 1
        return self.workers

    def lease_capacity(self, frac):
        self.calls.append(("lease", frac))
        return max(1, int(8 * frac))

    def shed_lowest(self, below_rank):
        self.calls.append(("shed", below_rank))
        return "batch"


QUEUED = {"queue_depth": 8, "busy_workers": 1}
IDLE = {"queue_depth": 0, "busy_workers": 0}
FULL = {"queue_depth": 60, "busy_workers": 1, "max_depth": 64}

# name -> (controller settings, workers, [(seconds elapsed, sensors)])
SCENARIOS = {
    "up": ({}, 1, [(1, QUEUED)] * 3 + [(20, QUEUED)] * 2
           + [(1, dict(IDLE, busy_workers=1, p95_standard_s=9.0))] * 3),
    "cooldown": ({"max_workers": 2}, 1,
                 [(1, QUEUED)] * 4 + [(20, QUEUED)] * 2),
    "down": ({"down_cooldown_s": 0}, 3, [(1, IDLE)] * 9),
    "lease": ({"up_queue_per_worker": 10}, 1, [
        (1, dict(QUEUED, queue_depth=4, queue_by_class={"batch": 4})),
        (1, dict(QUEUED, queue_depth=4,
                 queue_by_class={"batch": 3, "flagship": 1})),
        (1, dict(QUEUED, queue_depth=4, queue_by_class={"batch": 4})),
        (1, IDLE)]),
    "shed": ({"max_workers": 2}, 2, [(1, FULL)] * 3),
    "dry": ({"mode": "dry"}, 1, [(1, FULL)] * 4 + [(1, IDLE)] * 4),
    "off": ({"mode": "0"}, 1, [(1, FULL)] * 3),
}


def run_scenario(mod, name):
    settings, workers, steps = SCENARIOS[name]
    box = {"t": 0.0, "sensors": {}}
    act = FakeActuators(workers)
    kw = dict(mode="1", tick_s=0.01, min_workers=1, max_workers=3,
              up_queue_per_worker=2, up_ticks=2, down_ticks=3,
              up_cooldown_s=10, down_cooldown_s=10,
              slo_p95_standard_s=5.0, shed_watermark=0.9)
    kw.update(settings)
    asc = mod.Autoscaler(sensors=lambda: dict(box["sensors"]),
                         actuators=act, metrics=Metrics(),
                         clock=lambda: box["t"], **kw)
    decisions = []
    for dt, sensors in steps:
        box["t"] += dt
        box["sensors"] = dict({"queue_depth": 0, "queue_by_class": {},
                               "max_depth": 64, "busy_workers": 0}, **sensors)
        decisions.append([{k: v for k, v in d.items() if k != "ts"}
                          for d in asc.tick()])
    state = asc.state()
    state["last_decisions"] = [{k: v for k, v in d.items() if k != "ts"}
                               for d in state["last_decisions"]]
    return decisions, act.calls, state


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_control_law_equals_the_jax_autoscaler(name):
    port = run_scenario(AS, name)
    assert port == run_scenario(JAS, name)
    decisions, calls, state = port
    actions = [d["action"] for tick in decisions for d in tick]
    if name == "up":
        assert actions == ["scale_up", "scale_up"] and calls == ["add"] * 2
        assert decisions[1][0]["applied"] and not decisions[2]
    elif name == "cooldown":
        assert actions == ["scale_up"] and calls == ["add"]
    elif name == "down":
        assert actions == ["scale_down"] * 2 and state["workers"] == 1
    elif name == "lease":
        assert calls == [("lease", 0.5), ("lease", 1.0), ("lease", 0.5),
                         ("lease", 1.0)]
    elif name == "shed":
        assert actions == ["shed"] * 3
        assert calls == [("shed", PJ.SLO_RANK["flagship"])] * 3
    elif name == "dry":
        assert calls == [] and {"scale_up", "shed"} <= set(actions)
        assert not any(d["applied"] for tick in decisions for d in tick)
    else:
        assert calls == [] and state["mode"] == "0"


def test_off_mode_attaches_nothing():
    class Svc:
        autoscaler = None
    svc = Svc()
    assert AS.attach(svc) is None and AS.attach(svc, mode="0") is None
    assert JAS.attach(svc, mode="0") is None
    assert svc.autoscaler is None
    with pytest.raises(ValueError):
        AS.Autoscaler(mode="on")
    assert ProofService(port=0, device="cpu").attach_autoscaler() is None


def test_depth_by_class_equals_the_jax_queue():
    rng = random.Random(7)
    objs = [dict(TOY_A, seed=i, slo=rng.choice(
        ("batch", "standard", "flagship", None))) for i in range(12)]
    qs = (JobQueue(max_depth=16), JaxQueue(max_depth=16))
    for obj in objs:
        wire = {k: v for k, v in obj.items() if v is not None}
        qs[0].submit(PJ.Job(PJ.JobSpec.from_wire(wire)))
        qs[1].submit(JJ.Job(JJ.JobSpec.from_wire(wire)))
    for q in qs:
        q.pop_batch(max_batch=2)
    assert qs[0].depth_by_class() == qs[1].depth_by_class()
    assert sum(qs[0].depth_by_class().values()) == qs[0].depth()


def test_leaser_capacity_equals_the_jax_leaser():
    """Shrink with leases out, releases parked past the capacity, growth
    returning the reserve: capacity and free count after every step."""
    def run(mod):
        leaser = mod.SubmeshLeaser([object() for _ in range(4)])
        trace = []
        a = leaser.lease(2)
        trace.append((leaser.capacity(), leaser.free_count(), len(a)))
        trace.append((leaser.set_capacity(3), leaser.free_count()))
        b = leaser.lease(1, timeout_s=0)
        trace.append((len(b), leaser.free_count()))
        trace.append(leaser.lease(1, timeout_s=0))
        leaser.release(a)
        trace.append((leaser.capacity(), leaser.free_count()))
        trace.append((leaser.set_capacity(1), leaser.free_count()))
        leaser.release(b)
        trace.append(leaser.free_count())
        trace.append((leaser.set_capacity(9), leaser.free_count()))
        return trace
    port = run(PPL)
    assert port == run(JPL)
    assert port == [(4, 2, 2), (3, 1), (1, 0), None, (3, 2), (1, 0), 1,
                    (4, 4)]


# --- the canary --------------------------------------------------------------

def test_canary_scales_up_and_retires():
    """Two toy jobs (one flagship) queue on a one-worker fleet before the
    service starts, so they prove as one batch group whatever the
    scheduler's timing: the queue breaches 2 jobs per worker, the
    controller adds a slot, which JOINs; both proofs equal the JAX
    package's bytes; then the idle service retires the slot."""
    d, sup, fm = supervised(1)
    sup.attach_registry(d.membership)
    svc = None
    try:
        svc = ProofService(
            port=0, prover_workers=1, device="cpu",
            backend_factory=lambda: RemoteBackend(d, dist_fft_min=16))
        svc.attach_membership(d.membership)
        specs = [dict(TOY_A, seed=40, slo="flagship"),
                 dict(TOY_A, seed=41)]
        jobs = [svc.submit_local(s) for s in specs]
        asc = svc.attach_autoscaler(
            supervisor=sup, mode="1", tick_s=0.1, min_workers=1,
            max_workers=2, up_queue_per_worker=2, up_ticks=2,
            down_ticks=3, up_cooldown_s=0.2, down_cooldown_s=0.2)
        assert asc is svc.autoscaler and asc.actuating
        wait_for(lambda: sup.active_count() == 2, msg="scale up")
        wait_for(lambda: len(d.tracker.usable_set()) == 2,
                 msg="the new worker's JOIN")
        svc.start()
        for spec, job in zip(specs, jobs):
            assert job.done_event.wait(300) and job.state == "done", \
                job.error
            assert job.slo == spec.get("slo", "standard")
            assert job.proof_bytes == jax_proof(
                {k: v for k, v in spec.items() if k != "slo"})
        # idle: retire back to the floor, drain then LEAVE
        wait_for(lambda: sup.active_count() == 1, msg="scale down")
        wait_for(lambda: counter(fm, "worker_retires") == 1,
                 msg="retire complete")
        sc = svc.metrics.snapshot()["counters"]
        assert sc.get("autoscale_scale_ups") == 1
        assert sc.get("autoscale_scale_downs") == 1
        assert sc.get("placement_batch") == 1
        assert d.membership.is_left(
            d.membership._find("127.0.0.1", sup.slots[1].port))
        assert counter(fm, "worker_respawns") == 0
        assert counter(fm, "worker_flap_capped") == 0
        state = wait_for(lambda: (lambda st: st if st["fleet"]["usable"] == 1
                                  else None)(asc.state()),
                         msg="the fleet sensor after the LEAVE")
        assert state["fleet"]["width"] == 2
        assert [x["action"] for x in state["last_decisions"]
                if x["action"].startswith("scale")] == ["scale_up",
                                                        "scale_down"]
    finally:
        try:
            if svc is not None:
                svc.shutdown()
        finally:
            shutdown(d, sup)
