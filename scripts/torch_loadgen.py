#!/usr/bin/env python3
"""Concurrent load generator and fault injector for the PyTorch port's
proof service (the counterpart of scripts/loadgen.py).

    python3 scripts/torch_loadgen.py                   # self-hosted run
    python3 scripts/torch_loadgen.py --host 127.0.0.1 --port 9555
                                                       # external service
    python3 scripts/torch_loadgen.py --jobs 12 --no-kill
    python3 scripts/torch_loadgen.py --kill-rate 0.5 --corrupt-rate 0.3 \\
        --delay-ms 5 --store-dir /tmp/s                # chaos soak
    python3 scripts/torch_loadgen.py --traffic diurnal --autoscale 1 \\
        --slo-mix flagship=0.1,standard=0.6,batch=0.3  # autoscaling soak:
        # a seeded diurnal arrival curve against a supervised fleet; the
        # closed-loop controller must scale up into the peak and retire
        # workers (drain, then LEAVE) after it; every proof byte-checked,
        # no flagship shed
    python3 scripts/torch_loadgen.py \\
        --circuit-mix range=0.3,merkle=0.3,rollup=0.2,toy=0.2
        # circuit-zoo soak: every job's kind drawn from the weights,
        # every proof byte-checked, then the whole batch folded into ONE
        # batch-KZG aggregate verified client-side with a single 2-pair
        # pairing check (--aggregate-only accepts on that alone)
    python3 scripts/torch_loadgen.py --kill-service ROUND2
        # restart soak: spawns `python -m distributed_plonk_tpu_torch.
        # service` (journal and store), submits the job mix with
        # idempotency keys, kills the SERVICE at that journal occurrence
        # mid-prove, restarts it on the same directories, and requires
        # every job's proof bytes to equal an uninterrupted local prove
    python3 scripts/torch_loadgen.py --sdc-rate 0.08 --jobs 3
        # integrity soak: a supervised 3-worker fleet whose workers 1-2
        # silently corrupt results; zero unverified proofs may be served

Default run: starts an in-process ProofService (chaos mode) on --device,
then one submitter thread per job (mixed toy domain sizes 2^5..2^8, or
the --spec list) submits over real TCP, waits, fetches, and verifies its
proof client-side on keys rebuilt from the spec on --device. Unless
--no-kill, one extra larger job is the kill target: as soon as its
STATUS says running, KILL_WORKER is sent for it; the worker dies at the
next round boundary, the pool respawns a replacement, and the job must
finish DONE with retries >= 1 (checkpoint resume, not restart).

--device is where the self-hosted service proves, where the client
rebuilds its verification keys and where reference proves run (default:
the card; the script exits non-zero without one unless --device cpu asks
for the kernels' plain versions). With --host/--port the service is
someone else's: only the client's keys build here.

Prints one JSON summary line; exit code 0 iff every proof verified and
the injected kill (if any) produced a visible retry.
"""

import argparse
import bisect
import json
import math
import os
import random
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# mixed shapes: domains 32 / 128 / 256 (toy gate chains)
_MIX = [{"kind": "toy", "gates": g} for g in (16, 60, 150)]
# burst profile (--mix burst): ONE small shape for every job, submitted
# concurrently: same-shape jobs pop as one batch and prove together (the
# summary reports the jobs per launch achieved)
_BURST_MIX = [{"kind": "toy", "gates": 16}]
_KILL_SPEC = {"kind": "toy", "gates": 300}  # n=512: wide kill window

# the traffic soak's control loop, scaled to a CI-sized soak (the JAX
# loadgen's DPT_AUTOSCALE_TICK_S / DPT_AS_* / DPT_SUP_RETIRE_TIMEOUT_S)
TRAFFIC_AUTOSCALER = {"tick_s": 0.5, "min_workers": 1, "max_workers": 3,
                      "up_queue_per_worker": 2, "up_ticks": 2,
                      "down_ticks": 4, "up_cooldown_s": 3.0,
                      "down_cooldown_s": 5.0}
TRAFFIC_RETIRE_TIMEOUT_S = 10.0
# the fleet soaks' breaker and probe backoff (fast re-admission)
FLEET_TRACKER = {"breaker_k": 2, "probe_base_s": 0.05, "probe_max_s": 0.5}


def _job_mix(args):
    if args.spec:
        return [json.loads(s) for s in args.spec]
    return _BURST_MIX if args.mix == "burst" else _MIX


def _kill_spec(args):
    return json.loads(args.kill_spec) if args.kill_spec else dict(_KILL_SPEC)


def _pct(values, p):
    """The p-quantile of a list (the JAX loadgen's index rule), or None."""
    vals = sorted(values)
    if not vals:
        return None
    return round(vals[min(len(vals) - 1, int(p * len(vals)))], 4)


def _pipeline_summary(m):
    """Round-pipeline section for a soak summary: how full the pipeline
    ran (achieved-depth histogram), where members stalled (per-round
    stage-wait breakdown), and the per-round device-idle estimate.
    `{"enabled": False}` when nothing pipelined."""
    sc = m.get("counters") or {}
    if not sc.get("pipelined_proves"):
        return {"enabled": False}
    hg = m.get("histograms") or {}
    gg = m.get("gauges") or {}
    depth = hg.get("pipeline_depth_achieved") or {}
    return {
        "enabled": True,
        "proves": sc.get("pipelined_proves", 0),
        "jobs": sc.get("pipelined_jobs", 0),
        "depth": {k: depth.get(k) for k in
                  ("count", "mean_s", "p50_s", "p95_s", "max_s")
                  if k in depth},
        "stage_stalls": {
            name.rsplit("/", 1)[-1]: {
                "count": h.get("count", 0), "p50_s": h.get("p50_s"),
                "p95_s": h.get("p95_s"), "max_s": h.get("max_s")}
            for name, h in sorted(hg.items())
            if name.startswith("pipeline_stage_wait_s/")
            and h.get("count")},
        "device_idle_s": {
            name.rsplit("/", 1)[-1]: v
            for name, v in sorted(gg.items())
            if name.startswith("pipeline_device_idle_s/")},
    }


class Keys:
    """The client's keys, rebuilt from each spec's shape on `device` (the
    service's keys are not trusted): verifying keys for verify(), proving
    keys and one TorchBackend for reference proves."""

    def __init__(self, device):
        self.device = device
        self._keys = {}
        self._lock = threading.Lock()
        self._backend = None

    def get(self, spec):
        from distributed_plonk_tpu_torch.service.jobs import (
            build_bucket_keys, shape_key)
        key = shape_key(spec)
        with self._lock:
            if key not in self._keys:
                self._keys[key] = build_bucket_keys(spec, device=self.device)
            return self._keys[key]

    def verify(self, header, blob):
        from distributed_plonk_tpu_torch.proof_io import deserialize_proof
        from distributed_plonk_tpu_torch.service.jobs import JobSpec
        from distributed_plonk_tpu_torch.verifier import verify
        vk = self.get(JobSpec.from_wire(header["spec"]))[2]
        pub = [int(x, 16) for x in header["public_input"]]
        return verify(vk, pub, deserialize_proof(blob),
                      rng=random.Random(1))

    def reference(self, spec_obj):
        """An uninterrupted local prove of the spec (rng Random(seed)),
        serialized: the byte-identity oracle of the soaks."""
        from distributed_plonk_tpu_torch.backend.torch_backend import \
            TorchBackend
        from distributed_plonk_tpu_torch.proof_io import serialize_proof
        from distributed_plonk_tpu_torch.prover import prove
        from distributed_plonk_tpu_torch.service.jobs import (JobSpec,
                                                              build_circuit)
        spec = JobSpec.from_wire(spec_obj)
        pk = self.get(spec)[1]
        with self._lock:
            if self._backend is None:
                self._backend = TorchBackend(self.device)
            be = self._backend
        return serialize_proof(prove(random.Random(spec.seed),
                                     build_circuit(spec), pk, be))


def _parse_slo_mix(arg):
    """'flagship=0.1,standard=0.6,batch=0.3' -> {class: weight}, failing
    fast with a message that names the flag. Weights need not sum to 1
    (they are normalized at draw time); unknown classes are an error."""
    from distributed_plonk_tpu_torch.service.jobs import SLO_CLASSES
    mix = {}
    for entry in arg.split(","):
        name, sep, w = entry.strip().partition("=")
        if not sep or name not in SLO_CLASSES:
            raise SystemExit(f"--slo-mix: {entry.strip()!r} is not "
                             f"<class>=<weight> with class in "
                             f"{SLO_CLASSES}")
        try:
            mix[name] = float(w)
        except ValueError:
            raise SystemExit(f"--slo-mix: {w!r} is not a number")
    if not mix or sum(mix.values()) <= 0:
        raise SystemExit("--slo-mix: needs at least one positive weight")
    return mix


# circuit-zoo shapes per kind (--circuit-mix): the smallest spec of each
# family that still runs its real gadgets: range decomposition n=32, one
# Merkle membership / one Rescue preimage n=256, one rollup account
# update under a height-1 tree n=1024 (the expensive one)
_ZOO_SPECS = {
    "toy": {"kind": "toy", "gates": 16},
    "range": {"kind": "range", "bits": 8, "count": 2},
    "merkle": {"kind": "merkle", "height": 1, "num_proofs": 1},
    "preimage": {"kind": "preimage", "count": 1},
    "rollup": {"kind": "rollup", "height": 1, "updates": 1,
               "num_accounts": 2},
}


def _parse_circuit_mix(arg):
    """'range=0.3,merkle=0.3,rollup=0.2,toy=0.2' -> {kind: weight}, same
    contract as _parse_slo_mix (normalized at draw time, unknown kinds
    fail fast naming the flag)."""
    mix = {}
    for entry in arg.split(","):
        name, sep, w = entry.strip().partition("=")
        if not sep or name not in _ZOO_SPECS:
            raise SystemExit(f"--circuit-mix: {entry.strip()!r} is not "
                             f"<kind>=<weight> with kind in "
                             f"{tuple(sorted(_ZOO_SPECS))}")
        try:
            mix[name] = float(w)
        except ValueError:
            raise SystemExit(f"--circuit-mix: {w!r} is not a number")
    if not mix or sum(mix.values()) <= 0:
        raise SystemExit("--circuit-mix: needs at least one positive "
                         "weight")
    return mix


def _draw(rng, weights):
    """One key of `weights` drawn against their normalized values."""
    names = sorted(weights)
    r = rng.random() * sum(weights[k] for k in names)
    acc = 0.0
    for k in names:
        acc += weights[k]
        if r < acc:
            return k
    return names[-1]


def _traffic_schedule(model, jobs, duration_s, seed, slo_mix):
    """[(arrival_offset_s, slo_class)] for `jobs` arrivals over
    `duration_s` seconds under a deterministic rate curve: inverse-CDF
    sampling of evenly spaced quantiles over a 512-point grid, so the same
    (model, jobs, duration, seed) always gives the same schedule (the soak
    is replayable). Curves (t in [0,1)):

        flat     1.0
        diurnal  0.15 + 0.85*sin(pi*t)^2   one day compressed: quiet
                 shoulders, one mid-window peak
        burst    0.12 off-peak, 1.0 inside [0.40, 0.60]: a step spike

    SLO classes are drawn per arrival from the seeded rng against the
    normalized `slo_mix` weights."""
    rng = random.Random(seed)
    grid = 512

    def rate(t):
        if model == "diurnal":
            return 0.15 + 0.85 * math.sin(math.pi * t) ** 2
        if model == "burst":
            return 1.0 if 0.40 <= t <= 0.60 else 0.12
        return 1.0

    cum = [0.0]
    for g in range(grid):
        cum.append(cum[-1] + rate((g + 0.5) / grid))
    total = cum[-1]
    out = []
    for i in range(jobs):
        target = (i + 0.5) / jobs * total
        g = bisect.bisect_left(cum, target)
        g = min(max(g, 1), grid)
        frac = (g - 1 + (target - cum[g - 1]) / (cum[g] - cum[g - 1])) \
            / grid
        out.append((round(frac * duration_s, 4), _draw(rng, slo_mix)))
    return out


# per-class job shapes for the traffic soak: interactive classes are small
# (flagship n=32), batch the big one (n=256): the mix that moves the
# per-class queue depths the lease-resize rule watches
_SLO_GATES = {"flagship": 16, "standard": 60, "batch": 150}


def _fleet(device, n, metrics, integrity=None):
    """A membership dispatcher with the fleet soaks' fast breaker, and an
    n-slot supervisor of port workers on `device` (not started)."""
    from distributed_plonk_tpu_torch.runtime.dispatcher import Dispatcher
    from distributed_plonk_tpu_torch.runtime.health import LivenessTracker
    from distributed_plonk_tpu_torch.runtime.netconfig import NetworkConfig
    from distributed_plonk_tpu_torch.runtime.supervisor import \
        WorkerSupervisor
    d = Dispatcher(NetworkConfig([]), metrics=metrics)
    if integrity is not None:
        d.integrity = integrity
    d.tracker = LivenessTracker(0, metrics=metrics, **FLEET_TRACKER)
    mserver = d.enable_membership()
    sup = WorkerSupervisor(
        "127.0.0.1", mserver.port, n=n,
        device=None if device.type == "cuda" else str(device),
        metrics=metrics, cwd=REPO,
        retire_timeout_s=TRAFFIC_RETIRE_TIMEOUT_S)
    sup.attach_registry(d.membership)
    return d, sup


def _stop_fleet(d, sup):
    sup.stop()
    try:
        d.shutdown()
    finally:
        d.pool.shutdown(wait=False)


def run_circuit_mix_soak(args, device):
    """--circuit-mix: the circuit-zoo and aggregation soak. Each job's
    kind is drawn from the seeded weights, proved through the service,
    and byte-checked against a local uninterrupted prove. Then ONE
    AGGREGATE call folds every DONE job into a single batch-KZG artifact,
    fetched back and verified client-side: one 2-pair pairing check for
    the whole batch, pinned by the curve's pairing counters.
    --aggregate-only drops the per-proof check. The summary reports
    per-kind submitted/done/verified/p50/p95."""
    from distributed_plonk_tpu_torch import aggregate as AGG
    from distributed_plonk_tpu_torch import curve
    from distributed_plonk_tpu_torch.service import (ProofService,
                                                     ServiceClient)

    t0 = time.time()
    mix = _parse_circuit_mix(args.circuit_mix)
    kinds_sorted = sorted(mix)
    rng = random.Random(args.chaos_seed)
    draws = [_draw(rng, mix) for _ in range(args.jobs)]
    keys = Keys(device)

    svc = ProofService(port=0, prover_workers=args.workers, chaos=True,
                       allow_remote_shutdown=True,
                       store_dir=args.store_dir, device=device).start()
    results = []
    results_lock = threading.Lock()

    def submitter(i, kind):
        spec = dict(_ZOO_SPECS[kind], seed=7000 + i)
        out = {"index": i, "kind": kind, "spec": spec}
        t_sub = time.monotonic()
        try:
            with ServiceClient("127.0.0.1", svc.port) as c:
                out["job_id"] = c.submit(spec)["job_id"]
                st = c.wait(out["job_id"], timeout_s=args.timeout)
                out["state"] = st["state"]
                out["roundtrip_s"] = round(time.monotonic() - t_sub, 4)
                if st["state"] == "done":
                    _hdr, blob = c.result(out["job_id"])
                    if not args.aggregate_only:
                        out["verified"] = blob == keys.reference(spec)
                else:
                    out["error"] = st.get("error")
        except Exception as e:  # noqa: BLE001 - report, don't crash
            out["error"] = repr(e)
        with results_lock:
            results.append(out)

    threads = [threading.Thread(target=submitter, args=(i, k), daemon=True)
               for i, k in enumerate(draws)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=args.timeout)

    # the aggregation leg: every DONE job folds into ONE artifact; the
    # client re-derives the vks on its device and accepts the whole batch
    # on a single pairing check
    agg_report = {}
    metrics = {"counters": {}}
    try:
        done_ids = [r["job_id"] for r in
                    sorted(results, key=lambda r: r["index"])
                    if r.get("state") == "done"]
        with ServiceClient("127.0.0.1", svc.port) as c:
            if done_ids:
                rep = c.aggregate(done_ids)
                agg = c.fetch_aggregate(rep["agg_id"])
                curve.reset_pairing_counters()
                t_v = time.monotonic()
                agg_ok = AGG.verify(agg, device=device)
                agg_report = {
                    "agg_id": rep["agg_id"],
                    "members": len(rep["members"]),
                    "kinds": rep["kinds"],
                    "verified": bool(agg_ok),
                    "verify_s": round(time.monotonic() - t_v, 4),
                    "pairing_checks": dict(curve.PAIRING_COUNTERS),
                }
            metrics = c.metrics()
            c.shutdown_server()
    finally:
        svc.shutdown()

    sc = metrics["counters"]
    per_kind = {}
    for k in kinds_sorted:
        rs = [r for r in results if r["kind"] == k]
        rts = [r["roundtrip_s"] for r in rs if r.get("state") == "done"
               and r.get("roundtrip_s") is not None]
        per_kind[k] = {
            "submitted": len(rs),
            "done": sum(1 for r in rs if r.get("state") == "done"),
            "verified": sum(1 for r in rs if r.get("verified")),
            "served_counter": sc.get("circuit_kind_%s" % k, 0),
            "p50_s": _pct(rts, 0.50),
            "p95_s": _pct(rts, 0.95),
        }
    done = sum(1 for r in results if r.get("state") == "done")
    shed = sum(1 for r in results if r.get("state") == "shed")
    verified = sum(1 for r in results if r.get("verified"))
    # the contract: every job served (zero sheds), the aggregate's one
    # pairing check accepted the whole batch, and (unless aggregate-only)
    # every proof byte-identical to a local prove
    ok = (done == args.jobs and shed == 0
          and agg_report.get("verified") is True
          and (args.aggregate_only or verified == done))
    summary = {
        "mode": "circuit-mix", "ok": ok,
        "wall_s": round(time.time() - t0, 3),
        "jobs": args.jobs, "circuit_mix": mix, "device": str(device),
        "verify": ("aggregate-only" if args.aggregate_only
                   else "per-proof-bytes"),
        "verified": verified, "shed": shed,
        "failed": [r for r in results if r.get("state") != "done"],
        "kinds": per_kind,
        "aggregate": agg_report,
        "aggregates_built": sc.get("aggregates_built", 0),
        "pipeline": _pipeline_summary(metrics),
    }
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


def run_traffic_soak(args, device):
    """--traffic: the closed-loop autoscaling soak. A supervised fleet
    starts at ONE worker behind a fleet-backed proof service with the
    autoscaler attached (--autoscale); a seeded arrival-rate curve with an
    SLO-class mix is replayed against it in real time. In mode "1" the
    controller must scale UP into the ramp (add_slot: a warm membership
    join) and back DOWN after the peak (retire_slot: drain, LEAVE,
    SIGTERM; never a mid-prove kill), and every served proof must equal a
    local uninterrupted prove. The summary carries per-class latency
    percentiles and sheds (`slo`) and the controller's decisions
    (`autoscale`)."""
    from distributed_plonk_tpu_torch.runtime.dispatcher import RemoteBackend
    from distributed_plonk_tpu_torch.service import (ProofService,
                                                     ServiceClient)
    from distributed_plonk_tpu_torch.service.metrics import Metrics

    mode = args.autoscale or "0"
    t0 = time.time()
    slo_mix = _parse_slo_mix(args.slo_mix)
    schedule = _traffic_schedule(args.traffic, args.jobs, args.duration,
                                 args.chaos_seed, slo_mix)
    keys = Keys(device)

    fm = Metrics()  # fleet-side registry: supervisor/membership counters
    d, sup = _fleet(device, 1, fm)
    sup.start()
    svc = None
    results = []
    results_lock = threading.Lock()
    asc_state = None
    svc_metrics = {"counters": {}, "gauges": {}, "histograms": {}}
    try:
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            if d.workers and d.tracker.usable_set():
                break
            time.sleep(0.1)
        # fleet-backed service: one pool worker drives the one dispatcher
        # (queue depth is the up-signal; the fleet widens the FFT shards)
        svc = ProofService(
            port=0, prover_workers=1, chaos=True, max_retries=4,
            allow_remote_shutdown=True, self_verify="1", device=device,
            backend_factory=lambda: RemoteBackend(d, dist_fft_min=64),
        ).start()
        svc.attach_autoscaler(supervisor=sup, mode=mode,
                              **TRAFFIC_AUTOSCALER)

        start = time.monotonic()

        def submitter(i, at_s, cls):
            out = {"index": i, "slo": cls}
            delay = start + at_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            spec = {"kind": "toy", "gates": _SLO_GATES[cls],
                    "seed": 5000 + i, "slo": cls}
            out["spec"] = spec
            t_sub = time.monotonic()
            try:
                with ServiceClient("127.0.0.1", svc.port) as c:
                    out["job_id"] = c.submit(spec)["job_id"]
                    st = c.wait(out["job_id"], timeout_s=args.timeout)
                    out["state"] = st["state"]
                    out["roundtrip_s"] = round(time.monotonic() - t_sub, 4)
                    if st["state"] == "done":
                        _hdr, blob = c.result(out["job_id"])
                        out["verified"] = blob == keys.reference(spec)
                    elif st["state"] != "shed":
                        out["error"] = st.get("error")
            except Exception as e:  # noqa: BLE001 - report, don't crash
                out["error"] = repr(e)
            with results_lock:
                results.append(out)

        threads = [threading.Thread(target=submitter, args=(i, at, cls),
                                    daemon=True)
                   for i, (at, cls) in enumerate(schedule)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=args.timeout + args.duration)
        # post-peak idle window: hold the idle service open long enough
        # for the down streak and cooldown to elapse, so the soak shows
        # both transitions
        if mode == "1":
            idle_deadline = time.monotonic() + 30
            while time.monotonic() < idle_deadline:
                sc = svc.metrics.snapshot()["counters"]
                if sc.get("autoscale_scale_downs", 0) >= 1:
                    break
                time.sleep(0.25)
        if svc.autoscaler is not None:
            asc_state = svc.autoscaler.state()
        with ServiceClient("127.0.0.1", svc.port) as c:
            svc_metrics = c.metrics()
            c.shutdown_server()
    finally:
        _stop_fleet(d, sup)
        if svc is not None:
            svc.shutdown()

    sc = svc_metrics["counters"]
    fc = fm.snapshot()["counters"]
    per_class = {}
    for cls in ("flagship", "standard", "batch"):
        rs = [r for r in results if r["slo"] == cls]
        rts = [r["roundtrip_s"] for r in rs if r.get("state") == "done"
               and r.get("roundtrip_s") is not None]
        per_class[cls] = {
            "submitted": len(rs),
            "done": sum(1 for r in rs if r.get("state") == "done"),
            "shed": sc.get(f"slo_sheds_{cls}", 0),
            "verified": sum(1 for r in rs if r.get("verified")),
            "p50_s": _pct(rts, 0.50),
            "p95_s": _pct(rts, 0.95),
        }
    done = sum(1 for r in results if r.get("state") == "done")
    verified = sum(1 for r in results if r.get("verified"))
    shed = sum(1 for r in results if r.get("state") == "shed")
    # the contract: every proof served verified byte-identical, every job
    # accounted for (done or shed), and shedding never touched flagship
    ok = (verified == done and done + shed == args.jobs
          and per_class["flagship"]["shed"] == 0)
    scale_ups = sc.get("autoscale_scale_ups", 0)
    scale_downs = sc.get("autoscale_scale_downs", 0)
    if mode == "1":
        # actuating acceptance: the controller visibly rode the curve
        ok = ok and scale_ups >= 1 and scale_downs >= 1
    summary = {
        "mode": "traffic", "ok": ok,
        "traffic": args.traffic, "autoscale_mode": mode,
        "device": str(device),
        "wall_s": round(time.time() - t0, 3),
        "jobs": args.jobs, "duration_s": args.duration,
        "slo_mix": slo_mix,
        "verified": verified,
        "unverified_served": done - verified,
        "failed": [r for r in results
                   if not r.get("verified") and r.get("state") != "shed"],
        "slo": per_class,
        "autoscale": {
            "mode": mode,
            "ticks": sc.get("autoscale_ticks", 0),
            "decisions": sc.get("autoscale_decisions", 0),
            "scale_ups": scale_ups,
            "scale_downs": scale_downs,
            "lease_resizes": sc.get("autoscale_lease_resizes", 0),
            "sheds": sc.get("autoscale_sheds", 0),
            "actuator_errors": sc.get("autoscale_actuator_errors", 0),
            "worker_retires": fc.get("worker_retires", 0),
            # zero mid-prove kills: a retire is not a flap/respawn
            "worker_respawns": fc.get("worker_respawns", 0),
            "worker_flap_capped": fc.get("worker_flap_capped", 0),
            "final_state": asc_state,
        },
        "pipeline": _pipeline_summary(svc_metrics),
    }
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


def run_kill_service_soak(args, device):
    """--kill-service: the durable-service soak. The frontend is a real
    `python -m distributed_plonk_tpu_torch.service` process that exits at
    an exact journal occurrence (its --faults journal plane), restarted
    on the same journal and store directories; every job, queued,
    mid-prove or finished at kill time, must complete with the bytes of
    an uninterrupted local prove."""
    from distributed_plonk_tpu_torch.service import ServiceClient

    jdir = args.journal_dir or tempfile.mkdtemp(prefix="dpt-lg-journal-")
    sdir = args.store_dir or tempfile.mkdtemp(prefix="dpt-lg-store-")
    port = args.port
    keys = Keys(device)

    def spawn(faults=None):
        cmd = [sys.executable, "-m", "distributed_plonk_tpu_torch.service",
               "--port", str(port), "--workers", str(args.workers),
               "--journal-dir", jdir, "--store-dir", sdir, "--chaos",
               "--allow-remote-shutdown", "--device", str(device)]
        if faults:
            cmd += ["--faults", faults]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                             cwd=REPO)
        p.stdout.readline()  # the {"listening": ...} banner
        return p

    t0 = time.time()
    summary = {"mode": "kill-service", "kill_at": args.kill_service,
               "jobs": args.jobs, "journal_dir": jdir, "store_dir": sdir,
               "device": str(device)}
    # arm the service kill at the Nth matching journal occurrence; the job
    # mix below guarantees ROUND records exist before it fires
    proc = spawn(faults=f"kill:at=journal:tag={args.kill_service}")
    proc2 = None
    mix = _job_mix(args)
    specs = []
    for i in range(args.jobs):
        spec = dict(mix[i % len(mix)])
        spec.update(seed=1000 + i, priority=i % 3,
                    job_key=f"soak-{args.chaos_seed}-{i}")
        specs.append(spec)
    recovered = verified = 0
    failures = []
    metrics = {"counters": {}}
    try:
        try:
            with ServiceClient("127.0.0.1", port) as c:
                for spec in specs:
                    c.submit(spec)
        except Exception as e:  # noqa: BLE001 - the kill may land here
            # the kill can land while we are still submitting: whatever
            # was journaled must still recover below
            summary["submit_interrupted"] = repr(e)
        rc = proc.wait(timeout=args.timeout)
        summary["service_killed_rc"] = rc

        proc2 = spawn()
        with ServiceClient("127.0.0.1", port) as c:
            for i, spec in enumerate(specs):
                # duplicate submit: dedups onto the recovered job (and
                # re-registers any job whose SUBMIT the kill swallowed)
                r = c.submit(spec)
                if r.get("dedup"):
                    recovered += 1
                st = c.wait(r["job_id"], timeout_s=args.timeout)
                if st["state"] != "done":
                    failures.append({"index": i, "state": st["state"],
                                     "error": st.get("error")})
                    continue
                _hdr, blob = c.result(r["job_id"])
                if blob == keys.reference(spec):
                    verified += 1
                else:
                    failures.append({"index": i,
                                     "error": "proof bytes diverged"})
            metrics = c.metrics()
            c.shutdown_server()
        proc2.wait(timeout=30)
    finally:
        for p in (proc, proc2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    ctr = metrics["counters"]
    ok = summary["service_killed_rc"] != 0 and verified == args.jobs \
        and not failures
    summary.update({
        "ok": ok,
        "wall_s": round(time.time() - t0, 3),
        "verified_byte_identical": verified,
        "dedup_recovered": recovered,
        "failed": failures,
        "recovery": {k: ctr.get(k, 0) for k in
                     ("journal_replays", "jobs_recovered",
                      "jobs_recovered_finished", "checkpoint_resumes",
                      "dedup_hits", "jobs_shed")},
    })
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


def run_sdc_soak(args, device):
    """--sdc-rate: the result-integrity soak. A supervised 3-worker fleet
    serves the job mix through a fleet-backed proof service, with the data
    plane of workers 1 and 2 armed to corrupt computed results in every
    incarnation (`--faults corrupt:at=data:rate=R`: MSM partials, FFT
    panels, NTT replies, round-4 eval chunks). The integrity plane must
    catch each corruption at its phase boundary and quarantine the liar
    (respawn and challenge-gated rejoin), self-verify must block anything
    that slips through, and every served proof must verify client-side:
    zero unverified proofs served is the exit-code contract. Worker 0
    stays clean: a fleet where every referee lies has no ground truth."""
    from distributed_plonk_tpu_torch.obs import fleet as OF
    from distributed_plonk_tpu_torch.runtime.dispatcher import RemoteBackend
    from distributed_plonk_tpu_torch.runtime.integrity import FleetIntegrity
    from distributed_plonk_tpu_torch.service import (ProofService,
                                                     ServiceClient)
    from distributed_plonk_tpu_torch.service.metrics import Metrics

    t0 = time.time()
    fm = Metrics()  # fleet-side registry: integrity/quarantine counters
    integrity = FleetIntegrity(metrics=fm)
    integrity.msm_dup_rate = 1.0
    integrity._rng = random.Random(args.chaos_seed)
    fleet_n = 3
    d, sup = _fleet(device, fleet_n, fm, integrity=integrity)

    def spawn_cmd(i, slot):
        cmd = sup.worker_cmd(i, slot)
        if i > 0:
            cmd += ["--faults", f"corrupt:at=data:rate={args.sdc_rate}"]
        return cmd
    sup.spawn_cmd = spawn_cmd
    sup.start()
    keys = Keys(device)
    svc = None
    results = []
    obs_report = {}
    svc_metrics = {"counters": {}}
    sdc_injected = 0
    try:
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            if len(d.workers) == fleet_n \
                    and len(d.tracker.usable_set()) == fleet_n:
                break
            time.sleep(0.1)
        # fleet-backed service: one pool worker drives the one dispatcher
        # (verify-before-serve on: the backstop under the phase checks)
        svc = ProofService(
            port=0, prover_workers=1, chaos=True, max_retries=4,
            allow_remote_shutdown=True, self_verify="1", device=device,
            backend_factory=lambda: RemoteBackend(d, dist_fft_min=64),
        ).start()
        mix = _job_mix(args)
        with ServiceClient("127.0.0.1", svc.port) as c:
            for i in range(args.jobs):
                spec = dict(mix[i % len(mix)])
                spec.update(seed=4000 + i)
                out = {"index": i, "spec": spec}
                try:
                    out["job_id"] = c.submit(spec)["job_id"]
                    st = c.wait(out["job_id"], timeout_s=args.timeout)
                    out["state"] = st["state"]
                    out["retries"] = st["retries"]
                    if st["state"] == "done":
                        header, blob = c.result(out["job_id"])
                        out["verified"] = keys.verify(header, blob)
                    else:
                        out["error"] = st.get("error")
                except Exception as e:  # noqa: BLE001
                    out["error"] = repr(e)
                results.append(out)
            svc_metrics = c.metrics()
            c.shutdown_server()
        # each current incarnation's own injected count (incarnations
        # already replaced undercount)
        sdc_injected = sum((h or {}).get("sdc_injected", 0)
                           for h in d.health())
        # the fleet observability round trip: METRICS_FETCH rendered to
        # labelled series, LOG_FETCH event counts and one PROFILE capture
        try:
            entries = d.fleet_metrics()
            obs_report["fleet_scraped"] = sum(
                1 for e in entries if e.get("snapshot"))
            obs_report["fleet_series"] = sum(
                1 for line in OF.render_prom(entries).splitlines()
                if line and not line.startswith("#"))
            obs_report["log_events_fetched"] = sum(
                len(lg["events"]) for lg in d.fetch_logs())
            # profile a schedulable worker (a liar may be mid-quarantine)
            usable = d.tracker.usable_set()
            meta, blob = d.profile_worker(usable[0] if usable else 0,
                                          duration_ms=100)
            obs_report["profile_ok"] = bool(blob)
            obs_report["profile_format"] = meta.get("format")
        except Exception as e:  # noqa: BLE001 - report, never fail a soak
            obs_report["error"] = repr(e)
    finally:
        _stop_fleet(d, sup)
        if svc is not None:
            svc.shutdown()
    fc = fm.snapshot()["counters"]
    sc = svc_metrics["counters"]
    verified = sum(1 for r in results if r.get("verified"))
    done = sum(1 for r in results if r.get("state") == "done")
    # the contract: everything served verified, and nothing was served
    # without the self-verify gate having passed it
    ok = (verified == args.jobs and done == args.jobs)
    summary = {
        "mode": "sdc", "ok": ok, "device": str(device),
        "wall_s": round(time.time() - t0, 3),
        "jobs": args.jobs, "sdc_rate": args.sdc_rate,
        "verified": verified,
        "unverified_served": done - verified,
        "failed": [r for r in results if not r.get("verified")],
        "detections": {
            "integrity_checks": fc.get("integrity_checks", 0),
            "integrity_failures": fc.get("integrity_failures", 0),
            "msm_dups": fc.get("integrity_msm_dups", 0),
            "eval_dups": fc.get("integrity_eval_dups", 0),
            "self_verify_checks": sc.get("self_verify_checks", 0),
            "self_verify_failures": sc.get("self_verify_failures", 0),
            "proofs_blocked": sc.get("proofs_blocked", 0),
            "sdc_injected_live": sdc_injected,
        },
        "quarantines": {
            "workers_quarantined": fc.get("workers_quarantined", 0),
            "membership_leaves": fc.get("membership_leaves", 0),
            "worker_respawns": fc.get("worker_respawns", 0),
            "challenges": fc.get("integrity_challenges", 0),
            "challenges_failed": fc.get("integrity_challenges_failed", 0),
            "flap_capped": fc.get("worker_flap_capped", 0),
        },
        "reproves": {
            "job_retries": sc.get("job_retries", 0),
            "fft_replans": fc.get("fleet_fft_replans", 0),
            "range_adoptions": fc.get("fleet_range_adoptions", 0),
        },
        "obs": obs_report,
    }
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


def run_default(args, device):
    """The default run: self-hosted (or --host/--port) submitters, every
    proof verified client-side, and the KILL_WORKER target."""
    from distributed_plonk_tpu_torch.runtime.faults import (FaultInjector,
                                                            Rule)
    from distributed_plonk_tpu_torch.service import (ProofService,
                                                     ServiceClient)
    from distributed_plonk_tpu_torch.trace import Tracer

    chaos_rng = random.Random(args.chaos_seed)
    svc = None
    host = args.host
    port = args.port
    if host is None:
        # round-boundary chaos rides runtime/faults.py; wire-level kills
        # keep using KILL_WORKER
        rules = []
        if args.corrupt_rate > 0:
            rules.append(Rule("corrupt_ckpt", rate=args.corrupt_rate))
        if args.delay_ms > 0:
            rules.append(Rule("delay", rate=1.0, ms=args.delay_ms,
                              plane="round"))
        faults = FaultInjector(rules, rng=chaos_rng) if rules else None
        svc = ProofService(port=0, prover_workers=args.workers, chaos=True,
                           allow_remote_shutdown=True,
                           store_dir=args.store_dir, faults=faults,
                           device=device).start()
        host, port = "127.0.0.1", svc.port
    elif args.corrupt_rate or args.delay_ms:
        print(json.dumps({"ok": False,
                          "error": "--corrupt-rate/--delay-ms need the "
                                   "self-hosted server (they inject at "
                                   "the pool's round boundaries)"}))
        return 2

    keys = Keys(device)
    results = []
    results_lock = threading.Lock()
    # chaos kill decisions drawn up front (one shared seeded rng would race
    # across submitter threads): deterministic per --chaos-seed
    kill_marks = [chaos_rng.random() < args.kill_rate
                  for _ in range(args.jobs)]

    def chaos_kill(c, job_id, out):
        """Poll until the job runs, then KILL_WORKER it: the prove must
        still finish (checkpoint resume) and verify."""
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            st = c.status(job_id)
            if st["state"] in ("done", "failed"):
                return
            if st["state"] == "running":
                try:
                    c.kill_worker(job_id=job_id)
                    out["chaos_killed"] = True
                except Exception:  # noqa: BLE001 - prove outran the kill
                    pass
                return
            time.sleep(0.01)

    mix = _job_mix(args)

    def submitter(i):
        spec = dict(mix[i % len(mix)])
        spec.update(seed=1000 + i, priority=i % 3)
        out = {"index": i, "spec": spec}
        # each job is one end-to-end trace: the client's span is the root,
        # the server adopts the id (SUBMIT trace_ctx), and STATUS reports
        # how many spans the merged timeline collected
        tracer = Tracer(proc=f"loadgen/{i}")
        t_sub = time.monotonic()
        try:
            with ServiceClient(host, port) as c:
                with tracer.span("loadgen/submit_wait_verify") as root:
                    r = c.submit(spec,
                                 trace_ctx={"trace_id": tracer.trace_id,
                                            "parent_id": root})
                    out["job_id"] = r["job_id"]
                    out["trace_adopted"] = \
                        r.get("trace_id") == tracer.trace_id
                    if kill_marks[i]:
                        chaos_kill(c, out["job_id"], out)
                    st = c.wait(out["job_id"], timeout_s=args.timeout)
                out["roundtrip_s"] = round(time.monotonic() - t_sub, 4)
                out["state"] = st["state"]
                out["retries"] = st["retries"]
                out["wait_s"] = st["wait_s"]
                out["run_s"] = st["run_s"]
                out["trace_spans"] = st.get("trace_spans")
                if st["state"] == "done":
                    header, blob = c.result(out["job_id"])
                    out["verified"] = keys.verify(header, blob)
                else:
                    out["error"] = st["error"]
        except Exception as e:  # noqa: BLE001 - report, don't crash the run
            out["error"] = repr(e)
        with results_lock:
            results.append(out)

    def run_kill_job(attempt):
        """Submit the kill target, kill its worker once running, wait."""
        spec = _kill_spec(args)
        spec.update(seed=31337 + attempt, priority=9)  # run soon and alone
        with ServiceClient(host, port) as c:
            t_sub = time.monotonic()
            job_id = c.submit(spec)["job_id"]
            deadline = time.monotonic() + args.timeout
            victim = None
            while time.monotonic() < deadline:
                st = c.status(job_id)
                if st["state"] in ("done", "failed"):
                    break
                if st["state"] == "running" and victim is None:
                    try:
                        victim = c.kill_worker(job_id=job_id)
                    except Exception:  # noqa: BLE001
                        # the prove outran us (finished between the STATUS
                        # poll and the kill frame); the caller sees
                        # retries == 0 and tries a fresh target
                        break
                time.sleep(0.02)
            st = c.wait(job_id, timeout_s=args.timeout)
            out = {"job_id": job_id, "spec": spec, "victim": victim,
                   "state": st["state"], "retries": st["retries"],
                   "attempts": st["attempts"], "wait_s": st["wait_s"],
                   "run_s": st["run_s"],
                   "roundtrip_s": round(time.monotonic() - t_sub, 4)}
            if st["state"] == "done":
                header, blob = c.result(job_id)
                out["verified"] = keys.verify(header, blob)
            return out

    t0 = time.time()
    threads = [threading.Thread(target=submitter, args=(i,), daemon=True)
               for i in range(args.jobs)]
    for t in threads:
        t.start()

    kill_report = None
    kill_reports = []
    if not args.no_kill:
        for attempt in range(args.kill_attempts):
            kill_report = run_kill_job(attempt)
            kill_reports.append(kill_report)
            if kill_report.get("retries", 0) >= 1 or \
                    kill_report["state"] != "done":
                break  # the kill landed (or something real broke)
            # the prove outran the kill; try again with a fresh target
    for t in threads:
        t.join(timeout=args.timeout)

    with ServiceClient(host, port) as c:
        metrics = c.metrics()
        if svc is not None:
            c.shutdown_server()
    if svc is not None:
        # the frame stops the service on its connection thread: wait for
        # the pool's threads before this process exits
        svc._stopped.wait(60)

    verified = sum(1 for r in results if r.get("verified"))
    ok = verified == args.jobs
    if kill_report is not None:
        ok = ok and kill_report["state"] == "done" \
            and kill_report.get("verified") \
            and kill_report["retries"] >= 1
    # per-kind seconds of every finished job (the kill target included):
    # the client's submit-to-done round trip and the service's run time
    per_kind = {}
    for r in results + ([kill_report] if kill_report else []):
        if r.get("state") != "done":
            continue
        kind = r["spec"]["kind"]
        if kind == "toy":
            kind = "toy%d" % r["spec"]["gates"]
        per_kind.setdefault(kind, {"roundtrip": [], "run": []})
        per_kind[kind]["roundtrip"].append(r["roundtrip_s"])
        per_kind[kind]["run"].append(r["run_s"])
    kinds = {k: {"done": len(v["run"]),
                 "p50_s": _pct(v["roundtrip"], 0.50),
                 "p95_s": _pct(v["roundtrip"], 0.95),
                 "run_p50_s": _pct(v["run"], 0.50),
                 "run_p95_s": _pct(v["run"], 0.95)}
             for k, v in sorted(per_kind.items())}
    ctr = metrics["counters"]
    recoveries = {
        "job_retries": ctr.get("job_retries", 0),
        "checkpoint_saves": ctr.get("checkpoint_saves", 0),
        "checkpoint_resumes": ctr.get("checkpoint_resumes", 0),
        "ckpt_corruptions_detected": ctr.get("faults_ckpt_corrupted", 0),
        "faults_injected": {k[len("faults_injected_"):]: v
                            for k, v in ctr.items()
                            if k.startswith("faults_injected_")},
    }
    batch_proves = ctr.get("batch_proves", 0)
    batch_jobs = ctr.get("batch_jobs", 0)
    summary = {
        "ok": ok,
        "wall_s": round(time.time() - t0, 3),
        "jobs": args.jobs,
        "mix": "spec" if args.spec else args.mix,
        "device": str(device),
        "verified": verified,
        "failed": [r for r in results if not r.get("verified")],
        "kill": kill_report,
        "kinds": kinds,
        # every job this run finished, the kill targets' included
        "done_job_ids": sorted(r["job_id"] for r in results + kill_reports
                               if r.get("state") == "done"),
        # placement and cross-job batching achieved by this run's traffic
        # (jobs_per_launch 1.0: nothing ever batched)
        "batch": {
            "proves": batch_proves,
            "jobs": batch_jobs,
            "jobs_per_launch": (round(batch_jobs / batch_proves, 2)
                                if batch_proves else None),
            "member_kills": ctr.get("batch_member_kills", 0),
            "placement": {k: v for k, v in sorted(ctr.items())
                          if k.startswith("placement_")},
        },
        "pipeline": _pipeline_summary(metrics),
        # what was injected and what the service survived (every proof
        # above still had to verify for ok=true)
        "chaos": {
            "kill_rate": args.kill_rate,
            "corrupt_rate": args.corrupt_rate,
            "delay_ms": args.delay_ms,
            "kills_marked": sum(kill_marks),
            "kills_landed": sum(1 for r in results
                                if r.get("chaos_killed")),
            "recoveries": recoveries,
        },
        # every job's timeline must have collected spans under the
        # client-supplied trace id
        "trace": {
            "adopted": sum(1 for r in results if r.get("trace_adopted")),
            "spans_total": sum(r.get("trace_spans") or 0 for r in results),
            "spans_recorded": ctr.get("trace_spans_recorded", 0),
        },
        "obs": {"log_events_recorded": ctr.get("log_events", 0)},
        # key_builds == bucket_misses: 0 on a warm-store rerun of the same
        # shape mix (see --store-dir)
        "key_builds": ctr.get("bucket_misses", 0),
        "key_disk_hits": ctr.get("bucket_disk_hits", 0),
        # where the service's kernel libraries came from (None on the CPU)
        "build": metrics.get("build"),
        "metrics": {
            "counters": ctr,
            "gauges": metrics["gauges"],
            "queue_wait": metrics["histograms"].get("job_wait"),
            "rounds": {k: v for k, v in metrics["histograms"].items()
                       if k.startswith("prove_round/")},
            "throughput_jobs_per_s": metrics["throughput_jobs_per_s"],
        },
    }
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--host", default=None,
                    help="external server (default: self-hosted in-process)")
    ap.add_argument("--port", type=int, default=9555)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: where the self-hosted "
                         "service proves and the client's keys build")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--mix", choices=("mixed", "burst"), default="mixed",
                    help="job-shape profile: 'mixed' rotates 3 toy domains "
                         "(2^5..2^8); 'burst' submits ONE small shape for "
                         "every job (cross-job batched proving; see the "
                         "summary's batch.jobs_per_launch)")
    ap.add_argument("--spec", action="append", default=[],
                    help="job spec JSON (repeatable): the jobs rotate over "
                         "these instead of --mix")
    ap.add_argument("--kill-spec", default=None,
                    help="job spec JSON of the kill target (default: toy "
                         "gates 300, n = 512)")
    ap.add_argument("--workers", type=int, default=2,
                    help="pool size for the self-hosted server")
    ap.add_argument("--store-dir", default=None,
                    help="artifact store for the self-hosted server: run "
                         "twice with the same dir and the second run's "
                         "key_builds is 0 (warm start)")
    ap.add_argument("--no-kill", action="store_true")
    ap.add_argument("--kill-attempts", type=int, default=3,
                    help="re-tries if the kill races a finishing prove")
    ap.add_argument("--kill-rate", type=float, default=0.0,
                    help="chaos: probability per regular job of killing "
                         "its worker mid-prove (KILL_WORKER); every proof "
                         "must still verify")
    ap.add_argument("--corrupt-rate", type=float, default=0.0,
                    help="chaos (self-hosted only): probability per round "
                         "boundary of flipping a byte in the just-saved "
                         "checkpoint artifact; the store's SHA-256 must "
                         "catch it and the retry restart cleanly")
    ap.add_argument("--delay-ms", type=float, default=0.0,
                    help="chaos (self-hosted only): slow-prover delay "
                         "injected at every round boundary")
    ap.add_argument("--chaos-seed", type=int, default=0xC4A05,
                    help="seed for rate-based chaos decisions")
    ap.add_argument("--kill-service", default=None, metavar="LABEL",
                    help="restart soak: run the port's service as a "
                         "subprocess, kill it at this journal occurrence "
                         "(SUBMIT, START, ROUND, ROUND2, DONE, ...), "
                         "restart it on the same journal/store, and "
                         "require every job byte-identical")
    ap.add_argument("--journal-dir", default=None,
                    help="journal dir for --kill-service (default: tmp)")
    ap.add_argument("--sdc-rate", type=float, default=None, metavar="R",
                    help="result-integrity soak: run the job mix through a "
                         "supervised 3-worker fleet whose workers 1-2 "
                         "corrupt computed results (corrupt:at=data) at "
                         "this rate; exit 0 iff zero unverified proofs "
                         "served")
    ap.add_argument("--traffic", default=None,
                    choices=("flat", "diurnal", "burst"),
                    help="autoscaling soak: replay a seeded deterministic "
                         "arrival-rate curve against a supervised fleet "
                         "with the autoscaler of --autoscale attached")
    ap.add_argument("--circuit-mix", default=None, metavar="KIND=W,...",
                    help="circuit-zoo and aggregation soak: draw each "
                         "job's kind from these weights (kinds: toy, "
                         "range, merkle, preimage, rollup), byte-check "
                         "every proof, then AGGREGATE the batch and verify "
                         "the ONE batched opening client-side")
    ap.add_argument("--aggregate-only", action="store_true",
                    help="--circuit-mix: accept the batch on the "
                         "aggregate's single pairing check alone")
    ap.add_argument("--slo-mix", default="standard=1.0",
                    metavar="CLS=W,...",
                    help="SLO-class weights for --traffic arrivals, e.g. "
                         "flagship=0.1,standard=0.6,batch=0.3 (normalized; "
                         "drawn per arrival from --chaos-seed)")
    ap.add_argument("--duration", type=float, default=20.0,
                    help="--traffic: seconds the arrival curve spans")
    ap.add_argument("--autoscale", default=None, choices=("0", "dry", "1"),
                    help="--traffic: the autoscaler's mode (default 0: "
                         "none attached)")
    ap.add_argument("--timeout", type=float, default=600)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from distributed_plonk_tpu_torch.backend.field_torch import \
        resolve_device
    try:
        device = resolve_device(args.device, "torch_loadgen")
    except RuntimeError as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    if args.circuit_mix is not None:
        return run_circuit_mix_soak(args, device)
    if args.traffic is not None:
        return run_traffic_soak(args, device)
    if args.kill_service is not None:
        return run_kill_service_soak(args, device)
    if args.sdc_rate is not None:
        return run_sdc_soak(args, device)
    return run_default(args, device)


if __name__ == "__main__":
    sys.exit(main())
