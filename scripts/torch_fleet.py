#!/usr/bin/env python3
"""Run a self-healing local worker fleet of the PyTorch port: membership
and supervision (the counterpart of scripts/fleet.py).

Starts a Dispatcher that owns a membership registry (served over
JOIN/LEAVE/ROSTER on --member-port), then a WorkerSupervisor that spawns
N port worker subprocesses with `--join`: each announces itself, receives
its fleet index and epoch-numbered roster, and is schedulable from that
moment. Kill a worker (or pass --kill for a scripted SIGKILL) and the
supervisor respawns it with jittered backoff; it re-joins in place,
warm-rejoins from the store-serving peers (its kernel build first, then
the bucket keys), and the fleet heals back to full width.

    python3 scripts/torch_fleet.py --workers 3                 # idle fleet
    python3 scripts/torch_fleet.py --workers 3 --prove \\
        --kill 1 --kill-after 0.2       # SIGKILL slot 1 mid-prove; the
                                        # proof is byte-checked against
                                        # the host oracle
    python3 scripts/torch_fleet.py --workers 3 --store-root /tmp/s \\
        --build-root /tmp/b             # per-worker stores (STORE_FETCH
                                        # peers, warm rejoin) and kernel
                                        # build directories
    python3 scripts/torch_fleet.py --workers 3 --prove \\
        --faults "kill:at=proc:tag=FFT1:worker=1"      # the proc plane

Workers run on --device (default: the card; the script exits non-zero
without one unless --device cpu asks for the kernels' plain versions).
--faults takes runtime/faults.py's rules (';'-separated) for the
dispatcher's wire and proc planes. --prove proves the toy spec (gates 16,
seed 7, rng Random(1)) through RemoteBackend and compares the whole
serialized proof with the port's PythonBackend prove of the same keys.
"""

import argparse
import json
import os
import random
import signal
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROVE_SPEC = {"kind": "toy", "gates": 16, "seed": 7}


def wait_width(dispatcher, n, timeout_s=60):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if len(dispatcher.workers) >= n and \
                len(dispatcher.tracker.usable_set()) >= n:
            return True
        time.sleep(0.1)
    return False


def prove_check(d, device, metrics, workers):
    """The toy prove through the fleet against the host oracle's bytes."""
    from distributed_plonk_tpu_torch.backend.python_backend import \
        PythonBackend
    from distributed_plonk_tpu_torch.proof_io import serialize_proof
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.runtime.dispatcher import RemoteBackend
    from distributed_plonk_tpu_torch.service.jobs import (JobSpec,
                                                          build_bucket_keys,
                                                          build_circuit)
    spec = JobSpec.from_wire(PROVE_SPEC)
    ckt = build_circuit(spec)
    _srs, pk, _vk = build_bucket_keys(spec, device=device)
    want = serialize_proof(prove(random.Random(1), ckt, pk, PythonBackend()))
    t0 = time.perf_counter()
    got = serialize_proof(prove(random.Random(1), ckt, pk,
                                RemoteBackend(d, dist_fft_min=ckt.n)))
    prove_s = time.perf_counter() - t0
    healed = wait_width(d, workers, timeout_s=60)
    return {
        "prove_ok": got == want,
        "prove_s": round(prove_s, 3),
        "healed_to_full_width": healed,
        "epoch": d.epoch,
        "counters": dict(sorted(metrics.snapshot()["counters"].items())),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="the workers' device: cuda (default) or cpu")
    ap.add_argument("--member-host", default="127.0.0.1")
    ap.add_argument("--member-port", type=int, default=0)
    ap.add_argument("--store-root", default=None,
                    help="per-worker store dirs under this root "
                         "(workers serve STORE_FETCH and warm-rejoin)")
    ap.add_argument("--build-root", default=None,
                    help="per-worker kernel build directories under this "
                         "root (default: the checkout's, shared)")
    ap.add_argument("--prove", action="store_true",
                    help="run one distributed toy prove and byte-check "
                         "it against the host oracle")
    ap.add_argument("--kill", type=int, default=None, metavar="SLOT",
                    help="SIGKILL this supervised slot after --kill-after")
    ap.add_argument("--kill-after", type=float, default=0.5)
    ap.add_argument("--watch-s", type=float, default=None,
                    help="idle-serve this long (default: forever without "
                         "--prove)")
    ap.add_argument("--faults", default=None,
                    help="';'-separated fault rules for the dispatcher "
                         "(wire and proc planes)")
    ap.add_argument("--obs-dump", action="store_true",
                    help="before exiting, print one fleet observability "
                         "scrape (METRICS_FETCH per member: served "
                         "counters, log-ring depth, kernel build source)")
    args = ap.parse_args(argv)

    from distributed_plonk_tpu_torch.backend.field_torch import \
        resolve_device
    try:
        device = resolve_device(args.device, "torch_fleet")
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}), flush=True)
        return 1
    from distributed_plonk_tpu_torch.runtime.dispatcher import Dispatcher
    from distributed_plonk_tpu_torch.runtime.faults import (FaultInjector,
                                                            parse_rules)
    from distributed_plonk_tpu_torch.runtime.netconfig import NetworkConfig
    from distributed_plonk_tpu_torch.runtime.supervisor import \
        WorkerSupervisor
    from distributed_plonk_tpu_torch.service.metrics import Metrics

    metrics = Metrics()
    faults = FaultInjector(parse_rules(args.faults), metrics=metrics) \
        if args.faults else None
    d = Dispatcher(NetworkConfig([]), metrics=metrics, faults=faults)
    mserver = d.enable_membership(args.member_host, args.member_port)

    def per_worker(root):
        return None if root is None else [
            os.path.join(root, "worker%d" % i) for i in range(args.workers)]
    sup = WorkerSupervisor(
        args.member_host, mserver.port, n=args.workers,
        device=None if device.type == "cuda" else str(device),
        store_dirs=per_worker(args.store_root),
        build_dirs=per_worker(args.build_root), metrics=metrics,
        cwd=REPO).start()
    # integrity quarantine -> kill the lying (but alive) process so the
    # respawn re-enters through the challenge-gated JOIN
    sup.attach_registry(d.membership)
    if faults is not None:
        faults.proc_kill_cb = sup.proc_killer(d)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        if not wait_width(d, args.workers):
            print(json.dumps({"error": "fleet did not reach width",
                              "roster": d.membership.roster()}),
                  flush=True)
            return 1
        print(json.dumps({"fleet_up": True, "member_port": mserver.port,
                          "roster": d.membership.roster()}), flush=True)
        if args.kill is not None:
            threading.Timer(args.kill_after,
                            lambda: sup.kill(args.kill)).start()
        ok = True
        if args.prove:
            report = prove_check(d, device, metrics, args.workers)
            ok = report["prove_ok"] and report["healed_to_full_width"]
            print(json.dumps(report), flush=True)
        else:
            stop.wait(args.watch_s)
        if args.obs_dump:
            entries = d.fleet_metrics()
            print(json.dumps({"fleet_obs": [
                {"index": e["index"], "addr": e["addr"],
                 "usable": e["usable"], "suspect": e["suspect"],
                 "served": sum(
                     v for k, v in ((e["snapshot"] or {})
                                    .get("counters") or {}).items()
                     if k.startswith("served_")),
                 "log_seq": (e["snapshot"] or {}).get("log_seq", 0),
                 "build": (e["snapshot"] or {}).get("build")}
                for e in entries]}), flush=True)
        return 0 if ok else 1
    finally:
        sup.stop()
        try:
            d.shutdown()
        finally:
            d.pool.shutdown(wait=False)


if __name__ == "__main__":
    sys.exit(main())
