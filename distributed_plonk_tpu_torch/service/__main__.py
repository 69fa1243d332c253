"""Run the port's proof service daemon on the card.

    python -m distributed_plonk_tpu_torch.service --port 9555 --workers 2 \
        --store-dir /var/dpt/store [--journal-dir /var/dpt/journal] \
        [--device cuda|cuda:1|cpu] [--devices cuda:0,cuda:0,...] \
        [--queue-depth 64] [--max-batch 8] [--retries 2] [--timeout 300] \
        [--obs-port 0] [--chaos [--faults SPEC]] [--verify] \
        [--build-dir DIR] [--autoscale 0|dry|1 [--slo-standard-s S]]

The counterpart of the JAX package's scripts/serve.py, with its flags
and the same wire protocol: clients drive it with either package's
ServiceClient. --device is where keys build and pool
workers prove (default: the card; without one the daemon exits with an
error unless --device cpu asks for the kernels' plain versions);
--devices lists the slots mesh-class jobs lease (default: every card).
On the card the kernels come from --build-dir (default: the checkout's
build directory), else the store's `kbuild:` artifact, else the
--store-peers, else nvcc; a service with a store publishes its build
there (store/kernels.py), and METRICS says which under `build` (and
this process's kernel launch counters under `launches`).

--autoscale arms the closed-loop autoscaler (service/autoscale.py) once
the service listens: 0 (the default) attaches nothing and /autoscale
answers 404; dry runs the control loop every autoscale.TICK_S (2)
seconds and records each decision without an actuator call; 1 actuates
(lease resizes and pressure sheds: the daemon has no WorkerSupervisor,
so worker scaling records as not applied). --slo-standard-s sets the standard
class's p95 target, a breach signal for scaling up. The start line
carries the mode under "autoscale".

--journal-dir enables the crash-safe job journal: every submitted job
survives a crash or restart (in-flight ones resume from their
checkpoints, finished ones serve from proof artifacts). SIGTERM/SIGINT
triggers a graceful drain: admission stops, in-flight jobs get up to
DRAIN_TIMEOUT_S to finish, stragglers checkpoint and park, the journal
flushes, and the process exits 0.

--chaos enables the KILL_WORKER fault-injection tag and arms the --faults
rules (runtime/faults.py's text form, ';'-separated), including
journal-plane service kills: "kill:at=journal:tag=ROUND2" makes THIS
PROCESS exit at exactly that journal occurrence. Never enable it on a
service you care about. --verify makes workers verify each proof before
marking it done. Prints one JSON line with the bound address once
listening; a SHUTDOWN frame (with --allow-remote-shutdown) stops it.
"""

import argparse
import json
import os
import signal

from . import autoscale as AS

# seconds in-flight jobs get to finish on SIGTERM (the JAX package's
# DPT_DRAIN_TIMEOUT_S default)
DRAIN_TIMEOUT_S = 30.0


def parse_peers(arg):
    """'host:port,host:port' -> [(host, port)], failing fast with a
    message that names the flag."""
    peers = []
    for entry in arg.split(","):
        host, sep, port = entry.strip().rpartition(":")
        if not sep or not host or not port.isdigit():
            raise SystemExit(
                f"--store-peers: {entry.strip()!r} is not host:port")
        peers.append((host, int(port)))
    return peers


def validate_journal_dir(arg):
    """Fail fast, at flag-parse time: a journal dir that cannot take
    fsync'd appends must stop the daemon BEFORE it accepts jobs it cannot
    make durable."""
    path = os.path.abspath(os.path.expanduser(arg))
    if os.path.exists(path) and not os.path.isdir(path):
        raise SystemExit(f"--journal-dir: {path!r} exists and is not a "
                         "directory")
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, ".probe.%d" % os.getpid())
        with open(probe, "wb") as f:
            f.write(b"x")
            os.fsync(f.fileno())
        os.remove(probe)
    except OSError as e:
        raise SystemExit(f"--journal-dir: {path!r} is not writable "
                         f"({e.strerror or e})")
    return path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m distributed_plonk_tpu_torch.service",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9555)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--queue-depth", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-job wall-clock budget, seconds")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--journal-dir", default=None,
                    help="crash-safe job journal (restart recovery; the "
                         "SIGTERM graceful-drain surface)")
    ap.add_argument("--store-dir", default=None,
                    help="artifact store root: bucket keys, checkpoints, "
                         "finished proofs and traces persist here")
    ap.add_argument("--store-budget", type=int, default=None,
                    help="store byte budget (LRU eviction past it)")
    ap.add_argument("--bucket-cap", type=int, default=64,
                    help="max shape buckets resident in memory (LRU)")
    ap.add_argument("--store-peers", default=None,
                    help="comma-separated host:port peers speaking "
                         "STORE_FETCH, tried on a bucket miss before a "
                         "full key build")
    ap.add_argument("--log-dir", default=None,
                    help="structured-log JSONL sink (obs/log.py)")
    ap.add_argument("--obs-port", type=int, default=None,
                    help="observability HTTP port (0 = ephemeral): "
                         "/metrics, /healthz, /logs, /trace/<job_id>")
    ap.add_argument("--device", default=None,
                    help="device of the keys and the pool's workers "
                         "(default: the card; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated slots mesh-class jobs lease, "
                         "e.g. cuda:0,cuda:0,cuda:0,cuda:0 (default: "
                         "every card)")
    ap.add_argument("--build-dir", default=None,
                    help="the kernels' build directory (default: the "
                         "checkout's build/dpt_torch_kernels)")
    ap.add_argument("--chaos", action="store_true")
    ap.add_argument("--faults", default=None,
                    help="';'-separated fault rules for --chaos, e.g. "
                         "'kill:at=journal:tag=ROUND2'")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--allow-remote-shutdown", action="store_true",
                    help="let any client's SHUTDOWN frame stop the daemon")
    ap.add_argument("--autoscale", choices=AS.MODES, default="0",
                    help="closed-loop autoscaler: 0 off, dry records "
                         "decisions without acting, 1 actuates")
    ap.add_argument("--slo-standard-s", type=float, default=None,
                    help="the standard class's p95 target, seconds (a "
                         "breach signal for the autoscaler)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    journal_dir = None
    if args.journal_dir is not None:
        journal_dir = validate_journal_dir(args.journal_dir)

    from ..backend import _build
    from ..obs import log as olog
    from ..runtime.faults import FaultInjector, Rule
    from .server import ObsServer, ProofService

    if args.build_dir is not None:
        _build.set_build_dir(args.build_dir)

    log_path = None
    if args.log_dir is not None:
        log_path = olog.configure(log_dir=args.log_dir, proc="serve")
        if log_path is None:
            raise SystemExit(f"--log-dir: {args.log_dir!r} is not writable")

    faults = None
    if args.chaos and args.faults:
        # journal-plane kills die for real: os._exit skips every atexit
        # and finally, so the restarted process sees exactly what a power
        # cut would leave
        faults = FaultInjector(
            [Rule.parse(e) for e in args.faults.split(";") if e.strip()],
            kill_cb=lambda _label: os._exit(1))

    svc = ProofService(
        host=args.host, port=args.port, prover_workers=args.workers,
        queue_depth=args.queue_depth, max_batch=args.max_batch,
        max_retries=args.retries, job_timeout_s=args.timeout,
        ckpt_dir=args.ckpt_dir, chaos=args.chaos,
        verify_on_complete=args.verify,
        allow_remote_shutdown=args.allow_remote_shutdown,
        store_dir=args.store_dir, store_byte_budget=args.store_budget,
        bucket_cap=args.bucket_cap, journal_dir=journal_dir,
        faults=faults, device=args.device,
        devices=args.devices.split(",") if args.devices else None,
        store_peers=parse_peers(args.store_peers)
        if args.store_peers else None).start()

    obs = None
    if args.obs_port is not None:
        obs = ObsServer(svc, host=args.host, port=args.obs_port).start()

    # mode "0" constructs nothing (svc.autoscaler stays None)
    autoscaler = svc.attach_autoscaler(
        mode=args.autoscale, slo_p95_standard_s=args.slo_standard_s)

    drain_state = {}

    def _drain_handler(signum, _frame):
        # signal handlers run on the main thread while serve_forever
        # blocks in Event.wait; drain() releases that wait when done
        if drain_state:
            return  # second signal during a drain: already on our way out
        drain_state["signal"] = signal.Signals(signum).name
        drain_state["clean"] = svc.drain(timeout_s=DRAIN_TIMEOUT_S)

    signal.signal(signal.SIGTERM, _drain_handler)
    signal.signal(signal.SIGINT, _drain_handler)

    print(json.dumps({"listening": f"{svc.host}:{svc.port}",
                      "obs": f"{obs.host}:{obs.port}" if obs else None,
                      "workers": args.workers, "chaos": args.chaos,
                      "device": str(svc.device),
                      "store": args.store_dir, "journal": journal_dir,
                      "log_file": log_path, "autotune": svc.autotune,
                      "autoscale": autoscaler.mode if autoscaler else "0",
                      "build": _build.report()}),
          flush=True)
    svc.serve_forever()
    if obs is not None:
        obs.close()
    if drain_state:
        ctr = svc.metrics.snapshot()["counters"]
        print(json.dumps({"drained": drain_state.get("signal"),
                          "clean": drain_state.get("clean"),
                          "jobs_drain_parked":
                              ctr.get("jobs_drain_parked", 0)}),
              flush=True)


if __name__ == "__main__":
    main()
