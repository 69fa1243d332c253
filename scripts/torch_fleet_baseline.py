#!/usr/bin/env python3
"""The v1 workload proved over a local fleet of the PyTorch port's workers
(the counterpart of scripts/fleet_baseline.py: BASELINE.json's
configuration 2, "4 workers over the wire", at the workload size given on
the command line; the reference's analog is test2 over its 2-host LAN,
reference src/dispatcher2.rs:1273-1295).

Spawns N port workers (`python -m distributed_plonk_tpu_torch.runtime.
worker i <network.json> --device D`) on free localhost ports (bind 0 and
read the port back), makes the SRS (tau from Random(12)) and preprocesses
in this process on --device, proves cold and then warm through the port's
Dispatcher / RemoteBackend (every NTT and MSM rides the fleet protocol,
the round math stays in this process), verifies, and prints one JSON line
with the JAX script's keys (workers, height, num_proofs, n, log2_n,
circuit_gen_s, setup_preprocess_host_s, prove_cold_s, prove_s, rounds,
verify_s, verified) plus `device`; on the card also `card`, its
nvidia-smi name and power limit.

    python3 scripts/torch_fleet_baseline.py [--workers 4] [--height 32]
        [--proofs 1] [--device cuda|cpu] [--worker-timeout S] [--out FILE]

The workers and the set-up run on the card unless --device cpu asks for
the kernels' plain versions; without a card and without --device cpu the
script exits non-zero before it starts a worker. It never falls back to
the CPU.
"""

import argparse
import json
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def free_port():
    """Bind port 0 and read the port back."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def start_workers(count, workdir, device):
    """count port workers on free ports; returns (config, procs, logs)."""
    from distributed_plonk_tpu_torch.runtime.netconfig import NetworkConfig
    cfg = NetworkConfig(["127.0.0.1:%d" % free_port()
                         for _ in range(count)])
    cfg_path = os.path.join(workdir, "network.json")
    cfg.save(cfg_path)
    procs, logs = [], []
    for i in range(count):
        logs.append(os.path.join(workdir, "worker%d.log" % i))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "distributed_plonk_tpu_torch.runtime.worker", str(i),
                 cfg_path, "--device", device.type], cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT))
    return cfg, procs, logs


def wait_up(cfg, procs, timeout_s):
    """A Dispatcher once every worker answers a HEALTH probe (fresh
    connections, nothing counted); raises if a worker exits first."""
    from distributed_plonk_tpu_torch.runtime.dispatcher import Dispatcher
    d = Dispatcher(cfg)
    deadline = time.monotonic() + timeout_s
    while any(w.probe(timeout_ms=2000) is None for w in d.workers):
        dead = [i for i, p in enumerate(procs) if p.poll() is not None]
        if dead:
            raise RuntimeError("workers exited: %s" % dead)
        if time.monotonic() > deadline:
            raise RuntimeError("workers did not come up in %.0f s"
                               % timeout_s)
        time.sleep(0.5)
    d.ping()
    return d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--proofs", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="the workers' and the set-up's device: cuda "
                         "(default) or cpu")
    ap.add_argument("--worker-timeout", type=float, default=300,
                    help="seconds to wait for the fleet to come up")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from distributed_plonk_tpu_torch.backend.field_torch import \
        resolve_device
    try:
        device = resolve_device(args.device, "torch_fleet_baseline")
    except RuntimeError as e:
        print("torch_fleet_baseline: %s" % e, file=sys.stderr)
        return 1
    from distributed_plonk_tpu_torch import kzg
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.runtime.dispatcher import RemoteBackend
    from distributed_plonk_tpu_torch.trace import Tracer
    from distributed_plonk_tpu_torch.verifier import verify
    from distributed_plonk_tpu_torch.workload import generate_circuit

    res = {"workers": args.workers, "height": args.height,
           "num_proofs": args.proofs}
    t0 = time.perf_counter()
    ckt, _ = generate_circuit(rng=random.Random(11), height=args.height,
                              num_proofs=args.proofs)
    res["n"] = ckt.n
    res["log2_n"] = ckt.n.bit_length() - 1
    res["circuit_gen_s"] = round(time.perf_counter() - t0, 3)
    print("[fleet] circuit n = 2^%d" % res["log2_n"], file=sys.stderr)

    workdir = tempfile.mkdtemp(prefix="dpt_fleet_baseline_")
    # the workers start (and load their kernels) beside the set-up
    cfg, procs, logs = start_workers(args.workers, workdir, device)
    ok = False
    try:
        t0 = time.perf_counter()
        srs = kzg.universal_setup_device(ckt.n + 2, rng=random.Random(12),
                                         device=device)
        pk, vk = kzg.preprocess(srs, ckt, TorchBackend(device=device))
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
        res["setup_preprocess_host_s"] = round(time.perf_counter() - t0, 3)
        print("[fleet] set-up and preprocess on %s %ss"
              % (device, res["setup_preprocess_host_s"]), file=sys.stderr)

        d = wait_up(cfg, procs, args.worker_timeout)
        print("[fleet] workers up", file=sys.stderr)
        be = RemoteBackend(d)
        t0 = time.perf_counter()
        prove(random.Random(13), ckt, pk, be)
        res["prove_cold_s"] = round(time.perf_counter() - t0, 3)
        tr = Tracer()
        t0 = time.perf_counter()
        proof = prove(random.Random(13), ckt, pk, be, tracer=tr)
        res["prove_s"] = round(time.perf_counter() - t0, 3)
        res["rounds"] = {k: round(v, 3) for k, v in tr.totals(1).items()}
        t0 = time.perf_counter()
        verified = verify(vk, ckt.public_input(), proof,
                          rng=random.Random(14))
        res["verify_s"] = round(time.perf_counter() - t0, 3)
        res["verified"] = bool(verified)
        res["device"] = str(device)
        if device.type == "cuda":
            res["card"] = card_name()
        d.shutdown()
        for p in procs:
            p.wait(timeout=15)
        ok = verified
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if not ok:
            for path in logs:
                with open(path) as f:
                    print("%s:\n%s" % (os.path.basename(path),
                                       f.read()[-2000:]), file=sys.stderr)
        shutil.rmtree(workdir, ignore_errors=True)

    out = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
