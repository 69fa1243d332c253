#!/usr/bin/env python3
"""Reference-scale end-to-end prove runner for the PyTorch port (the
counterpart of scripts/scale_run.py).

Runs the reference's Merkle-membership workloads on TorchBackend:

  v1 analog (--proofs 1):   height-32 Merkle membership, 1 proof
     => n = 2^13, quotient domain 2^16 (reference src/dispatcher.rs:1064-1070)
  v2 analog (--proofs 50):  50 proofs => n = 2^18, quotient domain 2^21
     (reference src/dispatcher2.rs:1219-1221)
  --proofs 200:             n = 2^20, quotient domain 2^23

Pipeline: circuit generation (workload.generate_circuit(Random(11))) ->
device SRS of n + 3 powers (kzg.universal_setup_device, tau from
Random(12)) -> preprocess on TorchBackend -> a cold and a warm 5-round
prove (rng Random(13)) -> verify (Random(14)). Prints one JSON line with
the JAX script's keys (height, num_proofs, n, log2_n, num_gates,
circuit_gen_s, setup_s, preprocess_s, prove_cold_s, prove_s, rounds,
trace, verify_s, verified) plus `device`, `rounds_cold` (the cold prove's
spans, where the first use of each NTT plan and the circuit's tables
show), and on the card `card` (its nvidia-smi name and power limit),
`peak_mib` (the peak device memory of the run) and `phase_peak_mib` (of
each phase: the preprocess's includes the commit key's MSM build).

    python3 scripts/torch_scale_run.py [--height 32] [--proofs 1]
        [--out FILE] [--skip-verify] [--single-prove] [--device cuda|cpu]

Runs on the card unless --device cpu asks for the kernels' plain
versions; without a card and without --device cpu it exits non-zero
before it builds anything. It never falls back to the CPU.
"""

import argparse
import json
import os
import random
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class _Peak:
    """Peak device memory per phase on a CUDA device (None elsewhere)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.cuda = device.type == "cuda"
        self.device = device
        self.phases = {}

    def start(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def end(self, name):
        """Synchronize and record the phase's peak, MiB."""
        if self.cuda:
            self.torch.cuda.synchronize(self.device)
            self.phases[name] = round(self.torch.cuda.max_memory_allocated(
                self.device) / 2**20, 1)


def scale_run(height=32, proofs=1, device=None, skip_verify=False,
              single_prove=False, log=None):
    """The workload at (height, proofs) end to end on TorchBackend on
    `device` -> the result dict (scale_run.py's keys plus device,
    rounds_cold and, on the card, card, peak_mib and phase_peak_mib).
    Raises if the proof does not verify."""
    from distributed_plonk_tpu_torch import kzg
    from distributed_plonk_tpu_torch.backend.field_torch import \
        resolve_device
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.trace import Tracer
    from distributed_plonk_tpu_torch.verifier import verify
    from distributed_plonk_tpu_torch.workload import generate_circuit

    device = resolve_device(device, "torch_scale_run")
    log = log or (lambda msg: print("[scale] " + msg, file=sys.stderr,
                                    flush=True))
    peak = _Peak(device)
    res = {"height": height, "num_proofs": proofs}
    t0 = time.perf_counter()
    ckt, _tree = generate_circuit(rng=random.Random(11), height=height,
                                  num_proofs=proofs)
    res["n"] = ckt.n
    res["log2_n"] = ckt.n.bit_length() - 1
    res["num_gates"] = ckt.num_gates
    res["circuit_gen_s"] = round(time.perf_counter() - t0, 3)
    log("circuit: %d gates -> n = 2^%d (%ss)" % (
        ckt.num_gates, res["log2_n"], res["circuit_gen_s"]))

    backend = TorchBackend(device=device)
    peak.start()
    t0 = time.perf_counter()
    srs = kzg.universal_setup_device(ckt.n + 2, rng=random.Random(12),
                                     device=device)
    peak.end("setup")
    res["setup_s"] = round(time.perf_counter() - t0, 3)
    log("device SRS: %d powers (%ss)" % (srs.count, res["setup_s"]))

    peak.start()
    t0 = time.perf_counter()
    pk, vk = kzg.preprocess(srs, ckt, backend=backend)
    peak.end("preprocess")
    res["preprocess_s"] = round(time.perf_counter() - t0, 3)
    log("preprocess (%ss)" % res["preprocess_s"])
    del srs

    # the cold prove pays the first use of the quotient domain's NTT plan
    # and the circuit's tables; the warm one is the steady state
    if not single_prove:
        tracer = Tracer()
        peak.start()
        t0 = time.perf_counter()
        prove(random.Random(13), ckt, pk, backend, tracer=tracer)
        peak.end("prove_cold")
        res["prove_cold_s"] = round(time.perf_counter() - t0, 3)
        res["rounds_cold"] = {k: round(v, 3)
                              for k, v in tracer.totals(depth=1).items()}
        log("prove (cold): %ss" % res["prove_cold_s"])

    tracer = Tracer()
    peak.start()
    t0 = time.perf_counter()
    proof = prove(random.Random(13), ckt, pk, backend, tracer=tracer)
    peak.end("prove")
    res["prove_s"] = round(time.perf_counter() - t0, 3)
    res["rounds"] = {k: round(v, 3) for k, v in tracer.totals(depth=1).items()}
    res["trace"] = tracer.events
    log("prove (warm): %ss  rounds=%s" % (res["prove_s"], res["rounds"]))

    if not skip_verify:
        t0 = time.perf_counter()
        ok = verify(vk, ckt.public_input(), proof, rng=random.Random(14))
        res["verify_s"] = round(time.perf_counter() - t0, 3)
        res["verified"] = bool(ok)
        if not ok:
            raise AssertionError("proof did not verify")
        log("verified (%ss)" % res["verify_s"])
    res["device"] = str(device)
    if device.type == "cuda":
        res["card"] = card_name()
        res["peak_mib"] = max(peak.phases.values())
        res["phase_peak_mib"] = peak.phases
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--proofs", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-verify", action="store_true")
    ap.add_argument("--single-prove", action="store_true",
                    help="one prove only (cold == warm)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from distributed_plonk_tpu_torch.backend.field_torch import \
        resolve_device
    try:
        device = resolve_device(args.device, "torch_scale_run")
    except RuntimeError as e:
        print("torch_scale_run: %s" % e, file=sys.stderr)
        return 1
    res = scale_run(args.height, args.proofs, device, args.skip_verify,
                    args.single_prove)
    out = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
