"""Why a batch of v1 jobs runs slowly in the port's proof service while a v2
job's key build runs beside it: a control run on one card.

    python3 scripts/torch_service_contention.py [--out FILE] [RUN ...]

Each run is a fresh ProofService on cuda:0 (two pool workers, four slots of
the card and a store of its own, as chip_smoke.py's service phase starts
it, but no journal: a journaled service would replay the jobs submitted
before its start as recovered ones). The v1 keys are warmed first; the
jobs are submitted before the scheduler starts, so its first pop takes
the four v1 jobs (seeds 11-14, one prove_many batch) and, where a v2 job
(seed 11) is queued behind them, its next pop builds the v2 keys on the
scheduler thread while the batch proves:

  alone      the v1 batch, nothing else queued;
  hog        the v1 batch beside one more thread that runs pure Python
             (modular powers of ints: no torch, no lock, no card) until
             the batch is done or HOG_S have passed (interpreter switch
             interval 5 ms, CPython's default);
  hog 0.5ms  the same with sys.setswitchinterval(0.0005);
  v2         the v1 batch with the v2 job behind it (5 ms);
  v2 0.5ms   the same at 0.5 ms;
  v2 again   the v2 run repeated (the process's plan caches now warm).

RUN names select runs (default: all, in this order). For each run it
records the batch's run seconds (STATUS run_s) and seconds by round, the
v2 key build and run seconds, and each Python thread's CPU seconds
(/proc/self/task/<tid>/stat, user + system) over the batch's window, from
the scheduler's start to the batch's last proof. A thread that waits for
the interpreter lock sleeps; one that waits for the card spins in the
CUDA driver's synchronize and is charged CPU time. The batch's proofs
must be the same bytes in every run.

Prints the card's name and power limit, one JSON line per run, and
writes them all to --out (default chiprun_out/service_contention.json).
Needs a card; exits non-zero without one.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

V1 = {"kind": "merkle", "height": 32, "num_proofs": 1}
V2 = {"kind": "merkle", "height": 32, "num_proofs": 50}
V1_SEEDS = (11, 12, 13, 14)
RUNS = (("alone", None, 0.005), ("hog", "hog", 0.005),
        ("hog 0.5ms", "hog", 0.0005), ("v2", "v2", 0.005),
        ("v2 0.5ms", "v2", 0.0005), ("v2 again", "v2", 0.005))
# BLS12-381's scalar field: the hog does the host field arithmetic a
# circuit build does
P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
HOG_S = 120.0


def hog(stop, out):
    x, t0 = 7, time.monotonic()
    while not stop.is_set() and time.monotonic() < t0 + HOG_S:
        for _ in range(1000):
            x = pow(x, 5, P) + 1
    out.update(hog_wall_s=time.monotonic() - t0,
               hog_cpu_s=time.thread_time())


def thread_cpu_s():
    """{thread name: CPU seconds} of this process's live Python threads."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for t in threading.enumerate():
        try:
            with open("/proc/self/task/%d/stat" % t.native_id) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, TypeError):
            continue
        out[t.name] = (int(fields[11]) + int(fields[12])) / tick
    return out


def one_run(label, beside, interval, device):
    from distributed_plonk_tpu_torch.service import ProofService
    work = tempfile.mkdtemp(prefix="dpt-contention-")
    svc = ProofService(port=0, prover_workers=2, device=device,
                       devices=[device] * 4,
                       store_dir=os.path.join(work, "store"))
    try:
        svc.warmup_local(V1)
        batch = [svc.submit_local(dict(V1, seed=s)) for s in V1_SEEDS]
        v2 = (svc.submit_local(dict(V2, seed=11)) if beside == "v2"
              else None)
        stop, hogged = threading.Event(), {}
        hogger = threading.Thread(target=hog, args=(stop, hogged),
                                  name="hog", daemon=True)
        sys.setswitchinterval(interval)
        if beside == "hog":
            hogger.start()
        cpu0, t0 = thread_cpu_s(), time.monotonic()
        svc.start()
        for job in batch:
            assert job.done_event.wait(1800) and job.state == "done", \
                job.error
        wall = time.monotonic() - t0
        cpu1 = thread_cpu_s()
        stop.set()
        if beside == "hog":
            hogger.join()
        sys.setswitchinterval(0.005)
        if v2 is not None:
            assert v2.done_event.wait(1800) and v2.state == "done", v2.error
        rec = {
            "run": label, "switch_interval_s": interval,
            "batch_window_s": wall,
            "batch_run_s": [job.run_s for job in batch],
            "batch_size": [job.batch_size for job in batch],
            "batch_rounds_s": dict(batch[0].round_totals),
            **hogged,
            "thread_cpu_s": {k: cpu1[k] - cpu0.get(k, 0.0)
                             for k in sorted(cpu1)},
            "counters": {k: v for k, v in
                         svc.metrics.snapshot()["counters"].items()
                         if k.startswith(("batch_", "placement_",
                                          "pipelined_", "bucket_"))},
        }
        if v2 is not None:
            rec["v2_key_build_s"] = svc.buckets.get(v2.spec).build_s
            rec["v2_wait_s"], rec["v2_run_s"] = v2.wait_s, v2.run_s
        return rec, [job.proof_bytes for job in batch]
    finally:
        sys.setswitchinterval(0.005)
        svc.shutdown()
        shutil.rmtree(work, ignore_errors=True)


def main(argv):
    import torch
    out = os.path.join(HERE, "chiprun_out", "service_contention.json")
    if argv[:1] == ["--out"]:
        out, argv = argv[1], argv[2:]
    runs = [r for r in RUNS if not argv or r[0] in argv]
    if not torch.cuda.is_available():
        print("torch_service_contention: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    records, first = [], None
    for label, beside, interval in runs:
        rec, blobs = one_run(label, beside, interval, "cuda:0")
        rec["card"] = smi
        if first is None:
            first = blobs
        assert blobs == first, "%s: the batch's bytes differ" % label
        records.append(rec)
        print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
