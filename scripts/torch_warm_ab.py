"""Time the PyTorch port's warm v1 prove in two checkouts, alternately, on
one card: an A/B of the single-card prove path.

    python3 scripts/torch_warm_ab.py DIR_A DIR_B [--order ABBA] [--proves 15]

Each letter of --order is one run: a fresh process in that checkout, which
imports that checkout's distributed_plonk_tpu_torch and builds its kernels
(a checkout without a build/ directory shares this one's, so sources that
hash the same are not built twice). A run generates the reference v1
workload (height-32 Rescue Merkle, one proof, n = 2^13), preprocesses it on
TorchBackend() from the device SRS (tau 0xDEADBEEF), proves once cold, then
--proves times warm with Random(1) and a trace.Tracer, each prove ended by
torch.cuda.synchronize(); every proof must equal
tests/fixtures/proof_merkle_h32_p1.hex. Prints the card's name and power
limit, then one JSON line per run: {"tree", "warm_s": [...], "median_s",
"min_s", "round4_s": [...], "round4_median_s", "launches"}: round4_s the
warm proves' round-4 spans, launches the kernel launch counters of the
last warm prove (a kernel that tree does not have is absent). Exits
non-zero if a run fails.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(proves):
    """One run, in the current directory's checkout."""
    sys.path.insert(0, os.getcwd())
    import random

    import torch

    from distributed_plonk_tpu_torch import kzg, proof_io
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.trace import Tracer
    from distributed_plonk_tpu_torch.workload import generate_circuit

    with open(os.path.join("tests", "fixtures",
                           "proof_merkle_h32_p1.hex")) as f:
        golden = bytes.fromhex(f.read().strip())
    _build.load()
    ckt, _ = generate_circuit(rng=random.Random(11), height=32,
                              num_proofs=1)
    srs = kzg.universal_setup_device(ckt.n + 2, tau=0xDEADBEEF)
    be = TorchBackend()
    pk, _vk = kzg.preprocess(srs, ckt, be)
    warm, round4 = [], []
    for i in range(proves + 1):
        torch.cuda.synchronize()
        _build.reset_launches()
        tr = Tracer()
        t = time.perf_counter()
        proof = prove(random.Random(1), ckt, pk, be, tracer=tr)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        assert proof_io.serialize_proof(proof) == golden, "proof bytes"
        if i:  # the first prove is the cold one
            warm.append(secs)
            round4.append(tr.totals(0)["round4"])
    print(json.dumps({"warm_s": warm, "median_s": statistics.median(warm),
                      "min_s": min(warm), "round4_s": round4,
                      "round4_median_s": statistics.median(round4),
                      "launches": dict(_build.LAUNCHES)}))


def main(argv):
    if argv[:1] == ["--child"]:
        child(int(argv[1]))
        return 0
    order, proves, trees = "ABBA", 15, []
    it = iter(argv)
    for a in it:
        if a == "--order":
            order = next(it)
        elif a == "--proves":
            proves = int(next(it))
        else:
            trees.append(os.path.abspath(a))
    if len(trees) != 2:
        raise SystemExit(__doc__)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for letter in order:
        tree = trees["AB".index(letter)]
        if not os.path.lexists(os.path.join(tree, "build")) \
                and os.path.exists(os.path.join(HERE, "build")):
            os.symlink(os.path.join(HERE, "build"),
                       os.path.join(tree, "build"))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             str(proves)], cwd=tree, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["tree"] = "%s %s" % (letter, tree)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
