"""Time the PyTorch port's warm v1 prove in two checkouts, alternately, on
one card: an A/B of the single-card prove path; with --eval, of kernel 8
(round 4's batched evaluation) alone.

    python3 scripts/torch_warm_ab.py DIR_A DIR_B [--order ABBA] [--proves 15]
    python3 scripts/torch_warm_ab.py DIR_A DIR_B --eval [--order ABBA]

Each letter of --order is one run: a fresh process in that checkout, which
imports that checkout's distributed_plonk_tpu_torch and builds its kernels
into this checkout's build directory (_build.set_build_dir; the libraries
are keyed by a hash of their sources, so sources that hash the same are
not built twice, and nothing is written into the other checkout). A run
generates the reference v1
workload (height-32 Rescue Merkle, one proof, n = 2^13), preprocesses it on
TorchBackend() from the device SRS (tau 0xDEADBEEF), proves once cold, then
--proves times warm with Random(1) and a trace.Tracer, each prove ended by
torch.cuda.synchronize(); every proof must equal
tests/fixtures/proof_merkle_h32_p1.hex. Prints the card's name and power
limit, then one JSON line per run: {"tree", "warm_s": [...], "median_s",
"min_s", "round4_s": [...], "round4_median_s", "launches"}: round4_s the
warm proves' round-4 spans, launches the kernel launch counters of the
last warm prove (a kernel that tree does not have is absent).

An --eval run builds only kernels 1 and 8 and times
prover_torch.poly_eval_cuda at each of this checkout's chip_smoke.py
EVAL_PARITY shapes (v1's, v2's and 2^20's round 4, a v1 fleet worker's
EVAL), on chip_smoke.eval_operands' seeded words, with chip_smoke.py's
own timers and bound: exact against poly_eval_ref in one counted launch,
then graph ms (graph_ms), launch ms (launch_ms), the nodes of a CUDA
graph of three calls (graph_nodes) and the profiler's kernels a call and
their us (eval_profile). It prints one JSON line {"tree", "shapes":
{label: {"B", "L", "ms", "launch_ms", "graph_nodes", "kernels_per_call",
"prof_us", "bound_ms", "bound_by", "geometry"}}} (geometry:
eval_geometry's, None in a tree without it), and after the runs
{"median_ms": {letter: {label: ms}}}. Exits non-zero if a run fails.
"""

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(HERE, "build", "dpt_torch_kernels")


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
    _build.set_build_dir(BUILD_DIR)
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


def child_eval():
    """One --eval run, in the current directory's checkout, with this
    checkout's chip_smoke.py for the shapes, operands and timers."""
    sys.path.insert(0, os.getcwd())
    import random

    import torch

    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend import prover_torch as PT
    from distributed_plonk_tpu_torch.trace import FR_MUL_IMADS

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: kernel 8 runs only on the card")
    _build.SOURCES = {k: v for k, v in _build.SOURCES.items()
                      if k in ("field", "eval")}
    _build.set_build_dir(BUILD_DIR)
    _build.load()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = random.Random(2023)
    out = {}
    for label, B, L, reps in cs.EVAL_PARITY:
        polys, zs = cs.eval_operands(dev, rng, B, L)

        def fn(polys=polys, zs=zs):
            return PT.poly_eval_cuda(polys, zs)

        _build.reset_launches()
        got = fn()
        assert _build.LAUNCHES["poly_eval"] == 1, dict(_build.LAUNCHES)
        assert torch.equal(got, PT.poly_eval_ref(polys, zs)), label
        launch = cs.launch_ms(fn, reps)
        kinds, _ = cs.graph_nodes(fn, 3)
        per_call, us, _ = cs.eval_profile(fn)
        nbytes, imads = 32 * B * (L + 2), B * L * FR_MUL_IMADS
        out[label] = {
            "B": B, "L": L, "ms": cs.graph_ms(fn, reps), "launch_ms": launch,
            "graph_nodes": dict(kinds), "kernels_per_call": per_call,
            "prof_us": us, "bound_ms": cs.bound_ms(nbytes, imads),
            "bound_by": cs.bound_by(nbytes, imads),
            "geometry": (PT.eval_geometry(B, L, sms)
                         if hasattr(PT, "eval_geometry") else None)}
        del polys, zs, got
    print(json.dumps({"shapes": out}))


def main(argv):
    if argv[:1] == ["--child"]:
        child(int(argv[1]))
        return 0
    if argv[:1] == ["--child-eval"]:
        child_eval()
        return 0
    order, proves, trees, kernel = "ABBA", 15, [], False
    it = iter(argv)
    for a in it:
        if a == "--order":
            order = next(it)
        elif a == "--proves":
            proves = int(next(it))
        elif a == "--eval":
            kernel = True
        else:
            trees.append(os.path.abspath(a))
    if len(trees) != 2:
        raise SystemExit(__doc__)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    ms = {}
    for letter in order:
        tree = trees["AB".index(letter)]
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)]
            + (["--child-eval"] if kernel else ["--child", str(proves)]),
            cwd=tree, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["tree"] = "%s %s" % (letter, tree)
        print(json.dumps(res), flush=True)
        for label, rec in res.get("shapes", {}).items():
            ms.setdefault(letter, {}).setdefault(label, []).append(rec["ms"])
    if kernel:
        print(json.dumps({"median_ms": {
            letter: {label: statistics.median(v) for label, v in
                     shapes.items()} for letter, shapes in ms.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
