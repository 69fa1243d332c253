"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. Set-up: the card's name and power limit (nvidia-smi), the kernels'
   build from csrc/ (nvcc, all sources in parallel), and the host SRS of
   the reference v1 workload (tau = 0xDEADBEEF).
2. Kernel parity: each kernel entry against its plain torch version on
   the card, on seeded inputs at the main path's shapes, with tolerance 0
   (every value is an integer in canonical form, every addition in a
   fixed order), each timed as calls from Python ("launch_ms", host path
   included) beside its plain version and its bound. The MSM entries
   (msm_digits, bucket_sums, msm_tail) run one round-1 commit batch, 5
   handles of width n + 2 over the commit key's window-shifted copy
   (304,288 points), whose build time is printed with the sort's.
3. Full-width prove: the height-32 Rescue Merkle membership circuit
   (n = 2^13, quotient domain 2^16) preprocessed and proven on
   TorchBackend() cold, then proven again warm; both proofs must equal
   tests/fixtures/proof_merkle_h32_p1.hex byte for byte and verify. The
   launch counters are zeroed just before preprocess and read just after
   it (the elementwise add builds the shifted key there), then zeroed
   before the warm prove and read after it: every other kernel must have
   launched there, the MSM entries once per commit batch, and the
   elementwise add not at all.
4. Device time: torch.profiler's CUDA kernel times for one launch of each
   kernel at its parity shape, and for one more warm prove (device busy
   time by kernel and the idle share; "not measured" if the profiler
   records no CUDA events); then each kernel's "ms", its device time:
   CUDA events around the replay of a CUDA graph of its launches.

Imports only the port, torch and the standard library. The last
line is {"ok": true, "device": {...}}; without a card it exits non-zero
before printing any result.
"""

import json
import os
import random
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "proof_merkle_h32_p1.hex")

# H100 SXM peaks for the bound: HBM 3.35 TB/s (NVIDIA data sheet); 32-bit
# integer multiply-add, 64 per SM per clock on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput) x 132 SMs
# x 1.98 GHz boost clock. A 32 x 32 -> 64-bit product is two of them (lo,
# hi); field additions and data movement are not counted.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
FR_MUL_IMADS = 2 * (2 * 8 * 8 + 8)      # word-level CIOS, 8 words
FQ_MUL_IMADS = 2 * (2 * 12 * 12 + 12)   # 12 words


def bound_ms(nbytes, imads):
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, imads / IMAD_PER_S)


def bound_by(nbytes, imads):
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= imads / IMAD_PER_S
            else "operations")


def _events_ms(run):
    """Milliseconds between CUDA events recorded around run()."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def launch_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls from Python (CUDA events),
    after one warm-up call: the device time plus the host's launch path
    (ctypes, allocation, checks) wherever that is the longer."""
    fn()
    torch.cuda.synchronize()
    return _events_ms(lambda: [fn() for _ in range(reps)]) / reps


def graph_ms(fn, reps):
    """Mean device milliseconds of one fn(): reps calls captured in a CUDA
    graph, the graph replayed once untimed and once between CUDA events,
    so the host's launch path is not in the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay) / reps
    del graph
    return ms


def max_abs_err(got, want):
    """Largest |difference| of the uint32 words of two outputs."""
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    g = got.to(torch.int64) & 0xFFFFFFFF
    w = want.to(torch.int64) & 0xFFFFFFFF
    return int((g - w).abs().max().item())


def _device_kernels(prof):
    """(name, calls, device us) of each CUDA kernel a profile recorded."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0) or 0)
        out.append((e.key, e.count, us))
    return sorted(out, key=lambda r: -r[2])


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def graph_kernels(runs, kernels):
    """Each kernel's device time at its parity shape from a CUDA graph of
    its launches, into kernels[name]["ms"] where it has a record."""
    for name, (fn, reps) in runs.items():
        ms = graph_ms(fn, reps)
        print("graph time  %-20s %.4f ms per call" % (name, ms))
        if name in kernels:
            kernels[name]["ms"] = ms


def profile_kernels(runs):
    """Device time of one launch of each kernel at its parity shape."""
    for name, (fn, _) in runs.items():
        fn()
        torch.cuda.synchronize()
        with _profiler() as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        rows = _device_kernels(prof)
        if not rows:
            print("device time %-20s not measured (no CUDA events)" % name)
            continue
        us = sum(r[2] for r in rows) / 5
        print("device time %-20s %.2f us per call (%s)"
              % (name, us, ", ".join("%s x%d" % (k[:40], c // 5)
                                     for k, c, _ in rows)))


def profile_prove(fn):
    """Device busy time of one warm prove, by kernel, and its idle share."""
    torch.cuda.synchronize()
    with _profiler() as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = _device_kernels(prof)
    if not rows:
        print("profiled warm prove: device time not measured")
        return
    busy = sum(r[2] for r in rows) / 1e6
    print("profiled warm prove: wall %.4f s (profiler on), device busy "
          "%.4f s, idle share %.3f" % (wall, busy, 1 - busy / wall))
    for key, count, us in rows[:15]:
        print("  %-60s %6d launches %10.1f us" % (key[:60], count, us))


def phase(name):
    print("== phase: %s" % name, flush=True)
    return time.perf_counter()


def done(name, t0):
    print("== phase %s: %.3f s" % (name, time.perf_counter() - t0),
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check needs a card",
              file=sys.stderr)
        return 2

    from distributed_plonk_tpu_torch import kzg, proof_io
    from distributed_plonk_tpu_torch.constants import R_MOD
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.trace import Tracer
    from distributed_plonk_tpu_torch.verifier import verify
    from distributed_plonk_tpu_torch.workload import generate_circuit
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend import curve_torch as CT
    from distributed_plonk_tpu_torch.backend import field_torch as F
    from distributed_plonk_tpu_torch.backend import msm_torch as M
    from distributed_plonk_tpu_torch.backend import ntt_torch as N
    from distributed_plonk_tpu_torch.backend.limbs import (ints_to_words,
                                                          lift, to_tensor)
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend

    dev = torch.device("cuda")
    rng = random.Random(20261016)

    # --- 1. set-up ----------------------------------------------------------
    t0 = phase("setup")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.perf_counter()
    _build.load()
    print("kernels built and loaded in %.3f s (%s)"
          % (time.perf_counter() - t, _build.source_hash()), flush=True)
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas %s: %s" % (name, line.strip()))
    ckt, _ = generate_circuit(rng=random.Random(11), height=32,
                              num_proofs=1)
    n = ckt.n
    t = time.perf_counter()
    srs = kzg.universal_setup(n + 3, tau=0xDEADBEEF)
    print("circuit n = %d; host SRS of %d powers in %.3f s"
          % (n, n + 3, time.perf_counter() - t), flush=True)
    done("setup", t0)

    # --- 2. kernel parity -----------------------------------------------------
    t0 = phase("kernel parity")
    kernels = {}
    # kernel name -> (one launch at its main-path shape, launches per
    # timing): phase 4 takes each kernel's device time from these
    runs = {}

    def record(name, source, replaces, err, py_ms, plain_ms, nbytes, imads,
               shape):
        assert err == 0, (name, err)
        kernels[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "parity": "exact",
            "ms": None, "launch_ms": py_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms(nbytes, imads),
            "bound_by": bound_by(nbytes, imads), "library_ms": None}
        print("parity %-18s %-34s exact  launched from Python %.4f ms  "
              "plain %.3f ms  bound %.4f ms (%s)"
              % (name, shape, py_ms, plain_ms, kernels[name]["bound_ms"],
                 kernels[name]["bound_by"]), flush=True)

    def rand_field(spec, count):
        vals = [0, 1, spec.mod - 1] + [rng.randrange(spec.mod)
                                       for _ in range(count - 3)]
        return to_tensor(ints_to_words(vals, spec.n_words), dev)

    def plain_ms(fn):
        """(output, milliseconds) of one call of a plain version, timed
        with CUDA events, after an untimed call (the first use of each
        torch kernel loads it)."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    # K1: Fr at 2^16 lanes (a round-3 plane), Fq at 2^14
    for spec, lanes in ((F.FR, 1 << 16), (F.FQ, 1 << 14)):
        a, b = rand_field(spec, lanes), rand_field(spec, lanes)
        got = F.mont_mul_cuda(spec, a, b)
        want, pms = plain_ms(lambda: F.mont_mul_ref(spec, a, b))
        err = max_abs_err(got, want)
        fn = (lambda a=a, b=b, spec=spec: F.mont_mul_cuda(spec, a, b))
        py_ms = launch_ms(fn, 50)
        runs["mont_mul" if spec is F.FR else "mont_mul Fq"] = (fn, 50)
        L = spec.n_words
        imads = lanes * (FR_MUL_IMADS if L == 8 else FQ_MUL_IMADS)
        nbytes = 3 * 4 * L * lanes
        if spec is F.FR:
            record("mont_mul", "distributed_plonk_tpu_torch/csrc/mont_mul.cu",
                   "distributed_plonk_tpu/backend/field_pallas.py:391", err,
                   py_ms, pms, nbytes, imads, "Fr (8, 65536)")
        else:
            assert err == 0, err
            print("parity %-18s %-34s exact  launched from Python %.4f ms  "
                  "plain %.3f ms  bound %.4f ms (%s)"
                  % ("mont_mul", "Fq (12, 16384)", py_ms, pms,
                     bound_ms(nbytes, imads), bound_by(nbytes, imads)))

    # K2: all four modes at 2^13 (batch 5, round 1's wires), then the
    # round-3 mode (forward coset) at 2^16, batch 8
    def ntt_case(size, batch, inverse, coset):
        plan = N.get_plan(size, dev)
        v = lift([rng.randrange(R_MOD) for _ in range(size * batch)],
                 dev).reshape(8, batch, size)
        got = N.ntt_cuda(plan, v, inverse, coset)
        want, pms = plain_ms(lambda: N.ntt_ref(plan, v, inverse, coset))
        return plan, v, max_abs_err(got, want), pms

    for inverse in (False, True):
        for coset in (False, True):
            _, _, err, pms = ntt_case(1 << 13, 5, inverse, coset)
            assert err == 0, ("ntt", inverse, coset, err)
            print("parity ntt 2^13 x5 inverse=%d coset=%d exact  plain "
                  "%.3f ms" % (inverse, coset, pms))
    plan, v, err, pms = ntt_case(1 << 16, 8, False, True)
    runs["ntt"] = (lambda: N.ntt_cuda(plan, v, False, True), 10)
    py_ms = launch_ms(runs["ntt"][0], 10)
    size, batch = 1 << 16, 8
    muls = batch * (size // 2 * 16 + size)      # butterflies + pre-scale
    nbytes = 32 * (2 * batch * size + size // 2 + size)
    record("ntt", "distributed_plonk_tpu_torch/csrc/ntt.cu",
           "distributed_plonk_tpu/backend/ntt_pallas.py:341", err, py_ms, pms,
           nbytes, muls * FR_MUL_IMADS, "coset fwd (8, 8, 65536)")

    # K3 and the K4 tail: the commit key (n + 3 powers padded to 8,224
    # points) shifted into its 37 windows (304,288 points), one round-1
    # batch of 5 handles of width n + 2
    ck = kzg.pad_commit_key(srs.powers_of_g1, n + 3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ctx = M.MsmContext(ck, dev)
    torch.cuda.synchronize()
    key_s = time.perf_counter() - t
    P = ctx.key.shape[0]
    print("shifted key: %d points (%d windows x %d bases, %.1f MB "
          "point-major), built in %.3f s (host upload, %d doublings and one "
          "batch inversion)" % (P, ctx.windows, ctx.n, P * 96 / 1e6, key_s,
                                ctx.c * (ctx.windows - 1)), flush=True)
    B, nb = 5, ctx.n_buckets
    hv = ctx.stack([lift([rng.randrange(R_MOD) for _ in range(n + 2)], dev)
                    for _ in range(B)])
    inf = ctx.inf
    elems = B * P                       # (handle, shifted point) pairs

    def digits():
        return M.msm_digits_cuda(hv, inf, ctx.c, ctx.signed, True)

    got = digits()
    want, pms = plain_ms(lambda: M.msm_digits_ref(hv, inf, ctx.c,
                                                  ctx.signed, True))
    err = max_abs_err(got, want)
    runs["msm_digits"] = (digits, 20)
    record("msm_digits", "distributed_plonk_tpu_torch/csrc/msm_bucket.cu",
           "distributed_plonk_tpu/backend/msm_pallas.py:201", err,
           launch_ms(digits, 20), pms, 32 * B * ctx.n + ctx.n + 8 * elems,
           B * ctx.n * FR_MUL_IMADS, "(8, %d, %d) -> 2 x (%d, %d, %d)"
           % (B, ctx.n, B, ctx.windows, ctx.n))
    ops, keys = got

    # the stable sort and boundaries: index bookkeeping in torch, timed
    # beside the kernels (graph time in phase 4)
    def sort_plan():
        return M._plan(keys, B, nb)

    runs["sort"] = (sort_plan, 20)
    print("sort %d keys (torch.sort stable, searchsorted, cumsum): launched "
          "from Python %.4f ms" % (elems, launch_ms(sort_plan, 20)),
          flush=True)
    _, count_start, chunk_start = sort_plan()
    adds = int(count_start[-1].item())
    chunks = int(chunk_start[-1].item())
    full = int(((count_start[1:] - count_start[:-1]) > 0).sum().item())

    def sums():
        return M.bucket_sums_cuda(ctx.key, ops, keys, B, nb)

    got = sums()
    want, pms = plain_ms(lambda: M.bucket_sums_ref(ctx.key, ops, keys, B,
                                                   nb))
    err = max_abs_err(got, want)
    runs["bucket_sums"] = (sums, 5)
    record("bucket_sums", "distributed_plonk_tpu_torch/csrc/msm_bucket.cu",
           "distributed_plonk_tpu/backend/msm_pallas.py:201", err,
           launch_ms(sums, 5), pms, 96 * P + 8 * elems + 3 * 48 * B * nb,
           (11 * adds + 12 * (chunks - full)) * FQ_MUL_IMADS,
           "%d lanes x %d shifted pts" % (B, P))
    print("bucket_sums: %d of %d (handle, point) pairs added in %d chunks "
          "of <= %d; %d tree adds over %d non-empty of %d buckets"
          % (adds, elems, chunks, M.CHUNK, chunks - full, full, B * nb))
    bsums = got

    def tail():
        return M.msm_tail_cuda(*bsums, signed=ctx.signed)

    got = tail()
    want, pms = plain_ms(lambda: M.msm_tail_ref(*bsums, signed=ctx.signed))
    err = max_abs_err(got, want)
    runs["msm_tail"] = (tail, 20)
    S, L = M.tail_shape(nb)
    tail_adds = B * (2 * S * (L - 1) + 2 * (S - 2) + (L.bit_length() - 1)
                     + (S - 1) + 1)
    record("msm_tail", "distributed_plonk_tpu_torch/csrc/curve_add.cu",
           "distributed_plonk_tpu/backend/curve_pallas.py:289", err,
           launch_ms(tail, 20), pms, 3 * 48 * B * (nb + 1),
           tail_adds * 12 * FQ_MUL_IMADS,
           "(12, %d, %d) -> (12, %d)" % (B, nb, B))

    # K4 elementwise: P + P on the key's bases (the key build's launch,
    # 8,224 lanes), and full and mixed adds at a wide batch
    # (189,440 lanes) and at 370 lanes
    kx, ky = ctx.key[:, :12].t(), ctx.key[:, 12:].t()

    def proj(a, b):
        pt = CT.from_affine(kx[:, a:b].contiguous(), ky[:, a:b].contiguous(),
                            torch.zeros(b - a, dtype=torch.bool, device=dev))
        return tuple(c.contiguous() for c in pt)

    base = proj(0, ctx.n)
    out = CT._add_cuda(base, base)
    want, pms = plain_ms(lambda: CT.proj_add_ref(base, base))
    err = max_abs_err(out, want)
    runs["proj_add"] = (lambda: CT._add_cuda(base, base), 50)
    record("proj_add", "distributed_plonk_tpu_torch/csrc/curve_add.cu",
           "distributed_plonk_tpu/backend/curve_pallas.py:289", err,
           launch_ms(runs["proj_add"][0], 50), pms, 9 * 48 * ctx.n,
           ctx.n * 12 * FQ_MUL_IMADS, "full P + P (12, %d)" % ctx.n)
    wide = 189440
    p = proj(0, wide)
    q = CT._add_cuda(p, proj(P - wide, P))          # general Z
    out = CT._add_cuda(p, q)
    want, pms = plain_ms(lambda: CT.proj_add_ref(p, q))
    assert max_abs_err(out, want) == 0
    runs["proj_add fold width"] = (lambda: CT._add_cuda(p, q), 10)
    print("parity proj_add full (12, %d) exact  launched from Python %.4f "
          "ms  plain %.3f ms  bound %.4f ms (operations)"
          % (wide, launch_ms(runs["proj_add fold width"][0], 10), pms,
             bound_ms(9 * 48 * wide, wide * 12 * FQ_MUL_IMADS)))
    p2 = tuple(c[:, :370].contiguous() for c in p)
    q2 = tuple(c[:, 370:740].contiguous() for c in q)
    assert max_abs_err(CT._add_cuda(p2, q2), CT.proj_add_ref(p2, q2)) == 0
    affine = (kx[:, 1000:1370].contiguous(), ky[:, 1000:1370].contiguous())
    assert max_abs_err(CT._add_cuda(p2, affine),
                       CT.proj_add_mixed_ref(p2, affine)) == 0
    print("parity proj_add full (12, 370) and mixed (12, 370): exact")
    done("kernel parity", t0)

    # --- 3. full-width prove ----------------------------------------------------
    t0 = phase("prove")
    with open(FIXTURE) as f:
        golden = bytes.fromhex(f.read().strip())
    be = TorchBackend()
    _build.reset_launches()
    t = time.perf_counter()
    pk, vk = kzg.preprocess(srs, ckt, be)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t
    pre_launches = dict(_build.LAUNCHES)
    # preprocess builds the shifted key: the elementwise add's main path
    assert pre_launches["proj_add"] > 0, \
        "proj_add never launched in preprocess"
    tr_cold = Tracer()
    t = time.perf_counter()
    proof = prove(random.Random(1), ckt, pk, be, tracer=tr_cold)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    assert proof_io.serialize_proof(proof) == golden, "cold proof bytes"

    _build.reset_launches()
    tr_warm = Tracer()
    t = time.perf_counter()
    proof = prove(random.Random(1), ckt, pk, be, tracer=tr_warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    blob = proof_io.serialize_proof(proof)
    assert blob == golden, "warm proof bytes differ from the fixture"
    t = time.perf_counter()
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(2))
    verify_s = time.perf_counter() - t
    for name in ("mont_mul", "ntt", "msm_digits", "bucket_sums", "msm_tail"):
        assert launches[name] > 0, \
            "kernel %s never launched in the warm prove" % name
        kernels[name]["launches"] = launches[name]
        kernels[name]["launches_in"] = "warm prove"
    # one digit decode, accumulation and tail per commit batch (wires,
    # permutation, quotient splits, openings), and no elementwise add
    batches = sum(1 for k in tr_warm.totals(1) if k.startswith("commit"))
    assert batches == 4, tr_warm.totals(1)
    for name in ("msm_digits", "bucket_sums", "msm_tail"):
        assert launches[name] == batches, (name, launches[name], batches)
    assert launches["proj_add"] == 0, launches
    kernels["proj_add"]["launches"] = pre_launches["proj_add"]
    kernels["proj_add"]["launches_in"] = "preprocess"
    print("proof bytes == tests/fixtures/proof_merkle_h32_p1.hex (%d bytes); "
          "verify ok in %.3f s" % (len(blob), verify_s))
    print("preprocess %.3f s; cold prove %.3f s; warm prove %.3f s"
          % (pre_s, cold_s, warm_s))
    print("rounds cold: " + json.dumps(
        {k: round(v, 4) for k, v in tr_cold.totals(0).items()}))
    print("rounds warm: " + json.dumps(
        {k: round(v, 4) for k, v in tr_warm.totals(0).items()}))
    print("spans warm: " + json.dumps(
        {k: round(v, 4) for k, v in tr_warm.totals(1).items()}))
    print("launches in preprocess: " + json.dumps(pre_launches))
    print("launches in the warm prove: " + json.dumps(launches))
    print("peak device memory %.1f MiB"
          % (torch.cuda.max_memory_allocated() / 2**20))
    done("prove", t0)

    # --- 4. device time, after the counters were read and the proves timed:
    # torch.profiler, then CUDA graphs (captured last, so that no capture
    # precedes a timing of calls from Python)
    t0 = phase("profile")
    profile_kernels(runs)
    profile_prove(lambda: prove(random.Random(1), ckt, pk, be))
    graph_kernels(runs, kernels)
    done("profile", t0)

    assert all(k["ms"] is not None for k in kernels.values()), kernels
    print(json.dumps({"kernels": [kernels[k] for k in (
        "mont_mul", "ntt", "msm_digits", "bucket_sums", "msm_tail",
        "proj_add")]}))
    # count: the cards this run used
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
