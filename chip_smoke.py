"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. Set-up: the card's name and power limit (nvidia-smi), the kernels'
   build from csrc/ (nvcc, all sources in parallel), and, while nvcc
   runs, the reference v1 circuit and its host SRS (tau = 0xDEADBEEF),
   phase 8's v2 circuit and phase 10's zoo circuits, and, in child
   processes, phase 10's CPU proves (zoo_cpu_child) and phase 17's host
   half of the static verifier (analysis_cpu_child).
2. Kernel parity: each kernel entry against its plain torch version on
   the card, on seeded inputs at the main path's shapes, with tolerance 0
   (every value is an integer in canonical form, every addition in a
   fixed order), each timed as calls from Python ("launch_ms", host path
   included) beside its plain version and its bound. The Montgomery
   product also runs on broadcast, sliced and two-axis operands (one
   launch and no copy under the profiler), and its call path from Python
   is timed piece by piece; the NTT runs every mode at n = 2, 32, 512,
   2^13 and 2^16 and is timed at round 3's batch of 25. The MSM entries
   (msm_digits, bucket_sums, msm_tail) run one round-1 commit batch, 5
   handles of width n + 2 over the commit key's window-shifted copy
   (304,288 points), whose build time is printed with the sort's; then
   kernel 4's window finish (msm_finish) on the same batch over the
   base layout of the key (one lane per handle and window: 5 x 37 lanes
   of 64 buckets, the round-1 batch shape of v1 and v2), against
   msm_finish_ref and, as points, against the shifted key's totals, with
   its kernels' registers and spills and each kernel's profiler time;
   then msm_finish at 1 and 33 handles, on identity sums and at unsigned
   c = 4 (64 windows over 64 points), each against its plain version. Round
   3's folds (csrc/round3.cu: r3_gate_fold, r3_sigma_fold, r3_combine)
   against their plain versions on seeded words with the corners 0, 1
   and r - 1, at v1's shapes (13 selector planes, 5 sigma planes, the
   combine, all at 2^16 lanes) and v2's (4 planes at 2^21 from selector
   4, 4 from sigma 0, the combine at 2^21), each timed beside its
   plain version and its bound. Round 4's evaluation (csrc/eval.cu,
   kernel 8: poly_eval) against poly_eval_ref, the path round 4 took
   before it (its products on kernel 1), on seeded words with the corners
   and the points 0 and 1, at v1's round 4 (8, 10, 8,195), v2's (8, 10,
   262,147), 2^20's (8, 10, 1,048,579) and a v1 fleet worker's EVAL (8,
   1, 2,049), each at prover_torch.eval_geometry's split for this card
   (CTAs a polynomial, coefficients a lane), exact, timed beside its
   plain version and its bound, with the nodes of a CUDA graph of its
   calls (one kernel a call: no fill, no copy), the device kernels a call
   as torch.profiler counts them where a session recorded every call,
   and their profiler us; then its registers and spills (none).
3. Full-width prove: the height-32 Rescue Merkle membership circuit
   (n = 2^13, quotient domain 2^16) preprocessed and proven on
   TorchBackend() cold, then proven again warm; both proofs must equal
   tests/fixtures/proof_merkle_h32_p1.hex byte for byte and verify. The
   launch counters are zeroed just before preprocess and read just after
   it (the elementwise add builds the shifted key there), then zeroed
   before the warm prove and read after it: every other kernel must have
   launched there, the MSM entries once per commit batch, the NTT at most
   3 launches per call, each round-3 fold once (the fused round 3: 13
   selectors and 5 sigmas in one batch each at m = 2^16), poly_eval once
   (round 4's ten evaluations; round 4's seconds and the prove's
   mont_mul launches are printed beside it), and the elementwise add not
   at all. Then the same keys proved on
   TorchBackend(msm_layout="base"), cold and warm: both proofs equal the
   fixture; the warm prove launches msm_finish once per commit batch,
   msm_tail never, and every other kernel as often as above.
4. Device SRS: universal_setup_device(n + 2) (the fixed-base walk: 32
   mixed-add launches of kernel 4, then kernel 1) equals the host SRS of
   phase 1 power for power; the workload preprocessed from it has the
   host path's vk, and its cold and warm proves equal the fixture.
5. Round 3: a warm prove through the fused round 3 (the default:
   quotient_poly_streamed, one kernel per fold), one with
   quotient_poly_streamed set to None on the backend (the streamed round
   3, the unfused steps) and one with both hooks None (one-shot), each
   equal to the fixture, with round 3's seconds (the device drained at
   its end) and its peak device memory above the resident (the fused
   no higher than the streamed), the round-3 folds launched only on the
   fused path; five pairs of warm proves, fused and streamed in ABBA
   order (r3_ab: the medians of the prove's and of round 3's seconds);
   then one warm prove under CUDA's sync debug mode: the host
   synchronisations per round and the call chains in the port that make
   them.
6. Checkpoint: for k = 1..4 a prove stopped right after saving round k
   resumes in the same process to the fixture and removes its file; the
   snapshot sizes and the dump, write, load and restore seconds.
7. Batched and pipelined: four members (prove rngs Random(1..4)) through
   sequential prove, prove_many and prove_pipelined at depths 1, 2 and 4:
   the same bytes per member, member 0 the fixture, all verify; proofs
   per second for each driver.
8. v2, the reference's 2^18 workload at full size (50 Merkle proofs,
   n = 2^18, quotient domain 2^21): the device SRS of 2^18 + 3 powers,
   preprocess, a cold and a warm prove (the fused round 3: 4 gate-fold,
   2 sigma-fold and 1 combine launches; round 4 one poly_eval launch,
   its seconds and the prove's mont_mul launches printed) and one each
   with the streamed and the one-shot round 3 (all four identical, round
   3's peak memory fused no higher than streamed), verify, per-round
   spans and peak
   device memory; five pairs of warm proves, fused and streamed in ABBA
   order (r3_ab); a round-1 batch of 5 handles over the base layout of
   v2's device key, equal to the shifted key's commitments.
8b. Scale scripts (scale_script_checks): scripts/torch_scale_run.py's
   function on v1 (device SRS, preprocess, cold and warm prove, verify)
   and scripts/torch_kernel_bench.py's at 2^16 (the mont_mul chains, the
   NTT, the MSM over 2^11 tiled bases on both key layouts: the same
   point, each meeting the tiling identity), the launch counters read
   around each.
9. Mesh, four shards on this card (make_mesh(4): one process, every
   shard's kernels on the card): dryrun_multichip(4) (a mesh iNTT and
   coset NTT, an MSM and a tiny prove against their oracles, the prove
   again with every handle sharded); MeshNttPlan at 2^16 in all four
   modes and at 2^21 forward and inverse, whole in and out, equal to the
   single-card ntt (and to its plain version at 2^16), graph-timed beside
   it in the last phase; the two mesh scale scripts' functions
   (mesh_scale_checks): scripts/torch_mesh_ntt_scale.py's 2^21 coset NTT
   and its inverse on sharded handles (the round trip exact, the forward
   output equal to the single-card ntt, both graph-timed in the last
   phase) and scripts/torch_mesh_prove_scale.py's v1 prove on
   MeshBackend (equal to the fixture, every handle sharded, each shard's
   live bytes at round 3's quotient within the memory plan);
   MeshMsmContext over v2's device key equal to
   TorchBackend.commit_many_h (kernel 3 on each shard, the planes folded
   by kernel 4: the launches per batch are checked), and kernel 4 at the
   fold's shape against its plain version; then the v2 prove on
   MeshBackend, its handles in lane shards, cold and warm, with phase 8's
   prove rng: the bytes equal phase 8's proof and verify, every NTT at n
   and m and all 13 commitments are counted on the mesh path and every
   handle of n, n + 2, n + 3 and m lanes as sharded, with per-round
   seconds, peak device memory above the resident and round 3's peak
   beside the sharded memory plan, the unsharded mesh's 8,000.5 MiB and
   the single card's one-shot 4,808.0 MiB, the launches and the idle
   share.
10. Zoo: every kind of circuits/ builds (the rollup at height 16 with 8
   updates, n = 2^16; in the set-up); range (8 bits x 2) and preimage
   (x 1) prove on the card and on TorchBackend(device="cpu") (the set-up's
   child process) to the same bytes; the rollup
   proves cold and warm on TorchBackend and on MeshBackend(make_mesh(4))
   to the same bytes; every proof verifies.
11. Fleet: (a) the sharded 4-step FFT's stage panels (kernels 1 and 2
   over each FFT1 row panel and FFT2 column panel of a 4-worker plan)
   against their plain versions in all four modes at 2^16 and 2^21; then,
   in a child process (phase_child "fleet", beside phases 12 and 13), the
   v1 keys preprocessed there from the device SRS (the parent's vk) and
   four port workers (runtime/worker.py, one process and CUDA context each on
   this card) behind the port's Dispatcher: every worker reports backend
   torch on CUDA; fft_dist of one 2^21 vector, coset forward and coset
   inverse, equals the single-card ntt; a fleet MSM over v2's commit key
   (2^18 + 3 powers) equals TorchBackend.commit_many_h; the v1 proof
   through RemoteBackend with every NTT sharded and with whole NTTs
   round-robin equals the fixture and verifies, with its per-round
   seconds, the workers' span seconds, the requests each worker served
   (every worker must serve MSM and EVAL in both proves, FFT1 and FFT2
   in the sharded one, NTT in the other) and the kernel launches per
   fleet prove (every worker launches poly_eval: one a round-4 EVAL).
   Then the observability plane over the same workers: a
   third, sharded v1 fleet prove (equal to the fixture) with a PROFILE
   capture of worker 0 armed over it (torch.profiler on the card, after
   a 50 ms capture that pays the profiler's start-up), whose gzipped
   Chrome trace must name kernels of all four ports (K1 mont_mul_kernel,
   K2 ntt_pass_kernel, K3 digits/chunk/tree_kernel, K4 msm_tail or
   add_*_kernel); a METRICS_FETCH scrape of the four workers (served_*,
   worker_*_s, and mfu_* gauges against this card's peak, each in
   (0, 100]); a LOG_FETCH. A worker that exits, an ERR reply from a
   worker (the dispatcher raises it), or any recovery by the dispatcher
   (a reconnect, an adopted range, a rerouted NTT or evaluation, a
   replan, a quarantine), fails the phase.
12. Elastic (elastic_checks, in a child process: phase_child "elastic",
   beside phase 11's child and phase 13): the v1 workload through
   RemoteBackend over port workers spawned on this card by the port's
   WorkerSupervisor and joined through the dispatcher's membership
   server: slot 0's store is
   provisioned by scripts/torch_warmup.py --aot in a child process (the
   v1 bucket's keys and the kernel build's `kbuild:` artifact); two
   workers; two more JOIN (the epoch rises, the sharded FFT plans over
   4); worker 1 SIGKILLed at its first FFT1 by the proc fault plane
   under a ProofService job proving through the fleet (the dispatcher
   traced; the job submitted inside a client Tracer's span with that
   tracer's context(), which the service adopts), respawned on an empty
   store and an empty build directory and
   rejoined at its index (heal seconds), having pulled the kernel build
   and the bucket from slot 0's store with no nvcc run (HEALTH `build`:
   source peer, nvcc_s null; it launches K1-K4 in step 4); the incident
   read off one artifact, merge_fleet_trace (the job's spans and the
   fleet's, the dispatcher's, supervisor's and workers' log events under
   the job's trace id, which is the client's, with the pool's spans
   parented to the client's span), also over HTTP at /trace/<job_id>; a
   fifth
   worker whose first process lies about its MSM partials, caught by
   duplicate execution,
   quarantined, LEAVEd and replaced by a clean process that passes the
   known-answer challenge, while a standing liar fails it; then a
   ProofService proving through a fresh one-worker fleet with the
   actuating autoscaler: three v1 jobs scale it up and, served, equal
   their direct proves; then the service attaches the fleet
   (attach_fleet), serves /fleet over HTTP, and the autoscaler's mfu_pct
   sensor reads the workers' mean kernel share, in (0, 100]; idle, it
   retires back to one worker. Every fleet prove equals the fixture and
   every job its direct prove; every worker of a step launches every
   kernel of the path (HEALTH `launches`).
13. Service: the port's ProofService on this card over TCP (a
   ServiceClient), with two pool workers, a store, a journal, chaos on
   and four slots of cuda:0 (so the mesh class leases a 2-slot submesh):
   a rollup job (height 16, 8 updates, seed 3: the pool class), then,
   once the scheduler is
   building its keys, four v1 jobs (seeds 11-14: one prove_many batch)
   and the v2 job (seed 11: the mesh class); every job done, its RESULT
   bytes equal to a direct prove on phase 3's, the zoo's and phase 8's
   warm backends and verifying under the bucket's vk (which equals those
   phases' vk); AGGREGATE of the v1 jobs, fetched and verified; METRICS
   (3 key builds, the placements, no retry); a kill at round 2 that
   resumes to the uninterrupted bytes; a second service crashed at a v1
   job's journal ROUND2 (the job submitted with a fixed trace context)
   and a third one restarted on the same store and journal: finished
   jobs served from their artifacts, the crashed one resumed from its
   store checkpoint without round 1 under the context's trace id and
   parent, its stored trace chaining up to the context's parent, its
   keys loaded from disk. While the first service is up,
   scripts/torch_loadgen.py --host/--port drives it from a child process
   (loadgen_checks): the v1 job and two toy jobs, and the KILL_WORKER
   target, every proof verified on keys the child builds on the card,
   the kill seen as a retry, per-kind p50/p95 seconds printed; the
   restarted services recover its
   finished jobs too. Every kernel entry must launch in the phase; per-job wait
   and run seconds, key-build seconds, each step's seconds and the phase's
   peak memory are printed beside the card's name and power limit. The
   PING and the two WARMUPs moved to 13b.
13b. Daemon (daemon_checks): `python -m distributed_plonk_tpu_torch.service
   --port 0 --obs-port 0 --store-dir --journal-dir --build-dir (this run's
   build: no second nvcc) --autoscale dry` as a child: its start line
   names cuda:0 and the dry mode; PING; WARMUP of v1 twice (built, then
   memory); one v1 job over TCP whose bytes equal its direct prove on
   phase 3's warm backend and verify, and which launched every kernel
   entry of the path in the daemon's process (METRICS' launch counters
   read just before and just after it); /autoscale shows mode dry, ticks
   and no decision applied (no actuation counter in METRICS, whose build
   record says the kernels came from the build directory);
   scripts/console.py --obs --once --logs 5 (the standard-library console,
   which serves either package's daemon) exits 0 and prints the service's
   readiness; SIGTERM drains it and it exits 0.
   Then the fleet and elastic children are joined: their lines are
   printed, each prefixed with its name; a child that exits non-zero,
   writes no result or outlives CHILD_LIMIT_S fails the run.
14. Observe and calibrate: the card's own integer peak (SMs x 64 IMAD
   per clock x the maximum SM clock nvidia-smi reports); a traced warm
   prove of v1 and of v2, whose kernel events fold into the
   kernel_<stage>_gflops / mfu_<stage>_pct gauges (Metrics.
   observe_kernels), each of the 7 stages present (round 3's coset FFTs,
   folds and coset iNTT in quotient_stream_fused) and each share in
   (0, 100]; then store/calibration.load_or_run(mode="run") on a fresh
   store at n = 2^13: the NTT cell at 2^16 (kernel 2's pass split and
   tile) and the MSM cell at 2^13 (kernel 3's chunk over one prove's
   commit batches of 5, 1, 5 and 2 handles), each winner beside the
   default's time and every measured candidate; a second start loads the
   plan with 0 measurement runs; the v1 proof under the plan equals the
   fixture. The plan is cleared at the end of the phase.
15. Device time: torch.profiler's CUDA kernel times for one launch of
   each kernel at its parity shape, and for one more warm prove of the
   2^13 and of the v2 workload (device busy time by kernel and the idle
   share; "not measured" if the profiler records no CUDA events), and
   round 3 alone on a warm prove's operands at v1 and v2, fused against
   streamed (equal outputs; CUDA-event ms, device busy ms and kernel
   launches by name); then
   each kernel's "ms", its device time: CUDA events around the replay of
   a CUDA graph of its launches, the same for the stage panels of phase
   11 and the mesh NTTs of phase 9, each beside the single-card ntt of
   the whole vector, and kernel 4 at the mesh fold's shape.
16. Multi-process mesh (multihost_checks): two child processes on this
   card join one gloo group (parallel/mesh.init_multihost, 2 shards
   each), after each has seen an NCCL group of the two refused at init
   (one card); as one program they run (a) MeshNttPlan at 2^16 and 2^21
   in all four modes and MeshMsmContext over v2's device key (2^18 + 3
   powers, a round-1 batch of 5 handles), each equal to the single card
   (the NTTs by digest against the parent's single-card NTTs of the same
   seeded inputs, the MSM in the child), (b) the v1 workload on
   MeshBackend from the device SRS (the parent's circuit, pickled), every
   handle in lane shards over the two ranks: preprocess, a cold and a
   warm prove equal to the fixture, verify, with the path and handle
   counters, per-round seconds, peak memory above the resident beside
   memory_plan's per-process figure, and the collectives' bytes and
   seconds per call (no whole NTT output is all-gathered: the prove's
   all-gathers carry less than one n-lane handle).
   Both ranks must report the same values and launch K1-K4. Meanwhile
   this process runs (c): a one-process NCCL group's 2-shard mesh NTT at
   2^16, its collectives on device tensors, equal to the single card.
17. Analysis (analysis_checks): the static verifier. Its host half
   (`python -m distributed_plonk_tpu_torch.analysis --strict --device
   cpu`: lints, carry contracts, aten-graph bounds and exact values of
   every registry entry) and its seeded mutants ran in the set-up's child
   and must be clean, every mutant rejected. Here
   `registry.run_values(device="cuda")` holds every entry that has a
   kernel to its value contract on the card: kernel 1 (Fr and Fq, plain,
   broadcast and strided, to_mont, from_mont), kernel 2 (all four modes
   in 1-3 passes), kernel 3's msm_digits, and one main-path shape each
   (kernel 1 at 2^16 lanes, kernel 2 at n = 2^13 in each mode,
   msm_digits over a round-1 batch of 5 handles of width n + 2), round
   3's three folds at 8 and at 2^12 lanes, kernel 4's msm_finish at 2
   windows of c = 1 and over a round-1 batch on the base layout, and
   kernel 8's poly_eval at 20 and 66 coefficients, through
   poly_eval_many, and at v1's round 4 (10 polynomials of 8,195); the
   eight must launch. Each kernel record gains `analysis_entries`.

In every phase that drives the port, the launch counters are zeroed just
before the run and read just after it, and every kernel of that path must
have launched there; a fleet worker's counters are read over its HEALTH
reply before and after each run, and every worker must have launched
every kernel of the run's path. Phase 2 also holds kernel 4's mixed add at the
fixed-base walk's width (2^18 + 3 lanes) against its plain version.

Imports only the port, torch and the standard library. The last
line is {"ok": true, "device": {...}}; without a card it exits non-zero
before printing any result.
"""

import collections
import concurrent.futures
import contextlib
import functools
import gc
import hashlib
import json
import os
import pickle
import random
import re
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import torch

from distributed_plonk_tpu_torch.trace import (FQ_MUL_IMADS, FR_MUL_IMADS,
                                               IMAD_PER_SM_CLOCK, Tracer)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "proof_merkle_h32_p1.hex")
# the reference's v2 workload (50 Merkle proofs, n = 2^18): its SRS powers
V2_POWERS = (1 << 18) + 3

# H100 SXM peaks for the bound: HBM 3.35 TB/s (NVIDIA data sheet); 32-bit
# integer multiply-add, 64 per SM per clock on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput) x 132 SMs
# x 1.98 GHz boost clock. The work model (trace.py, shared with the live
# kernel gauges): a 32 x 32 -> 64-bit product is two multiply-adds (lo,
# hi), a Montgomery product FR_MUL_IMADS / FQ_MUL_IMADS; field additions
# and data movement are not counted.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * IMAD_PER_SM_CLOCK[(9, 0)] * 1.98e9


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
    """Milliseconds of fn() per call from Python (CUDA events around reps
    calls), the median of three windows after an untimed one: the device
    time plus the host's launch path (ctypes, allocation, checks) wherever
    that is the longer. A window that follows a pause of the card can run
    several times slower than the next ones (call_spread shows it), so one
    window alone does not measure the call path."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return sorted(_events_ms(lambda: [fn() for _ in range(reps)]) / reps
                  for _ in range(3))[1]


def graph_ms(fn, reps):
    """Mean device milliseconds of one fn(): reps calls captured in a CUDA
    graph, the graph replayed once untimed, then three times between CUDA
    events (the median), so the host's launch path is not in the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = sorted(_events_ms(graph.replay) / reps for _ in range(3))[1]
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


def _profiler(cpu=True):
    """torch.profiler over CUDA activity, and the CPU's unless cpu=False:
    every reader here takes the CUDA events only, and recording a warm
    prove's CPU ops adds seconds of processing and no kernel row."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if cpu else []))


def graph_kernels(runs, kernels):
    """Each kernel's device time at its parity shape from a CUDA graph of
    its launches, into kernels[name]["ms"] where it has a record (a run
    named "<kernel> <label>": into that record's `label` shape)."""
    for name, (fn, reps) in runs.items():
        ms = graph_ms(fn, reps)
        print("graph time  %-20s %.4f ms per call" % (name, ms))
        base, _, shape = name.partition(" ")
        if name in kernels:
            kernels[name]["ms"] = ms
        elif base in kernels and shape in kernels[base]:
            kernels[base][shape]["ms"] = ms


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


def profile_prove(fn, label="warm prove"):
    """Device busy time of one warm prove, by kernel, and its idle share."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _profiler(cpu=False) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = _device_kernels(prof)
    if not rows:
        print("profiled %s: device time not measured" % label)
        return
    busy = sum(r[2] for r in rows) / 1e6
    print("profiled %s: wall %.4f s (profiler on), device busy "
          "%.4f s, idle share %.3f; %.1f s with the profiler's start and "
          "its event processing" % (label, wall, busy, 1 - busy / wall,
                                    time.perf_counter() - t0))
    for key, count, us in rows[:15]:
        print("  %-60s %6d launches %10.1f us" % (key[:60], count, us))
    copies = [(c, us) for k, c, us in rows if "Memcpy DtoD" in k]
    print("device-to-device copies in the profiled warm prove: %d, %.1f us"
          % (sum(c for c, _ in copies), sum(us for _, us in copies)))


def r3_ab(be, ckt, pk, want, label, pairs=5):
    """Warm proves of one workload alternating the fused and the streamed
    round 3 (quotient_poly_streamed set to None on the backend), in ABBA
    order over `pairs` pairs, each equal to `want`: every prove's seconds
    and its round3 span's (a host synchronisation ends each prove), and
    their medians."""
    from distributed_plonk_tpu_torch import proof_io
    from distributed_plonk_tpu_torch.prover import prove
    secs = {"fused": [], "streamed": []}
    r3 = {"fused": [], "streamed": []}
    for i in range(pairs):
        for name in (("fused", "streamed") if i % 2 == 0
                     else ("streamed", "fused")):
            if name == "streamed":
                be.quotient_poly_streamed = None
            try:
                tr = Tracer()
                t = time.perf_counter()
                proof = prove(random.Random(1), ckt, pk, be, tracer=tr)
                sync()
                secs[name].append(time.perf_counter() - t)
            finally:
                be.__dict__.pop("quotient_poly_streamed", None)
            r3[name].append(tr.totals(0)["round3"])
            assert proof_io.serialize_proof(proof) == want, (label, name)
    med = {k: (sorted(v)[len(v) // 2], sorted(r3[k])[len(v) // 2])
           for k, v in secs.items()}
    print("%s warm proves, %d pairs in ABBA order, each equal to its "
          "reference bytes: median prove / round3 seconds fused %.4f / "
          "%.4f, streamed %.4f / %.4f; prove seconds %s; round3 seconds %s"
          % (label, pairs, med["fused"][0], med["fused"][1],
             med["streamed"][0], med["streamed"][1],
             json.dumps({k: [round(x, 4) for x in v]
                         for k, v in secs.items()}),
             json.dumps({k: [round(x, 4) for x in v]
                         for k, v in r3.items()})), flush=True)
    return med


def round3_profile(be, ckt, pk, label):
    """Round 3 alone, fused (quotient_poly_streamed) against streamed
    (quotient_streamed, then the coset iNTT: every prove's path before the
    fused one), on the operands of a warm prove's round 3: equal outputs,
    CUDA-event milliseconds (median of three) and, under torch.profiler,
    device busy milliseconds and kernel launches by name."""
    from distributed_plonk_tpu_torch.prover import prove
    box = []
    fused = be.quotient_poly_streamed

    def spy(*args):
        box.append(args)
        return fused(*args)
    be.quotient_poly_streamed = spy
    try:
        prove(random.Random(1), ckt, pk, be)
    finally:
        del be.quotient_poly_streamed
    args = box[0]
    paths = {"fused": lambda: be.quotient_poly_streamed(*args),
             "streamed": lambda: be.coset_ifft_h(
                 args[2], be.quotient_streamed(*args))}
    assert torch.equal(paths["fused"](), paths["streamed"]()), label
    out = {}
    for name, fn in paths.items():
        ms = sorted(_events_ms(fn) for _ in range(3))[1]
        sync()
        with _profiler() as prof:
            fn()
            sync()
        rows = _device_kernels(prof)
        rec = {"ms": ms, "busy_ms": sum(r[2] for r in rows) / 1e3 if rows
               else None, "launches": sum(r[1] for r in rows) if rows
               else None}
        out[name] = rec
        print("%s round 3 alone, %s: %.4f ms (CUDA events); profiled: "
              "device busy %s ms over %s kernel launches" % (
                  label, name, ms, rec["busy_ms"], rec["launches"]))
        for key, count, us in rows[:8]:
            print("  %-60s %6d launches %10.1f us" % (key[:60], count, us))
    print("%s round 3 alone: %s" % (label, json.dumps(out)), flush=True)
    return out


def ptxas_report(log):
    """(kernel, registers line, spill line) for each entry function that
    `nvcc -Xptxas -v` reported."""
    out, fn, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append((fn, line.split(":", 1)[-1].strip(), spill))
    return out


# phase 2's full adds by width (lanes, repeats): the mesh fold's 320 lanes,
# the v1 key build's 8,224 (its launch: 7 doublings), 16,384 past the
# switch of bodies (curve_torch.COOP_MAX_LANES), phase 2's wide check of
# 189,440, and the v2 and 2^20 keys' widths; each exact against its plain
# version up to PROJ_ADD_CHECK_MAX lanes, timed only above
PROJ_ADD_ROWS = ((320, 1), (8224, 1), (8224, 7), (16384, 1), (16384, 7),
                 (189440, 1), (1 << 18, 1), (1 << 18, 7), (1 << 20, 1),
                 (1 << 20, 7))
PROJ_ADD_CHECK_MAX = 1 << 18
PROJ_ADD_KERNELS = {"coop": "add_coop_kernel", "thread": "add_full_kernel"}


def _profile_us(fns, calls=3, tries=3):
    """Profiler us a call of each body's kernel (PROJ_ADD_KERNELS), fns
    {body: one launch} run `calls` times each in one profiler session;
    a session that lost a body's events (the profiler can) is run again,
    up to `tries` sessions. Bodies it never saw are left out."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    us = {}
    for _ in range(tries):
        with _profiler(cpu=False) as prof:
            for fn in fns.values():
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        # per event: a session can also lose some of a kernel's events
        rows = _device_kernels(prof)
        for body in fns:
            hit = [u / c for k, c, u in rows if PROJ_ADD_KERNELS[body] in k]
            if hit and body not in us:
                us[body] = hit[0]
        if len(us) == len(fns):
            break
    return us


def proj_add_widths(base, rows=PROJ_ADD_ROWS):
    """Kernel 4's full add (curve_torch._add_cuda) by width, on points
    tiled from `base` (a projective (12, m) triple on the card): P + Q for
    reps 1 (Q = P_(i+1) + P_i, lanes 1-4 P = Q, P = -Q, Q and P the
    identity), else `reps` doublings of P in one launch; each of the two
    bodies (the cooperative one and the one thread a point) exact against
    the plain version up to PROJ_ADD_CHECK_MAX lanes, with its graph ms,
    launch ms and profiler us a call beside the bound; ptxas's registers
    and spills of both. Prints and returns the rows."""
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend import curve_torch as CT
    from distributed_plonk_tpu_torch.backend import field_torch as F
    for fn, regs, spill in ptxas_report(_build.build_log.get("curve", "")):
        if any(k in fn for k in PROJ_ADD_KERNELS.values()):
            print("proj_add ptxas %-40s %s; %s" % (fn[:40], regs, spill))
    dev, m = base[0].device, base[0].shape[1]
    out = []
    for lanes, reps in rows:
        idx = torch.arange(lanes, device=dev) % m
        p = [c.index_select(1, idx) for c in base]
        q = list(CT._add_cuda(tuple(p), tuple(
            c.index_select(1, (idx + 1) % m) for c in base)))
        if lanes >= 5:
            ident = CT.proj_inf((1,), dev)
            for k in range(3):
                q[k][:, 1] = p[k][:, 1]
                q[k][:, 3] = ident[k][:, 0]
                p[k][:, 4] = ident[k][:, 0]
            q[0][:, 2], q[2][:, 2] = p[0][:, 2], p[2][:, 2]
            q[1][:, 2:3] = F.sub(F.FQ, torch.zeros_like(p[1][:, 2:3]),
                                 p[1][:, 2:3])
        p, q = tuple(p), tuple(q)
        args = (p, q) if reps == 1 else (p, p, reps)
        nbytes = (9 if reps == 1 else 6) * 48 * lanes
        imads = lanes * reps * 12 * FQ_MUL_IMADS
        row = {"lanes": lanes, "reps": reps,
               "op": "P + Q" if reps == 1 else "%d doublings" % reps,
               "bound_ms": bound_ms(nbytes, imads),
               "bound_by": bound_by(nbytes, imads),
               "default": "coop" if lanes < CT.COOP_MAX_LANES else "thread",
               "exact": lanes <= PROJ_ADD_CHECK_MAX, "plain_ms": None}
        if row["exact"]:
            def plain():
                return CT.proj_add_ref(p, q) if reps == 1 else \
                    CT.proj_dbl_ref(p, reps)
            plain()
            torch.cuda.synchronize()
            t = time.perf_counter()
            want = plain()
            torch.cuda.synchronize()
            row["plain_ms"] = 1e3 * (time.perf_counter() - t)
        calls = 50 if lanes * reps <= 1 << 14 else (
            10 if lanes * reps <= 1 << 19 else 3)
        fns = {}
        for body, coop in (("coop", True), ("thread", False)):
            def fn(coop=coop):
                return CT._add_cuda(*args, coop=coop)
            got = fn()
            if row["exact"]:
                err = max_abs_err(got, want)
                assert err == 0, (lanes, reps, body, err)
            del got
            launch = launch_ms(fn, calls)
            ms = graph_ms(fn, calls)
            row[body] = {"ms": ms, "launch_ms": launch, "us": None,
                         "share": row["bound_ms"] / ms}
            fns[body] = fn
        for body, us in _profile_us(fns).items():
            row[body]["us"] = us
        print("proj_add %-12s %8d lanes: coop %.4f ms (launch %.4f, "
              "profiler %s us), thread %.4f ms (launch %.4f, profiler %s "
              "us), bound %.4f ms (%s), plain %s ms, %s, default %s" % (
                  row["op"], lanes, row["coop"]["ms"],
                  row["coop"]["launch_ms"], row["coop"]["us"],
                  row["thread"]["ms"], row["thread"]["launch_ms"],
                  row["thread"]["us"], row["bound_ms"], row["bound_by"],
                  "%.3f" % row["plain_ms"] if row["exact"] else "-",
                  "exact" if row["exact"] else "timed only",
                  row["default"]), flush=True)
        out.append(row)
        del p, q, args
        if row["exact"]:
            del want
    print("proj_add widths: " + json.dumps(out), flush=True)
    # the call path of the key build's launch (7 doublings, 8,224 lanes),
    # piece by piece in host us a call: the entry, each piece it runs, and
    # the pieces it no longer runs
    p = tuple(c.index_select(1, torch.arange(8224, device=dev) % m)
              for c in base)
    raw = _build.load()["curve"].dpt_proj_add
    o = tuple(torch.empty_like(p[0]) for _ in range(3))
    stream = F._stream(p[0])

    def ctx():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "entry proj_dbl": lambda: CT.proj_dbl(p, 7),
        "_same_shape": lambda: CT._same_shape(p),
        "_check_point": lambda: CT._check_point(p, p[0].shape, dev, "x"),
        "3 x torch.empty_like": lambda: [
            torch.empty_like(p[0]) for _ in range(3)],
        "_build.load() lookup": lambda: _build.load()["curve"],
        "bare ctypes launch": lambda: raw(
            *(c.data_ptr() for c in o + p + p), 8224, 7, 1, stream),
        "current_device": torch.cuda.current_device,
        "raw stream handle": lambda: F._stream(p[0]),
        "(gone) broadcast_tensors+contiguous": lambda: [
            c.contiguous() for c in torch.broadcast_tensors(*p)],
        "(gone) torch.cuda.device context": ctx,
    }
    print("call path proj_add (7 doublings, 8,224 lanes), host us per "
          "call: %s" % json.dumps({k: round(call_path_us(f, 200), 2)
                                   for k, f in pieces.items()}), flush=True)
    return out


def call_path_us(fn, reps):
    """Host microseconds per call of fn(), host clock over reps calls
    after a warm-up call, the device drained before and after."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) * 1e6 / reps
    torch.cuda.synchronize()
    return us


class GcPauses:
    """Python garbage collections (generation, ms) while the block runs."""

    def __enter__(self):
        self.pauses, self._t = [], {}
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase_, info):
        if phase_ == "start":
            self._t[info["generation"]] = time.perf_counter()
        else:
            t = self._t.pop(info["generation"], None)
            if t is not None:
                self.pauses.append((info["generation"],
                                    (time.perf_counter() - t) * 1e3))

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self):
        full = [ms for g, ms in self.pauses if g == 2]
        return "%d collections, %d full (%.2f ms)" % (
            len(self.pauses), len(full), sum(full))


def call_spread(fn, reps):
    """One entry's calls from Python, reps of them, run right after
    host-only work: the CUDA-event time per call of three windows in a row
    (one warm-up call before the first, as an earlier launch_ms took it)
    with the garbage collections each window saw, one more window with
    the collector off, one after 50 ms of host-only work and one after
    50 ms of device work, the card's SM clock, and the median and largest
    host time of one call."""
    out = {}
    fn()
    torch.cuda.synchronize()
    for i in range(3):
        with GcPauses() as pauses:
            ms = _events_ms(lambda: [fn() for _ in range(reps)]) / reps
        out["events ms #%d" % (i + 1)] = "%.4f (gc: %s)" % (ms,
                                                            pauses.summary())
    gc.collect()
    gc.disable()
    try:
        out["events ms, gc off"] = round(
            _events_ms(lambda: [fn() for _ in range(reps)]) / reps, 4)
    finally:
        gc.enable()
    # the same window after host-only work, then after ~50 ms of device
    # work: does the card's idle state, not the call path, set the time?
    for label, busy in (("after host-only work", False),
                        ("after device work", True)):
        x = torch.ones(2048, 2048, device="cuda")
        torch.cuda.synchronize()
        if busy:
            t = time.perf_counter()
            while time.perf_counter() - t < 0.05:
                x = x @ x * 1e-3
                torch.cuda.synchronize()
        else:
            t = time.perf_counter()
            while time.perf_counter() - t < 0.05:
                sum(range(1000))
        ms = _events_ms(lambda: [fn() for _ in range(reps)]) / reps
        out["events ms " + label] = round(ms, 4)
    out["sm clock now"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    each = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        each.append((time.perf_counter() - t) * 1e6)
    torch.cuda.synchronize()
    each.sort()
    out["host us median"] = round(each[len(each) // 2], 2)
    out["host us max"] = round(each[-1], 2)
    return out


# the four TPU kernels' entries on every prove's path (a fleet worker's,
# a mesh's, the streamed and one-shot round 3's), and the fused round 3's
# folds, on the path of every single-card TorchBackend prove
BASE_KERNELS = ("mont_mul", "ntt", "msm_digits", "bucket_sums", "msm_tail")
R3_KERNELS = ("r3_gate_fold", "r3_sigma_fold", "r3_combine")
# round 4's evaluation (kernel 8): on every single-card prove's path, on
# the mesh's (its whole and sharded handles) and on a fleet worker's EVAL
PATH_KERNELS = BASE_KERNELS + R3_KERNELS + ("poly_eval",)
# the fused round 3's launches per warm prove: v1 (m = 2^16) folds its 13
# selectors and 5 sigmas in one batch each; v2 (m = 2^21, 4 planes a
# batch) in 4 and 2
R3_LAUNCHES = {"v1": {"r3_gate_fold": 1, "r3_sigma_fold": 1,
                      "r3_combine": 1},
               "v2": {"r3_gate_fold": 4, "r3_sigma_fold": 2,
                      "r3_combine": 1}}
# the backend hooks set to None for the unfused round 3s
STREAMED_R3 = {"quotient_poly_streamed": None}
ONE_SHOT_R3 = {"quotient_poly_streamed": None, "quotient_streamed": None}


def read_launches(label, names=PATH_KERNELS):
    """The launch counters since the last reset: every kernel in `names`
    must have launched in the run they cover."""
    from distributed_plonk_tpu_torch.backend import _build
    launches = dict(_build.LAUNCHES)
    missing = [k for k in names if launches[k] == 0]
    assert not missing, (label, missing, launches)
    print("launches in %s: %s" % (label, json.dumps(launches)))
    return launches


def sync():
    torch.cuda.synchronize()


def peak_mib(mem0):
    """Peak device memory above `mem0` bytes since the last reset, MiB."""
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - mem0) / 2**20


def reset_peak():
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


class Round3Peak(Tracer):
    """A Tracer that also takes the device's peak memory above what was
    allocated when the prove's round3 span opened (peak_mib, MiB), the
    device drained at both ends of the span."""

    peak_mib = None

    @contextlib.contextmanager
    def span(self, name, parent=None, **attrs):
        if name != "round3":
            with super().span(name, parent=parent, **attrs) as sid:
                yield sid
            return
        mem0 = reset_peak()
        with super().span(name, parent=parent, **attrs) as sid:
            yield sid
            self.peak_mib = peak_mib(mem0)


class SyncCounter:
    """A tracer for prove(): the host synchronisations that CUDA's sync
    debug mode reports while each round's span is open (warnings appended
    to `caught`), and the call sites in the port that made them."""

    def __init__(self, caught):
        self.caught = caught
        self.per_round = {}
        self.depth = 0

    @contextlib.contextmanager
    def span(self, name, **attrs):
        depth, before = self.depth, len(self.caught)
        self.depth += 1
        try:
            yield
        finally:
            self.depth = depth
            if depth == 0:
                self.per_round[name] = (self.per_round.get(name, 0)
                                        + len(self.caught) - before)

    def add_event(self, name, dur_s=None, ts=None, depth=None, **attrs):
        return None


def sync_counts(prove_once):
    """Run prove_once() under torch.cuda.set_sync_debug_mode("warn") ->
    (per-round counts, {port call chain: count})."""
    import traceback
    caught, sites = [], collections.Counter()
    counter = SyncCounter(caught)

    def record(message, category, filename, lineno, file=None, line=None):
        caught.append(message)
        # the innermost two frames of the port above its word converters
        # (limbs.py: every upload and download passes there)
        chain = [f for f in traceback.extract_stack()
                 if "distributed_plonk_tpu_torch" in f.filename
                 and not f.filename.endswith("limbs.py")]
        sites[" < ".join("%s:%d" % (os.path.basename(f.filename), f.lineno)
                         for f in chain[::-1][:2]) or "(outside the port)"
              ] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            prove_once(counter)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return counter.per_round, sites


class FleetCounters:
    """The dispatcher's metrics registry (inc / gauge / observe): its
    recovery counters (reconnects, breaker opens and re-admissions, range
    adoptions, rerouted NTTs and evaluation chunks, FFT replans, degraded
    FFTs, quarantines) must stay at zero, so that no worker fault is
    routed around in silence. (A worker's ERR reply is not routed
    around: the dispatcher raises it.)"""

    RECOVERY = ("fleet_reconnects", "fleet_breaker_opens",
                "fleet_readmissions", "fleet_range_adoptions",
                "fleet_ntt_reroutes", "fleet_eval_reroutes",
                "fleet_fft_replans", "fleet_fft_degraded",
                "workers_quarantined", "integrity_failures")

    def __init__(self):
        self.counts = collections.Counter()

    def inc(self, name, by=1):
        self.counts[name] += by

    def gauge(self, name, value):
        pass

    def observe(self, name, seconds):
        pass

    def check(self, label):
        bad = {k: self.counts[k] for k in self.RECOVERY if self.counts[k]}
        assert not bad, (label, bad)


class Fleet:
    """Port workers (`python -m distributed_plonk_tpu_torch.runtime.worker
    i cfg`, on this card unless `args` asks otherwise) on free localhost
    ports; every process is reaped by close()."""

    def __init__(self, count, workdir, args=()):
        import socket
        from distributed_plonk_tpu_torch.runtime.netconfig import \
            NetworkConfig
        socks = [socket.socket() for _ in range(count)]
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        ports = [sk.getsockname()[1] for sk in socks]
        for sk in socks:
            sk.close()
        self.cfg = NetworkConfig(["127.0.0.1:%d" % p for p in ports])
        cfg_path = os.path.join(workdir, "network.json")
        self.cfg.save(cfg_path)
        self.logs = [os.path.join(workdir, "worker%d.log" % i)
                     for i in range(count)]
        self.procs = []
        for i in range(count):
            with open(self.logs[i], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "distributed_plonk_tpu_torch.runtime.worker", str(i),
                     cfg_path, *args], cwd=HERE, stdout=log,
                    stderr=subprocess.STDOUT))

    def check_alive(self):
        dead = [(i, p.returncode) for i, p in enumerate(self.procs)
                if p.poll() is not None]
        if dead:
            for i, _ in dead:
                with open(self.logs[i]) as f:
                    print("worker %d log tail:\n%s" % (i, f.read()[-3000:]))
            raise RuntimeError("fleet workers exited: %s" % dead)

    def dispatcher(self, metrics, tracer=None, timeout_s=180):
        """A Dispatcher once every worker answers a HEALTH probe (probes
        dial fresh connections and count nothing in `metrics`)."""
        from distributed_plonk_tpu_torch.runtime.dispatcher import Dispatcher
        d = Dispatcher(self.cfg, metrics=metrics, tracer=tracer)
        deadline = time.time() + timeout_s
        while any(w.probe(timeout_ms=2000) is None for w in d.workers):
            self.check_alive()
            if time.time() > deadline:
                raise RuntimeError("fleet workers did not answer HEALTH")
            time.sleep(0.5)
        d.ping()
        return d

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def worker_launches(d):
    """Each worker's kernel launch counters (its HEALTH snapshot)."""
    snaps = d.health()
    assert all(s is not None for s in snaps), snaps
    return [s["launches"] for s in snaps]


def launch_delta(before, after, label, names):
    """Per-worker launches between two worker_launches() reads: every
    worker must have launched every kernel in `names`. Returns the sum
    over the workers."""
    total = collections.Counter()
    for i, (b, a) in enumerate(zip(before, after)):
        delta = {k: a[k] - b[k] for k in a}
        missing = [k for k in names if delta[k] == 0]
        assert not missing, (label, i, missing, delta)
        total.update(delta)
    print("worker launches in %s (summed over %d workers): %s"
          % (label, len(before), json.dumps(dict(total))))
    return dict(total)


MODES = ((False, False), (True, False), (False, True), (True, True))


# the kernels of each TPU kernel's port, by the names a torch.profiler
# trace gives them (csrc/*.cu)
KERNEL_NAMES = {
    "K1 mont_mul": ("mont_mul_kernel",),
    "K2 ntt": ("ntt_pass_kernel",),
    "K3 msm_bucket": ("digits_kernel", "chunk_kernel", "tree_kernel"),
    "K4 curve_add": ("msm_tail_kernel", "add_full_kernel",
                     "add_mixed_kernel"),
}
PROFILE_WINDOW_MS = 8000


def check_mfu(gauges, label):
    """Every published mfu_* gauge lies in (0, 100]; returns them."""
    mfu = {k: v for k, v in gauges.items() if k.startswith("mfu_")}
    bad = {k: v for k, v in mfu.items() if not 0 < v <= 100}
    assert mfu and not bad, (label, bad or "no mfu_* gauge", gauges)
    return mfu


def fleet_obs_checks(d, fleet, counters, ckt, pk, golden, n):
    """Fleet phase, step (e): a sharded v1 fleet prove with a PROFILE
    capture of worker 0 armed over it (torch.profiler on the card: the
    blob must name each of the four kernels' ports), then METRICS_FETCH
    of the four workers (served_*, worker_*_s and mfu_* in (0, 100]) and
    LOG_FETCH. The capture's first session in a process pays for the
    profiler's start-up; a 50 ms capture first makes the armed window
    cover the prove."""
    from distributed_plonk_tpu_torch import proof_io
    from distributed_plonk_tpu_torch.obs import profiling
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.runtime.dispatcher import RemoteBackend
    t = time.perf_counter()
    meta, _ = d.profile_worker(0, duration_ms=50)
    print("worker 0's first capture (profiler start-up): %.3f s, %s"
          % (time.perf_counter() - t, json.dumps(meta)))
    dd = fleet.dispatcher(counters)
    box = {}

    def arm():
        box["t0"] = time.perf_counter()
        box["cap"] = d.profile_worker(0, duration_ms=PROFILE_WINDOW_MS)
        box["t1"] = time.perf_counter()
    th = threading.Thread(target=arm)
    th.start()
    time.sleep(0.5)
    before = worker_launches(dd)
    t = time.perf_counter()
    proof = prove(random.Random(1), ckt, pk, RemoteBackend(
        dd, dist_fft_min=n))
    prove_s = time.perf_counter() - t
    launch_delta(before, worker_launches(dd), "the profiled fleet prove",
                 BASE_KERNELS)
    th.join()
    assert proof_io.serialize_proof(proof) == golden, "profiled fleet prove"
    meta, blob = box["cap"]
    assert meta["format"] == "torch-trace-gz", meta
    names = profiling.kernel_names(blob)
    # "void mont_mul_kernel<Fr>(unsigned int*, ...)" -> "mont_mul_kernel"
    base = {name: name.split("(")[0].split("<")[0].split()[-1]
            for name in names}
    found = {k: sum(c for name, c in names.items() if base[name] in v)
             for k, v in KERNEL_NAMES.items()}
    print("profiled sharded fleet prove: %.3f s, equal to the fixture; "
          "worker 0's capture armed %.3f s before it, %d ms window: %s"
          % (prove_s, t - box["t0"], PROFILE_WINDOW_MS, json.dumps(meta)))
    ours = collections.Counter()
    for name, c in names.items():
        if any(base[name] in v for v in KERNEL_NAMES.values()):
            ours[base[name]] += c
    print("  kernel events by port: %s; the port's kernels by name: %s; "
          "%d events of other kernels (torch)" % (
              json.dumps(found), json.dumps(dict(sorted(ours.items()))),
              sum(names.values()) - sum(ours.values())))
    assert all(found.values()), ("a kernel missing from the profile",
                                 found, sorted(set(base.values())))
    entries = d.fleet_metrics()
    assert len(entries) == 4 and all(e["snapshot"] for e in entries), \
        entries
    for e in entries:
        snap = e["snapshot"]
        served = {k: v for k, v in snap["counters"].items()
                  if k.startswith("served_")}
        hists = {k: h["count"] for k, h in snap["histograms"].items()
                 if k.startswith("worker_")}
        mfu = check_mfu(snap["gauges"], "worker %d" % e["index"])
        assert served and hists, (e["index"], snap)
        assert {"served_msm", "served_fft2", "served_eval"} <= set(served)
        assert snap["device"].startswith("cuda"), snap["device"]
        print("worker %d METRICS_FETCH: served %s; kernel timings %s; "
              "mfu %s; kernel G IMAD/s %s" % (
                  e["index"], json.dumps(served), json.dumps(hists),
                  json.dumps(mfu), json.dumps({
                      k: v for k, v in snap["gauges"].items()
                      if k.startswith("kernel_")})))
    logs = d.fetch_logs()
    assert [lg["worker"] for lg in logs] == [0, 1, 2, 3]
    assert any(ev.get("event") == "profile_captured"
               for ev in logs[0]["events"]), logs[0]
    print("LOG_FETCH: events per worker %s"
          % [len(lg["events"]) for lg in logs])
    dd.pool.shutdown()
    for w in dd.workers:
        w.close()


def fleet_checks(ckt, pk, vk, golden, ck2, be2, dev, rng):
    """Phase 11's steps (b)-(e) (see the module docstring): four port
    workers on this card behind the port's Dispatcher; the sharded FFT
    of one 2^21 vector, a fleet MSM over v2's commit key `ck2` against
    `be2`'s single-card commitment, the v1 proof through the fleet,
    sharded and unsharded, and the observability plane. Runs in a child
    process (phase_child), beside phases 12 and 13."""
    from distributed_plonk_tpu_torch import proof_io
    from distributed_plonk_tpu_torch.backend import ntt_torch as N
    from distributed_plonk_tpu_torch.backend.limbs import lift, lower
    from distributed_plonk_tpu_torch.constants import R_MOD
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.runtime import protocol
    from distributed_plonk_tpu_torch.runtime.dispatcher import RemoteBackend
    from distributed_plonk_tpu_torch.verifier import verify
    n = ckt.n
    steps = Steps()
    workdir = tempfile.mkdtemp(prefix="dpt_fleet_")
    t = time.perf_counter()
    fleet = Fleet(4, workdir)
    try:
        counters = FleetCounters()
        d = fleet.dispatcher(counters)
        print("4 port workers up in %.3f s" % (time.perf_counter() - t))
        for i, snap in enumerate(d.health()):
            assert snap["backend"] == "torch" and \
                snap["device"].startswith("cuda"), (i, snap)
        print("HEALTH: every worker reports backend torch on %s"
              % sorted({s["device"] for s in d.health()}))
        steps.done("four workers up")

        # (b) the sharded 4-step FFT of one 2^21 vector, coset forward and
        # coset inverse, against the single-card K2 on the same values
        size = 1 << 21
        plan = N.get_plan(size, dev)
        values = [rng.randrange(R_MOD) for _ in range(size)]
        h = lift(values, dev).reshape(8, 1, size)
        for inverse in (False, True):
            before = worker_launches(d)
            t = time.perf_counter()
            got = d.fft_dist(values, inverse=inverse, coset=True)
            secs = time.perf_counter() - t
            launch_delta(before, worker_launches(d),
                         "fft_dist 2^21 coset inverse=%d" % inverse,
                         ("mont_mul", "ntt"))
            want = lower(N.ntt(plan, h, inverse, True)[:, 0])
            assert got == want, ("fft_dist 2^21", inverse)
            print("fft_dist 2^21 coset inverse=%d over 4 workers: %.3f s, "
                  "equal to the single-card ntt" % (inverse, secs),
                  flush=True)
        del values, h, got, want
        counters.check("fft_dist")
        steps.done("(b) fft_dist 2^21, forward and inverse")

        # (c) a fleet MSM over v2's commit key (2^18 + 3 powers padded to
        # a multiple of 32), against the single-card commitment
        rb = RemoteBackend(d)
        t = time.perf_counter()
        host_ck = rb._host_bases(ck2)
        print("v2 commit key to host affine points (%d): %.3f s"
              % (len(host_ck), time.perf_counter() - t))
        scalars = [rng.randrange(R_MOD) for _ in range(V2_POWERS)]
        before = worker_launches(d)
        t = time.perf_counter()
        fleet_point = rb.commit(ck2, scalars)
        msm_s = time.perf_counter() - t
        launch_delta(before, worker_launches(d), "the fleet msm",
                     ("msm_digits", "bucket_sums", "msm_tail", "proj_add"))
        t = time.perf_counter()
        single = be2.commit_many_h(ck2, [lift(scalars, dev)])[0]
        single_s = time.perf_counter() - t
        assert fleet_point == single, "fleet msm"
        print("fleet msm over %d bases (4 ranges, keys built by the "
              "workers): %.3f s; equal to TorchBackend.commit_many_h "
              "(%.3f s warm)" % (len(host_ck), msm_s, single_s), flush=True)
        del host_ck, scalars, rb
        counters.check("fleet msm")
        steps.done("(c) the fleet msm over v2's key")

        # (d) the v1 proof through the fleet: every NTT sharded
        # (dist_fft_min = n), then whole NTTs round-robin
        for label, fft_min in (("sharded", n), ("unsharded", None)):
            dtr = Tracer(proc="dispatcher")
            dd = fleet.dispatcher(counters, tracer=dtr)
            be_f = RemoteBackend(dd, dist_fft_min=fft_min)
            stats0 = dd.stats()
            before = worker_launches(dd)
            tr = Tracer()
            t = time.perf_counter()
            proof = prove(random.Random(1), ckt, pk, be_f, tracer=tr)
            secs = time.perf_counter() - t
            fleet_launches = launch_delta(
                before, worker_launches(dd), "the %s fleet prove" % label,
                BASE_KERNELS + ("proj_add", "poly_eval"))
            blob = proof_io.serialize_proof(proof)
            assert blob == golden, "%s fleet proof bytes" % label
            assert verify(vk, ckt.public_input(), proof,
                          rng=random.Random(2))
            served = [{protocol.tag_name(int(k)): v - s0.get(k, 0)
                       for k, v in s1.items() if v - s0.get(k, 0)}
                      for s0, s1 in zip(stats0, dd.stats())]
            # every worker took its share of each offloaded kind of work
            must = ("MSM", "EVAL") + (("FFT1", "FFT2") if fft_min
                                      else ("NTT",))
            idle = [(i, t) for i, sv in enumerate(served) for t in must
                    if not sv.get(t)]
            assert not idle, ("%s fleet prove: workers served none of"
                              % label, idle, served)
            merged = dd.collect_trace()
            spans = collections.defaultdict(float)
            for ev in merged["events"]:
                if ev["proc"].startswith("worker"):
                    spans[ev["span"]] += ev["dur_s"]
            print("%s fleet prove: %.3f s, equal to the fixture, verifies"
                  % (label, secs))
            print("  rounds: " + json.dumps(
                {k: round(v, 4) for k, v in tr.totals(0).items()}))
            print("  worker span seconds (summed over workers): "
                  + json.dumps({k: round(v, 3)
                                for k, v in sorted(spans.items())}))
            print("  requests served per worker: " + json.dumps(served))
            kernels_per = {k: v for k, v in fleet_launches.items() if v}
            print("  kernel launches per %s fleet prove: %s"
                  % (label, json.dumps(kernels_per)), flush=True)
            print("  the workers' round-4 EVAL per %s fleet prove: "
                  "poly_eval launches %d (one per EVAL), mont_mul %d in "
                  "all; worker eval span %.4f s summed"
                  % (label, fleet_launches["poly_eval"],
                     fleet_launches["mont_mul"], spans.get("eval", 0.0)),
                  flush=True)
            dd.pool.shutdown()
            for w in dd.workers:
                w.close()
        counters.check("fleet proves")
        steps.done("(d) the sharded and unsharded v1 fleet proves")

        # (e) the observability plane over the same workers: a third,
        # sharded v1 prove with a PROFILE capture armed on worker 0, then a
        # METRICS_FETCH scrape of all four and a LOG_FETCH
        fleet_obs_checks(d, fleet, counters, ckt, pk, golden, n)
        fleet.check_alive()
        steps.done("(e) the profiled fleet prove, METRICS_FETCH, LOG_FETCH")
        d.shutdown()
    finally:
        fleet.close()
        shutil.rmtree(workdir, ignore_errors=True)


def mode_name(inverse, coset):
    return "%s%s" % ("inverse" if inverse else "forward",
                     " coset" if coset else "")


def seeded_words(dev, rng, *shape):
    """Random canonical Fr words on dev (a top word below 2^30 keeps every
    value below the modulus), made on the device from a seeded generator."""
    g = torch.Generator(device=dev)
    g.manual_seed(rng.randrange(1 << 62))
    v = torch.randint(-2**31, 2**31, (8,) + shape, dtype=torch.int32,
                      device=dev, generator=g)
    v[7] &= 0x3FFFFFFF
    return v


# round 3's folds (csrc/round3.cu): the Fr products a lane of each gate
# selector's term costs and the wire planes it reads (circuit.py order:
# Q_LC x4, Q_MUL x2, Q_HASH x4, Q_O, Q_C, Q_ECC); the combine's products
# (k_j * beta folded on the host)
R3_GATE_PRODUCTS = (1, 1, 1, 1, 2, 2, 4, 4, 4, 4, 1, 0, 5)
R3_GATE_WIRES = ((0,), (1,), (2,), (3,), (0, 1), (2, 3), (0,), (1,), (2,),
                 (3,), (4,), (), (0, 1, 2, 3, 4))
R3_COMBINE_PRODUCTS = 14
R3_SOURCE = "distributed_plonk_tpu_torch/csrc/round3.cu"
# no pallas_call: the JAX function each fold replaces (its XLA epilogue or
# prologue of the coset NTT under DPT_R3_FUSE)
R3_REPLACES = {
    "r3_gate_fold": "distributed_plonk_tpu/backend/jax_backend.py:418",
    "r3_sigma_fold": "distributed_plonk_tpu/backend/jax_backend.py:428",
    "r3_combine": "distributed_plonk_tpu/backend/jax_backend.py:437"}
# phase 2's shapes: m, the gate batch (start, count), the sigma batch;
# v1's one launch each, and v2's widest (selectors 4-7, Q_MUL into Q_HASH;
# sigmas 0-3)
R3_PARITY = (("v1", 1 << 16, (0, 13), (0, 5), 20),
             ("v2", 1 << 21, (4, 4), (0, 4), 5))


def r3_work(name, m, start=0, count=0):
    """(bytes, IMADs) of one fold launch over m lanes: each input plane
    read once and the output written once; FR_MUL_IMADS per product."""
    if name == "r3_gate_fold":
        qs = range(start, start + count)
        wires = set().union(*(R3_GATE_WIRES[q] for q in qs))
        planes = 2 + count + len(wires)
        products = sum(R3_GATE_PRODUCTS[q] for q in qs)
    elif name == "r3_sigma_fold":
        planes, products = 2 + 2 * count, 2 * count
    else:
        planes, products = 5 + 6 + 1, R3_COMBINE_PRODUCTS
    return 32 * m * planes, m * products * FR_MUL_IMADS


def r3_words(dev, rng, planes, m):
    """seeded_words (8, planes, m) with the corners 0, 1 and r - 1 in
    lanes 0-2 of every plane."""
    from distributed_plonk_tpu_torch.backend.limbs import (ints_to_words,
                                                          to_tensor)
    from distributed_plonk_tpu_torch.constants import R_MOD
    v = seeded_words(dev, rng, planes, m)
    v[:, :, :3] = to_tensor(ints_to_words([0, 1, R_MOD - 1], 8),
                            dev)[:, None, :]
    return v


def parity_row(record, kernels, runs, name, label, source, replaces, err,
               py_ms, pms, work, shape, fn, reps):
    """One exact phase-2 row of a kernel timed at more than one shape:
    v1's is its `kernels` record, another shape's its record's `label`
    entry; fn goes into `runs` for the graph time. work: (bytes,
    IMADs) for the bound."""
    nbytes, imads = work
    if label == "v1":
        record(name, source, replaces, err, py_ms, pms, nbytes, imads,
               shape)
        runs[name] = (fn, reps)
        return
    kernels[name][label] = {
        "shape": shape, "ms": None, "launch_ms": py_ms, "plain_ms": pms,
        "bound_ms": bound_ms(nbytes, imads),
        "bound_by": bound_by(nbytes, imads), "library_ms": None,
        "max_abs_err": err}
    runs["%s %s" % (name, label)] = (fn, reps)
    print("parity %-18s %-34s exact  launched from Python %.4f ms  "
          "plain %.3f ms  bound %.4f ms (%s)"
          % (name, shape, py_ms, pms, bound_ms(nbytes, imads),
             bound_by(nbytes, imads)), flush=True)


# kernel 8 (csrc/eval.cu): no pallas_call, the JAX function it replaces;
# phase 2's shapes (label, B, L, calls timed): round 4's ten polynomials of
# n + 3 coefficients at v1, v2 and 2^20, and a v1 fleet worker's EVAL (one
# polynomial: the dispatcher splits n + 3 over 4 workers)
EVAL_SOURCE = "distributed_plonk_tpu_torch/csrc/eval.cu"
EVAL_REPLACES = "distributed_plonk_tpu/backend/prover_jax.py:319"
EVAL_PARITY = (("v1", 10, (1 << 13) + 3, 20), ("v2", 10, (1 << 18) + 3, 5),
               ("2p20", 10, (1 << 20) + 3, 3), ("fleet", 1, 2049, 50))


def eval_operands(dev, rng, B, L):
    """Kernel 8's seeded operands on dev: (8, B, L) coefficients with the
    corners (r3_words) and (8, B, 1) points, the first two 0 and 1 where
    B >= 2."""
    from distributed_plonk_tpu_torch.backend.limbs import lift
    polys = r3_words(dev, rng, B, L)
    zs = seeded_words(dev, rng, B)
    if B >= 2:
        zs[:, :2] = lift([0, 1], dev)
    return polys, zs.reshape(8, B, 1)


def eval_profile(fn, calls=5, tries=3):
    """(device kernels a call, profiler us a kernel, their names) of fn
    under torch.profiler over `calls` calls: every kernel, fill and copy
    the session recorded. The profiler can lose events, so only a session
    that recorded an eval_kernel for every call counts; up to `tries`
    sessions, (None, None, names of the last) if none did."""
    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(tries):
        with _profiler(cpu=False) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = _device_kernels(prof)
        names = [k for k, _, _ in rows]
        if sum(c for k, c, _ in rows if "eval_kernel" in k) == calls:
            count = sum(c for _, c, _ in rows)
            return (count / calls, sum(us for _, _, us in rows) / count,
                    names)
    return None, None, names


def graph_nodes(fn, reps):
    """(kind -> count, kernel node labels) of a CUDA graph of reps fn()
    calls, from its debug dump (cudaGraphDebugDotPrint of the captured
    graph, kept for it): every kernel (KERNEL), fill (MEMSET) and copy
    (MEMCPY) the calls launch, which the capture records whatever the
    profiler loses."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    del graph
    kinds, kernels = collections.Counter(), []
    for node in re.split(r'^\s*"graph_\d+_node_\d+"\s*\[', text,
                         flags=re.M)[1:]:
        kind = re.search(r"\b(KERNEL|MEMSET|MEMCPY|HOST|EMPTY|GRAPH|"
                         r"WAIT_EVENT|EVENT_RECORD|MEM_ALLOC|MEM_FREE|"
                         r"CONDITIONAL)\b", node)
        kinds[kind.group(1) if kind else "?"] += 1
        if kind and kind.group(1) == "KERNEL":
            kernels.append(node)
    return kinds, kernels


def eval_parity(dev, rng, record, plain_ms, kernels, runs,
                shapes=EVAL_PARITY):
    """Phase 2's poly_eval rows: kernel 8 against poly_eval_ref (the plain
    version, its products on kernel 1: the path round 4 took before
    kernel 8) on seeded words, the points 0 and 1 among them where B >=
    2, at v1's shape (the `kernels` record) and each other shape of
    EVAL_PARITY (its record's entry by label), exact; each
    timed from Python beside its plain version and its bound (B * L Fr
    products; the coefficients read once), and added to `runs` for the
    graph time; then each shape's nodes in a CUDA graph of its calls
    (graph_nodes: one eval_kernel a call, no fill, no copy) and its
    device kernels a call and their profiler us (eval_profile: one where
    a session recorded every call)."""
    from distributed_plonk_tpu_torch.backend import prover_torch as PT
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, B, L, reps in shapes:
        polys, zs = eval_operands(dev, rng, B, L)

        def fn(polys=polys, zs=zs):
            return PT.poly_eval_cuda(polys, zs)

        got = fn()
        want, pms = plain_ms(lambda: PT.poly_eval_ref(polys, zs))
        err = max_abs_err(got, want)
        assert err == 0 and torch.equal(got, want), ("poly_eval", label,
                                                     err)
        parity_row(record, kernels, runs, "poly_eval", label, EVAL_SOURCE,
                   EVAL_REPLACES, err, launch_ms(fn, reps), pms,
                   (32 * B * (L + 2), B * L * FR_MUL_IMADS),
                   "(8, %d, %d), %d CTAs x %d coefficients a lane" % (
                       (B, L) + PT.eval_geometry(B, L, sms)), fn, reps)
        kinds, nodes = graph_nodes(fn, 3)
        assert dict(kinds) == {"KERNEL": 3} and all(
            "eval_kernel" in k for k in nodes), (label, kinds, nodes)
        per_call, us, names = eval_profile(fn)
        assert per_call is None or (per_call == 1 and all(
            "eval_kernel" in k for k in names)), (label, per_call, names)
        rec = kernels["poly_eval"] if label == "v1" \
            else kernels["poly_eval"][label]
        rec.update(graph_kernels_per_call=kinds["KERNEL"] / 3,
                   device_kernels_per_call=per_call, prof_us=us)
        print("poly_eval %-5s (8, %d, %d): %s graph nodes in 3 calls; under "
              "the profiler %s device kernels a call (%s), %s us a kernel"
              % (label, B, L, dict(kinds), per_call if per_call is not None
                 else "not measured (events lost)",
                 ", ".join(k[:30] for k in names),
                 "%.2f" % us if us is not None else "not measured"),
              flush=True)
        del got, want


def r3_parity(dev, rng, record, plain_ms, kernels, runs, shapes=R3_PARITY):
    """Phase 2's round-3 rows: r3_gate_fold, r3_sigma_fold and r3_combine
    against their plain versions (prover_torch.*_ref: the unfused path's
    steps, their products on kernel 1) on seeded words with corners, at
    v1's shapes (the `kernels` record) and v2's (its "v2" entry), exact;
    each timed from Python beside its plain version and its bound, and
    added to `runs` for the graph time."""
    for label, m, gate_batch, sigma_batch, reps in shapes:
        _r3_shape(dev, rng, record, plain_ms, kernels, runs, label, m,
                  gate_batch, sigma_batch, reps)


def _r3_shape(dev, rng, record, plain_ms, kernels, runs, label, m,
              gate_batch, sigma_batch, reps):
    """r3_parity at one shape (its own frame: the closures kept in `runs`
    hold this shape's tensors)."""
    from distributed_plonk_tpu_torch.backend import prover_torch as PT
    from distributed_plonk_tpu_torch.constants import R_MOD
    (gs, gc), (ss, sc) = gate_batch, sigma_batch
    sel = r3_words(dev, rng, gc, m)
    sig = r3_words(dev, rng, sc, m)
    wires = r3_words(dev, rng, 5, m)
    gate, acc2, z, ep, zh, sh = r3_words(dev, rng, 6, m).unbind(1)
    tabs = {"ep": ep, "zh_inv": zh, "shifted_inv": sh}
    k = [rng.randrange(R_MOD) for _ in range(5)]
    beta, gamma, alpha, asdn = (rng.randrange(R_MOD) for _ in range(4))
    comb = (wires, z, gate, acc2, tabs, k, beta, gamma, alpha, asdn)
    cases = (
        ("r3_gate_fold", "(8, %d, %d) from selector %d" % (gc, m, gs),
         lambda: PT.gate_fold_cuda(gate, sel, wires, gs),
         lambda: PT.gate_fold_ref(gate, sel, wires, gs), (gs, gc)),
        ("r3_sigma_fold", "(8, %d, %d) from sigma %d" % (sc, m, ss),
         lambda: PT.sigma_fold_cuda(acc2, sig, wires, ss, beta, gamma),
         lambda: PT.sigma_fold_ref(acc2, sig, wires, ss, beta, gamma),
         (ss, sc)),
        ("r3_combine", "(8, 5, %d) + 6 x (8, %d)" % (m, m),
         lambda: PT.quotient_combine_cuda(*comb),
         lambda: PT.quotient_combine_ref(*comb), (0, 0)))
    for name, shape, fn, ref, batch in cases:
        got = fn()
        want, pms = plain_ms(ref)
        err = max_abs_err(got, want)
        assert err == 0 and torch.equal(got, want), (name, label, err)
        parity_row(record, kernels, runs, name, label, R3_SOURCE,
                   R3_REPLACES[name], err, launch_ms(fn, reps), pms,
                   r3_work(name, m, *batch), shape, fn, reps)
    del got, want


def mesh_ntt_checks(mesh, sizes, dev, rng, mesh_runs, skip=()):
    """MeshNttPlan over `mesh` at each size in all four modes (but the
    (size, mode name) pairs in skip), whole in and out, equal to the
    single-card kernel 2 (and, at 2^16 and below, to its plain version) on
    the same (8, 2, size) words; the per-mode table build seconds. Adds a
    batch-1 call per size and mode to mesh_runs for graph timing."""
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend import ntt_torch as N
    from distributed_plonk_tpu_torch.parallel.ntt_mesh import MeshNttPlan
    for size in sizes:
        mplan = MeshNttPlan(mesh, size)
        plan = N.get_plan(size, dev)
        v = seeded_words(dev, rng, 2, size)
        for inverse, coset in MODES:
            mode = mode_name(inverse, coset)
            if (size, mode) in skip:
                continue
            t = time.perf_counter()
            mplan.tables(inverse, coset)
            sync()
            tables_s = time.perf_counter() - t
            _build.reset_launches()
            got = mplan.ntt(v, inverse, coset)
            read_launches("the mesh ntt 2^%d %s" % (
                size.bit_length() - 1, mode), ("mont_mul", "ntt"))
            assert max_abs_err(got, N.ntt(plan, v, inverse, coset)) == 0, \
                ("mesh ntt vs single-card ntt", size, mode)
            plain = ""
            if size <= 1 << 16:
                assert max_abs_err(got, N.ntt_ref(plan, v, inverse,
                                                  coset)) == 0
                plain = " and its plain version"
            print("mesh ntt (8, 2, 2^%d) %s over %d shards: equal to the "
                  "single-card ntt%s; tables %.3f s; rows %d x %d then %d "
                  "x %d a shard" % (size.bit_length() - 1, mode, mesh.size,
                                    plain, tables_s, 2 * mplan.rows_a,
                                    mplan.r, 2 * mplan.rows_b, mplan.c),
                  flush=True)
            one = v[:, :1].contiguous()
            mesh_runs["mesh ntt (8, 1, 2^%d) %s" % (
                size.bit_length() - 1, mode)] = (
                lambda one=one, m=mplan, i=inverse, c=coset: m.ntt(one, i, c),
                5)
            mesh_runs["single-card ntt (8, 1, 2^%d) %s" % (
                size.bit_length() - 1, mode)] = (
                lambda one=one, p=plan, i=inverse, c=coset: N.ntt(p, one, i,
                                                                  c), 5)


# v2's peak device memory above the resident on the mesh with its handles
# whole on the lead, and round 3's peak on the single card's one-shot
# round 3, as PERF.md records them for an NVIDIA H100 80GB HBM3 at 700.00
# W: the figures the sharded mesh's peak is printed beside
UNSHARDED_MESH_V2_MIB = 8000.5
ONE_SHOT_V2_MIB = 4808.0


def mesh_prove_checks(mesh, ckt, pk, vk, want_blob, seed_be, label,
                      rounds=("cold", "warm")):
    """MeshBackend(mesh) proves (ckt, pk), whose handles seed_be holds, once
    per label in rounds with prove rng Random(1): every proof's bytes equal
    want_blob and verify; every NTT at n and m and every commitment took
    the mesh path, and every handle of n, n + 2, n + 3 and m lanes was
    sharded, none whole (the counters); per-round seconds, peak memory
    above the resident and round 3's peak beside the sharded memory plan,
    the unsharded mesh's and the single card's, the launches of the last
    prove (returned); then one more prove under the profiler (device busy
    time and idle share)."""
    from distributed_plonk_tpu_torch import proof_io
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.parallel import memory_plan
    from distributed_plonk_tpu_torch.parallel.mesh_backend import \
        MeshBackend
    from distributed_plonk_tpu_torch.poly import Domain
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.trace import Tracer
    from distributed_plonk_tpu_torch.verifier import verify
    be = MeshBackend(mesh)
    be.register_pk_polys(pk, *seed_be.pk_polys(pk))
    n = ckt.n
    m = Domain(6 * (n + 1) + 1).size        # the quotient domain
    launches = None
    plan = memory_plan.round3_mesh_plan(n, m, mesh.size)
    plan_mib = plan["per_process"] / 2**20
    for r in rounds:
        be.mesh_ntt_calls.clear()
        be.replicated_ntt_calls.clear()
        be.mesh_msm_calls = 0
        be.sharded_handles.clear()
        be.replicated_handles.clear()
        mem0 = reset_peak()
        _build.reset_launches()
        tr = Round3Peak()
        t = time.perf_counter()
        proof = prove(random.Random(1), ckt, pk, be, tracer=tr)
        sync()
        secs = time.perf_counter() - t
        mib = peak_mib(mem0)
        launches = read_launches("the %s %s mesh prove" % (label, r),
                                 BASE_KERNELS + ("proj_add", "poly_eval"))
        assert proof_io.serialize_proof(proof) == want_blob, \
            "%s %s mesh proof differs from the single-card proof" % (label,
                                                                      r)
        assert not be.replicated_ntt_calls, be.replicated_ntt_calls
        assert set(be.mesh_ntt_calls) == {n, m}, be.mesh_ntt_calls
        assert be.mesh_msm_calls == 13, be.mesh_msm_calls
        assert {n, n + 2, n + 3, m} <= set(be.sharded_handles) and \
            not be.replicated_handles, (be.sharded_handles,
                                        be.replicated_handles)
        print("%s %s prove on MeshBackend(%d shards) %.3f s; equal to the "
              "single-card proof; peak device memory above the resident "
              "%.1f MiB, round 3's %.1f MiB, beside the sharded plan's %.1f "
              "MiB (%d shards of %.1f), the unsharded mesh's %.1f MiB and "
              "the single card's one-shot round 3's %.1f MiB"
              % (label, r, mesh.size, secs, mib, tr.peak_mib, plan_mib,
                 mesh.size, plan["shard"] / 2**20, UNSHARDED_MESH_V2_MIB,
                 ONE_SHOT_V2_MIB))
        print("  rounds: " + json.dumps(
            {k: round(v, 4) for k, v in tr.totals(0).items()}))
        print("  spans: " + json.dumps(
            {k: round(v, 4) for k, v in tr.totals(1).items()}))
        print("  counters: mesh_ntt_calls %s, replicated_ntt_calls %s, "
              "mesh_msm_calls %d, sharded_handles %s, replicated_handles "
              "%s" % (dict(be.mesh_ntt_calls), dict(be.replicated_ntt_calls),
                      be.mesh_msm_calls, dict(be.sharded_handles),
                      dict(be.replicated_handles)))
        print("  launches: " + json.dumps(launches), flush=True)
    print("  memory plan (round 3 a shard, MiB): " + json.dumps(
        {k: plan[k] / 2**20 for k in ("planes", "stacks", "tables", "base",
                                      "resident", "ntt", "shard",
                                      "per_process")}))
    t = time.perf_counter()
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(2))
    print("  verify ok in %.3f s" % (time.perf_counter() - t))
    profile_prove(lambda: prove(random.Random(1), ckt, pk, be),
                  "%s warm mesh prove" % label)
    return launches


def load_script(name):
    """scripts/<name>.py as a module (scripts/ is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mesh_scale_checks(ckt, dev, mesh_runs, log2n=21, device=None):
    """Phase 9's runs of the two mesh scale scripts' functions on four
    shards of this card: scripts/torch_mesh_ntt_scale.py at 2^21 (the
    forward coset NTT and its inverse on sharded handles, the round trip
    exact; the forward output equal to the single-card ntt of the
    gathered input: the oracle on the card), its two modes graph-timed in
    the last phase beside the single-card ntt; scripts/
    torch_mesh_prove_scale.py on v1 (ckt): preprocess and prove on
    MeshBackend, the proof equal to the fixture and verified, every
    handle sharded, each shard's live bytes at round 3's quotient within
    the plan. (log2n and device="cpu" rehearse it on the plain versions.)"""
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend import ntt_torch as N
    from distributed_plonk_tpu_torch.parallel import sharded as S
    ntt_scale = load_script("torch_mesh_ntt_scale")
    prove_scale = load_script("torch_mesh_prove_scale")
    _build.reset_launches()
    t = time.perf_counter()
    res, h, ev, be = ntt_scale.mesh_ntt_scale(log2n, 4, device,
                                              skip_oracle=True)
    secs = time.perf_counter() - t
    read_launches("scripts/torch_mesh_ntt_scale.py at 2^%d" % log2n,
                  ("mont_mul", "ntt"))
    n = 1 << log2n
    plan = N.get_plan(n, dev)
    whole = S.gather(h)[:, None].contiguous()
    assert max_abs_err(S.gather(ev)[:, None], N.ntt(plan, whole, False,
                                                    True)) == 0, \
        "the sharded 2^21 coset NTT vs the single card"
    print("scripts/torch_mesh_ntt_scale.py (2^%d, 4 shards) in %.3f s: the "
          "round trip exact, the forward output equal to the single-card "
          "ntt; %s" % (log2n, secs, json.dumps(res)), flush=True)
    mplan = be._plan(n)
    for inverse, x in ((False, h), (True, ev)):
        mode = mode_name(inverse, True)
        mesh_runs["mesh ntt sharded (8, 1, 2^%d) %s" % (log2n, mode)] = (
            lambda x=x, i=inverse: mplan.ntt([p[:, None] for p in x.pieces],
                                             i, True, sharded=True), 5)
        one = S.gather(x)[:, None].contiguous()
        mesh_runs["single-card ntt (8, 1, 2^%d) %s" % (log2n, mode)] = (
            lambda one=one, i=inverse: N.ntt(plan, one, i, True), 5)
    del whole
    _build.reset_launches()
    t = time.perf_counter()
    res = prove_scale.mesh_prove_scale(ckt, 4, device, skip_oracle=True,
                                       fixture=FIXTURE)
    secs = time.perf_counter() - t
    read_launches("scripts/torch_mesh_prove_scale.py on v1",
                  BASE_KERNELS + ("proj_add",))
    assert res["fixture_match"] and res["verified"], res
    assert not res["replicated_handles"], res["replicated_handles"]
    assert res["residency"]["within_plan"], res["residency"]
    print("scripts/torch_mesh_prove_scale.py (v1, 4 shards) in %.3f s: "
          "the proof equals the fixture and verifies; each shard's live "
          "bytes at round 3's quotient within the plan; %s"
          % (secs, json.dumps(res)), flush=True)


def scale_script_checks(dev, device=None, sizes=None, height=32, proofs=1):
    """Phase 8b's runs of the reference-scale runners' functions on this
    card: scripts/torch_scale_run.py on v1 (height 32, one proof: the
    device SRS, preprocess, a cold and a warm prove, verify), and
    scripts/torch_kernel_bench.py's modes at 2^16 (the mont_mul chains,
    the NTT, the MSM on both key layouts: the same point, each meeting
    the tiling identity). The launch counters are zeroed before each and
    read after. (device="cpu", a small height, proofs 0 and small sizes
    rehearse it on the plain versions.)"""
    from distributed_plonk_tpu_torch.backend import _build
    scale = load_script("torch_scale_run")
    bench = load_script("torch_kernel_bench")
    device = dev if device is None else torch.device(device)
    _build.reset_launches()
    t = time.perf_counter()
    res = scale.scale_run(height, proofs, device)
    secs = time.perf_counter() - t
    read_launches("scripts/torch_scale_run.py on v1",
                  PATH_KERNELS + ("proj_add", "proj_add_mixed"))
    assert res["verified"] is True, res
    res.pop("trace")
    print("scripts/torch_scale_run.py (height %d, %d proof(s)) in %.3f s: "
          "%s" % (height, proofs, secs, json.dumps(res)), flush=True)
    sizes = sizes or {"fr": 16, "fq": 16, "ntt": 16, "msm": (16, 16)}
    _build.reset_launches()
    t = time.perf_counter()
    out = bench.kernel_bench("all", device, sizes)
    secs = time.perf_counter() - t
    read_launches("scripts/torch_kernel_bench.py at 2^16", (
        "mont_mul", "ntt", "msm_digits", "bucket_sums", "msm_tail",
        "msm_finish", "proj_add", "proj_add_mixed"))
    msm = out["msm_2p%d" % sizes["msm"][1]]
    assert msm["same_point"] and msm["shifted"]["tiling_identity"] \
        and msm["base"]["tiling_identity"], msm
    print("scripts/torch_kernel_bench.py (all, 2^16) in %.3f s: %s"
          % (secs, json.dumps(out)), flush=True)


ZOO_KINDS = (("range", {"bits": 8, "count": 2}), ("preimage", {"count": 1}))


def zoo_build(rollup_params):
    """Every kind of the circuit zoo built (seed 3): range and preimage at
    ZOO_KINDS, the rollup at rollup_params; kind -> circuit."""
    from distributed_plonk_tpu_torch import circuits
    built = {}
    for kind, params in ZOO_KINDS + (("rollup", rollup_params),):
        params = circuits.validate_params(kind, params)
        t = time.perf_counter()
        built[kind] = circuits.build(kind, params, seed=3)
        print("zoo %s %s: n = %d, %d public inputs, built in %.3f s"
              % (kind, json.dumps(params), built[kind].n,
                 built[kind].num_inputs, time.perf_counter() - t),
              flush=True)
    return built


def zoo_prove(ckt, be, count, dev):
    """preprocess + count proves of ckt on be from the device SRS on dev
    (tau 0xDEADBEEF, prove rng Random(3)); the last proof must verify ->
    (blobs, seconds: pre, each prove, vk)."""
    from distributed_plonk_tpu_torch import kzg, proof_io
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.verifier import verify
    cuda = torch.device(dev).type == "cuda"
    srs = kzg.universal_setup_device(ckt.n + 2, tau=0xDEADBEEF, device=dev)
    t = time.perf_counter()
    pk, vk = kzg.preprocess(srs, ckt, be)
    if cuda:
        sync()
    secs = [time.perf_counter() - t]
    blobs = []
    for _ in range(count):
        _build.reset_launches()
        t = time.perf_counter()
        proof = prove(random.Random(3), ckt, pk, be)
        if cuda:
            sync()
        secs.append(time.perf_counter() - t)
        blobs.append(proof_io.serialize_proof(proof))
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(4))
    return blobs, secs, vk


def zoo_cpu_child(out_path):
    """python3 chip_smoke.py --zoo-cpu OUT: the zoo's range and preimage
    circuits preprocessed and proven on TorchBackend(device="cpu") (the
    plain versions; no card touched), each proof verified; writes
    {kind: {"blob": hex, "secs": [pre, prove]}} to OUT. The set-up runs it
    beside nvcc; phase 10 holds the card's proofs to these bytes."""
    from distributed_plonk_tpu_torch import circuits
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    torch.set_num_threads(1)
    out = {}
    for kind, params in ZOO_KINDS:
        ckt = circuits.build(kind, circuits.validate_params(kind, params),
                             seed=3)
        blobs, secs, _ = zoo_prove(ckt, TorchBackend(device="cpu"), 1, "cpu")
        out[kind] = {"blob": blobs[0].hex(), "secs": secs}
    with open(out_path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(out_path + ".tmp", out_path)
    return 0


def analysis_cpu_child(out_path):
    """python3 chip_smoke.py --analysis-cpu OUT: the port's static
    verifier on the host (`python -m distributed_plonk_tpu_torch.analysis
    --strict --device cpu`: lints, carry contracts, interval bounds and
    exact values of every registry entry) and its seeded mutants
    (check_mutants); no card touched. Writes the pass counts, the mutant
    verdicts and the seconds to OUT. The set-up runs it beside nvcc;
    phase 17 reads it."""
    from distributed_plonk_tpu_torch.analysis import mutants
    from distributed_plonk_tpu_torch.analysis.__main__ import \
        main as analysis_main
    torch.set_num_threads(1)
    summary = {}
    t = time.perf_counter()
    rc = analysis_main(["--strict", "--device", "cpu", "-q"],
                       summary=summary)
    cli_s = time.perf_counter() - t
    verdicts = []
    t = time.perf_counter()
    errors = mutants.check_mutants(
        progress=lambda name, by, rejected: verdicts.append(
            [name, by, rejected]))
    out = {"rc": rc, "summary": summary, "cli_s": cli_s,
           "mutants": verdicts, "mutant_errors": errors,
           "mutants_s": time.perf_counter() - t}
    with open(out_path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(out_path + ".tmp", out_path)
    return 0 if rc == 0 and not errors else 1


ANALYSIS_KERNELS = ("mont_mul", "ntt", "msm_digits", "r3_gate_fold",
                    "r3_sigma_fold", "r3_combine", "msm_finish", "poly_eval")


def analysis_checks(smi, child, out_path, log_path, kernels):
    """Phase 17: the static verifier. The host half ran in the set-up's
    child (analysis_cpu_child): it must be clean, with every mutant
    rejected. Here the card half: run_values(device="cuda") holds every
    registry entry that has a kernel (kernel 1 on Fr and Fq, broadcast
    and strided, and through to_mont and from_mont; kernel 2 in all four
    modes in 1-3 passes; kernel 3's msm_digits; round 3's three folds at
    8 lanes; kernel 4's msm_finish at 2 windows; kernel 8's poly_eval,
    also through poly_eval_many) and the shapes of
    registry.card_entries() (kernel 1 at 2^16 lanes, kernel 2 at n = 2^13
    in each mode, msm_digits over a v1 round-1 batch, the folds at 2^12
    lanes, msm_finish over a round-1 batch on the base layout, poly_eval
    at v1's round 4) to their value contracts on the card, with the launch
    counters zeroed before and read after. Sets each kernel record's
    `analysis_entries`: the value entries held on the card."""
    from distributed_plonk_tpu_torch.analysis import registry as AR
    from distributed_plonk_tpu_torch.backend import _build
    t = time.perf_counter()
    if child.wait(timeout=600) != 0:
        with open(log_path) as f:
            raise AssertionError("the static verifier's host passes failed "
                                 "(child):\n" + f.read()[-6000:])
    with open(out_path) as f:
        host = json.load(f)
    summ = host["summary"]
    print("analysis child (started in the set-up, waited %.3f s): lint %d "
          "finding(s); contracts %s; bounds %s; values on the host %s "
          "(checked, violations); %.3f s; mutants %d/%d rejected in %.3f s"
          % (time.perf_counter() - t, summ["lint"], summ["contracts"],
             summ["bounds"], summ["values_cpu"], host["cli_s"],
             sum(1 for _, _, r in host["mutants"] if r),
             len(host["mutants"]), host["mutants_s"]), flush=True)
    assert summ["failures"] == 0 and host["rc"] == 0, summ
    assert host["mutant_errors"] == [], host["mutant_errors"]
    assert host["mutants"] and all(r for _, _, r in host["mutants"])

    entries = [e for e in AR.build_registry() + AR.card_entries()
               if e.kernel is not None and e.value is not None]
    rows = []
    last = [time.perf_counter()]

    def progress(name, violations):
        now = time.perf_counter()
        rows.append((name, len(violations), now - last[0]))
        last[0] = now
    _build.reset_launches()
    t = time.perf_counter()
    violations, checked = AR.run_values(strict=True, device="cuda",
                                        entries=entries, progress=progress)
    sync()
    card_s = time.perf_counter() - t
    launches = read_launches("the analysis phase", ANALYSIS_KERNELS)
    by_name = {e.name: e for e in entries}
    for name, nbad, secs in rows:
        e = by_name[name]
        print("analysis card %-42s %-10s samples %d  %.3f s  %s"
              % (name, e.launches, e.value.samples, secs,
                 "ok" if nbad == 0 else "%d VIOLATION(S)" % nbad),
              flush=True)
    for v in violations:
        print("  %s" % v, flush=True)
    assert violations == [], [str(v) for v in violations]
    assert checked == len(entries), (checked, len(entries))
    counts = {k: sum(1 for e in entries if e.launches == k)
              for k in ANALYSIS_KERNELS}
    for name, rec in kernels.items():
        rec["analysis_entries"] = counts.get(name, 0)
    print("analysis on the card (%s): %d value entries held to their "
          "contracts in %.3f s; entries per kernel %s; launches %s"
          % (smi, checked, card_s, json.dumps(counts),
             json.dumps({k: launches[k] for k in ANALYSIS_KERNELS})),
          flush=True)


def zoo_checks(dev, built, cpu_ref):
    """The circuit zoo over `built` (zoo_build): range and preimage prove
    on the card to the bytes of their proofs on the CPU's plain versions
    (cpu_ref, zoo_cpu_child's output); the rollup proves on TorchBackend
    and on MeshBackend over four shards to the same bytes. Every proof
    verifies. Returns the rollup's seconds by backend, and (circuit, warm
    TorchBackend, vk, proof bytes) of its TorchBackend run, which the
    service phase proves against."""
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
    from distributed_plonk_tpu_torch.parallel.mesh_backend import \
        MeshBackend

    for kind, _ in ZOO_KINDS:
        card, card_s, _ = zoo_prove(built[kind], TorchBackend(device=dev), 1,
                                    dev)
        read_launches("the zoo %s prove" % kind)
        cpu = bytes.fromhex(cpu_ref[kind]["blob"])
        assert card == [cpu], "zoo %s: card and CPU proofs differ" % kind
        print("zoo %s: card and CPU proofs equal, both verify; card "
              "preprocess %.3f s, prove %.3f s; CPU (plain versions, in "
              "the set-up's child process) preprocess %.3f s, prove %.3f s"
              % ((kind,) + tuple(card_s) + tuple(cpu_ref[kind]["secs"])),
              flush=True)
    ckt = built["rollup"]
    out = {}
    blobs = []
    for label, be in (("TorchBackend", TorchBackend(device=dev)),
                      ("MeshBackend", MeshBackend(make_mesh(4, dev)))):
        got, secs, vk = zoo_prove(ckt, be, 2, dev)
        if label == "TorchBackend":
            rollup = (ckt, be, vk, got[0])
        read_launches("the rollup's warm %s prove" % label,
                      BASE_KERNELS + ("proj_add",) if label == "MeshBackend"
                      else PATH_KERNELS)
        if label == "MeshBackend":
            assert not be.replicated_ntt_calls, be.replicated_ntt_calls
        blobs += got
        out[label] = secs
        print("zoo rollup (n = %d) on %s: preprocess %.3f s, cold prove "
              "%.3f s, warm prove %.3f s; verify ok"
              % ((ckt.n, label) + tuple(secs)), flush=True)
        del be
    assert len(set(blobs)) == 1, "rollup proofs differ"
    print("zoo rollup: TorchBackend and MeshBackend proofs (cold, warm) "
          "equal")
    return out, rollup


# the service phase's workloads: the reference's v1 and v2 Merkle
# workloads and the zoo's rollup at n = 2^16; scripts/torch_loadgen.py's
# jobs rotate over the v1 spec and two toy shapes (its kill target is its
# default, toy gates 300)
SERVICE_SPECS = {
    "v1": {"kind": "merkle", "height": 32, "num_proofs": 1},
    "rollup": {"kind": "rollup", "height": 16, "updates": 8},
    "v2": {"kind": "merkle", "height": 32, "num_proofs": 50},
    "loadgen": ([{"kind": "merkle", "height": 32, "num_proofs": 1},
                 {"kind": "toy", "gates": 16}, {"kind": "toy", "gates": 60}],
                None),
}
LOADGEN_LIMIT_S = 300
# the seed of phase 12's v1 jobs whose proofs are held to a direct prove
# (the kill job of step 3, step 5's first job): a job proves its circuit
# with Random(seed), so the fixture (circuit seed 11, prove seed 1) is no
# job's
V1_JOB_SEED = 11
# phase 13's crashed job carries this trace context (a client's, fixed so
# the journal's copy can be read back by value)
CRASH_CTX = {"trace_id": "5a" * 16, "parent_id": "6b" * 8}


def loadgen_checks(say, port, device, loadgen):
    """scripts/torch_loadgen.py --host/--port against the service on
    `port`, as a subprocess that builds its verification keys on `device`:
    one job per spec of `loadgen` = (specs, kill spec or None for the
    script's default) and the KILL_WORKER target. Every proof must verify
    client-side and the kill must show as a retry. Prints the summary and
    the per-kind p50/p95 seconds (of one or two samples: a smoke, not a
    latency under load); returns the ids of the jobs it finished
    (they are journaled, so a restarted service recovers them)."""
    specs, kill_spec = loadgen
    cmd = [sys.executable, os.path.join(HERE, "scripts", "torch_loadgen.py"),
           "--host", "127.0.0.1", "--port", str(port),
           "--jobs", str(len(specs)), "--timeout", str(LOADGEN_LIMIT_S)]
    for spec in specs:
        cmd += ["--spec", json.dumps(spec)]
    if kill_spec is not None:
        cmd += ["--kill-spec", json.dumps(kill_spec)]
    if device.type != "cuda":
        cmd += ["--device", str(device)]
    t = time.perf_counter()
    out = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=LOADGEN_LIMIT_S + 60)
    secs = time.perf_counter() - t
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert out.returncode == 0 and lines, (out.returncode, out.stdout[-4000:],
                                           out.stderr[-4000:])
    summary = json.loads(lines[-1])
    kill = summary["kill"]
    assert summary["ok"] and summary["verified"] == len(specs), summary
    assert kill["state"] == "done" and kill["verified"], kill
    assert kill["retries"] >= 1 and kill["victim"], kill
    assert summary["trace"]["adopted"] == len(specs), summary["trace"]
    say("scripts/torch_loadgen.py against the service: exit 0 in %.3f s "
        "(process start and client key builds included; the script's wall "
        "%.3f s); %d jobs and the kill target (%s, victim %s, retries %d, "
        "attempts %s) all verified client-side; placements %s" % (
            secs, summary["wall_s"], len(specs), kill["spec"]["kind"],
            kill["victim"], kill["retries"],
            [a["outcome"] for a in kill["attempts"]],
            json.dumps(summary["batch"]["placement"])))
    # one or two jobs per kind: a functional smoke of the script and the
    # service, not the service's latency under load (p95 of so few
    # samples is their maximum)
    for kind, k in summary["kinds"].items():
        say("loadgen %s: %d done (a functional smoke of %d sample(s), not "
            "a latency under load); submit to done p50 %.3f s, p95 %.3f s; "
            "run p50 %.3f s, p95 %.3f s" % (
                kind, k["done"], k["done"], k["p50_s"], k["p95_s"],
                k["run_p50_s"], k["run_p95_s"]))
    return summary["done_job_ids"]


def service_checks(smi, v1_ref, rollup_ref, v2_ref, device="cuda:0",
                   specs=SERVICE_SPECS):
    """The port's proof service on the card, driven over TCP by a
    ServiceClient the way a deployment is: bucket keys built on the card,
    v1 jobs batched through prove_many, the rollup on the pool, v2 on a
    leased 2-slot submesh of this card, a worker killed at round 2, the
    service crashed at a journal ROUND2 and restarted. Every proof equals
    a direct prove of the same circuit and key on an earlier phase's warm
    backend and verifies; the phase fails on any failed job, dispatch
    error, unexpected retry or recovery.

    The batch is deterministic: the rollup is submitted first and the
    four v1 jobs only once the scheduler has started the rollup's key
    build (its bucket_misses is 1). The scheduler is one thread, so the
    v1 jobs wait in the queue until that build is done, and its next pop
    takes all four (the pop takes every queued job of the head's shape,
    up to max_batch 8), and the pool proves a batch group as one
    prove_many call (it never folds a group into a round pipeline). The
    service runs at its defaults, as `python -m
    distributed_plonk_tpu_torch.service` does.

    v1_ref: phase 3's (warm backend, pk, vk); rollup_ref: the zoo phase's
    (circuit, warm backend, vk, proof bytes); v2_ref: phase 8's (circuit,
    warm backend, pk, vk). Returns the launch counts of the phase."""
    device = torch.device(device)
    from distributed_plonk_tpu_torch import aggregate as AGG, proof_io
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.runtime.faults import FaultInjector, Rule
    from distributed_plonk_tpu_torch.service import ProofService, \
        ServiceClient
    from distributed_plonk_tpu_torch.service.jobs import (
        JobSpec, build_circuit, shape_key)
    from distributed_plonk_tpu_torch.store import keycache as KC
    from distributed_plonk_tpu_torch.verifier import verify

    v1, rollup, v2 = specs["v1"], specs["rollup"], specs["v2"]
    workdir = tempfile.mkdtemp(prefix="dpt-service-")
    kw = dict(port=0, prover_workers=2, device=device,
              store_dir=os.path.join(workdir, "store"),
              journal_dir=os.path.join(workdir, "journal"))

    def say(msg):
        print("[%s] %s" % (smi, msg), flush=True)

    # (label, RESULT header, RESULT bytes, bucket vk, direct prove): held
    # to each other after the launch counters are read, so the direct
    # proves' launches do not count as the service's
    checks = []

    def check_proof(svc, header, blob, direct, label):
        res = svc.buckets.get(JobSpec.from_wire(header["spec"]))
        checks.append((label, header, blob, res.vk, direct))

    def direct_v1(seed):
        be, pk, _ = v1_ref
        spec = JobSpec.from_wire(dict(v1, seed=seed))
        return proof_io.serialize_proof(prove(
            random.Random(seed), build_circuit(spec), pk, be))

    def wait_done(c, jid, timeout_s=900):
        st = c.wait(jid, timeout_s=timeout_s, poll_s=0.1)
        assert st["state"] == "done", st
        return st

    t_phase = time.perf_counter()
    mem0 = reset_peak()
    done_blobs = {}
    steps = Steps(say)
    try:
        # --- service 1: four slots of this card, chaos on -------------------
        svc = ProofService(chaos=True, devices=[device] * 4, **kw).start()
        _build.reset_launches()
        try:
            with ServiceClient("127.0.0.1", svc.port) as c:
                rid = c.submit(dict(rollup, seed=3))["job_id"]
                deadline = time.monotonic() + 300
                while c.metrics()["counters"].get("bucket_misses", 0) < 1:
                    assert time.monotonic() < deadline, "rollup key build"
                    time.sleep(0.01)
                v1_ids = [c.submit(dict(v1, seed=s))["job_id"]
                          for s in (11, 12, 13, 14)]
                v2_id = c.submit(dict(v2, seed=11))["job_id"]
                sts = {jid: wait_done(c, jid) for jid in
                       [rid] + v1_ids + [v2_id]}
                for jid in v1_ids:
                    assert sts[jid]["placement"] == "batch", sts[jid]
                assert sts[rid]["placement"] == "pool", sts[rid]
                assert sts[v2_id]["placement"] == "mesh", sts[v2_id]
                assert max(sts[j]["batch_size"] for j in v1_ids) >= 2
                steps.done("the rollup, four v1 and the v2 job done")

                # each job's bytes against a direct prove on a warm backend
                res1 = svc.buckets.get(JobSpec.from_wire(v1))
                assert same_vk(res1.vk, v1_ref[2]), "v1 bucket vk"
                for seed, jid in zip((11, 12, 13, 14), v1_ids):
                    header, blob = c.result(jid)
                    check_proof(svc, header, blob,
                                functools.partial(direct_v1, seed),
                                "v1 seed %d" % seed)
                    done_blobs[jid] = blob
                r_ckt, r_be, r_vk, r_blob = rollup_ref
                res_r = svc.buckets.get(JobSpec.from_wire(rollup))
                assert same_vk(res_r.vk, r_vk), "rollup bucket vk"

                def direct_rollup():
                    want = proof_io.serialize_proof(prove(
                        random.Random(3), r_ckt, res_r.pk, r_be))
                    assert want == r_blob, "rollup: the bucket pk's prove " \
                        "differs from the zoo phase's proof"
                    return want
                header, blob = c.result(rid)
                check_proof(svc, header, blob, direct_rollup, "rollup")
                done_blobs[rid] = blob
                ckt2, be2, pk2, vk2 = v2_ref
                res2 = svc.buckets.get(JobSpec.from_wire(v2))
                assert same_vk(res2.vk, vk2), "v2 bucket vk"
                header, blob = c.result(v2_id)
                check_proof(svc, header, blob, lambda: proof_io.
                            serialize_proof(prove(random.Random(11), ckt2,
                                                  pk2, be2)), "v2")
                done_blobs[v2_id] = blob
                mesh_be, = svc.scheduler._mesh_backends.values()
                assert mesh_be.mesh.size == 2, mesh_be.mesh
                assert mesh_be.mesh_msm_calls > 0
                say("v2 proved on %r (%d mesh MSM calls)"
                    % (mesh_be.mesh, mesh_be.mesh_msm_calls))

                # aggregate the four v1 jobs
                t = time.perf_counter()
                rep = c.aggregate(v1_ids)
                agg = c.fetch_aggregate(rep["agg_id"])
                assert AGG.verify(agg, {shape_key(JobSpec.from_wire(v1)):
                                        res1.vk})
                say("aggregate of the 4 v1 jobs: built in %.3f s on the "
                    "server, fetched and verified in %.3f s"
                    % (rep["build_s"], time.perf_counter() - t))
                steps.done("RESULT, AGGREGATE")

                m = c.metrics()
                ctr, hist = m["counters"], m["histograms"]
                assert ctr.get("bucket_misses") == 3, ctr
                assert ctr.get("placement_batch", 0) >= 1, ctr
                assert ctr.get("placement_pool", 0) >= 1, ctr
                assert ctr.get("placement_mesh") == 1, ctr
                assert ctr.get("batch_jobs", 0) >= 2, ctr
                assert ctr.get("batch_proves", 0) >= 1, ctr
                assert ctr.get("jobs_completed") == 6, ctr
                for k in ("job_retries", "dispatch_errors", "jobs_failed",
                          "checkpoint_resumes", "jobs_recovered",
                          "pipelined_proves"):
                    assert k not in ctr, (k, ctr)
                for r in range(1, 6):
                    assert hist["prove_round/round%d" % r]["count"] >= 6
                for jid, st in sts.items():
                    say("job %s %s seed %s: placement %s, wait %.3f s, run "
                        "%.3f s, rounds %s" % (
                            jid, st["spec"]["kind"], st["spec"]["seed"],
                            st["placement"], st["wait_s"], st["run_s"],
                            json.dumps(st["rounds"])))
                for label, spec in (("v1", v1), ("rollup", rollup),
                                    ("v2", v2)):
                    say("key build %s: %.3f s (bucket n = %d)" % (
                        label, svc.buckets.get(JobSpec.from_wire(spec))
                        .build_s, svc.buckets.get(JobSpec.from_wire(spec))
                        .domain_size))

                # --- kill: each worker armed at round 2, one v1 job ---------
                for wk in svc.pool.workers():
                    c.kill_worker(worker=wk.name, at_round=2)
                kid = c.submit(dict(v1, seed=15))["job_id"]
                st = wait_done(c, kid)
                assert st["retries"] == 1, st
                assert [a["outcome"] for a in st["attempts"]] == \
                    ["killed", "ok"], st["attempts"]
                header, blob = c.result(kid)
                check_proof(svc, header, blob,
                            functools.partial(direct_v1, 15), "killed v1")
                done_blobs[kid] = blob
                ctr = c.metrics()["counters"]
                assert ctr.get("job_retries") == 1, ctr
                assert ctr.get("workers_killed") == 1, ctr
                assert ctr.get("checkpoint_resumes") == 1, ctr
                assert "dispatch_errors" not in ctr, ctr
                say("kill at round 2: retried once, resumed from round 2's "
                    "snapshot, bytes equal the direct prove (run %.3f s)"
                    % st["run_s"])
                steps.done("METRICS, the kill at round 2")
                build = c.metrics()["build"]
                say("the service's kernel build: %s" % json.dumps(build))
                if device.type == "cuda":
                    # found in the build directory: the service installed
                    # nothing, and its source stays the set-up's (nvcc
                    # where this process ran it, else local)
                    assert build["source"] == (
                        "nvcc" if _build.build_seconds else "local"), build
                    assert build["install_s"] is None, build

                # the operator's load generator against this service
                loadgen_done = loadgen_checks(say, svc.port, device,
                                              specs["loadgen"])
                steps.done("scripts/torch_loadgen.py")
        finally:
            svc.shutdown()

        # --- service 2: crash() at the job's journal ROUND2 -----------------
        box = {}
        faults = FaultInjector([Rule("kill", tag="ROUND2", plane="journal")],
                               kill_cb=lambda _label: box["svc"].crash())
        svc = box["svc"] = ProofService(chaos=True, faults=faults, **kw)
        svc.start()
        crash_spec = dict(v1, seed=16, job_key="crash-16",
                          trace_ctx=CRASH_CTX)
        job = svc.submit_local(crash_spec)
        assert (job.trace_id, job.trace_parent) == (
            CRASH_CTX["trace_id"], CRASH_CTX["parent_id"])
        deadline = time.monotonic() + 300
        while not svc._stopped.is_set() or svc.pool.busy():
            assert time.monotonic() < deadline, "the journal-plane crash"
            time.sleep(0.02)
        assert job.state != "done"
        assert faults.counts() == {"kill@ROUND2": {"seen": 1, "fired": 1}}
        ctr = svc.metrics.snapshot()["counters"]
        assert ctr.get("jobs_recovered_finished") == \
            len(done_blobs) + len(loadgen_done), ctr
        steps.done("service 2, crashed at a journal ROUND2")

        # --- service 3: restart on the same store and journal ----------------
        svc = ProofService(**kw).start()
        try:
            # the journal's trace identity, read before any resubmission
            t = time.perf_counter()
            rec = svc.get_job(job.id)
            assert (rec.trace_id, rec.trace_parent) == (
                CRASH_CTX["trace_id"], CRASH_CTX["parent_id"]), \
                (rec.trace_id, rec.trace_parent)
            ctx_s = time.perf_counter() - t
            for jid, blob in done_blobs.items():
                old = svc.get_job(jid)
                assert old.state == "done" and old.proof_bytes == blob, jid
            again, deduped = svc.submit_ex(crash_spec)
            assert deduped and again is rec
            assert again.done_event.wait(300) and again.state == "done", \
                again.error
            t = time.perf_counter()
            stored = KC.load_trace(svc.store, again.id)
            assert stored["trace_id"] == CRASH_CTX["trace_id"], \
                stored["trace_id"]
            roots = [e for e in stored["events"]
                     if e.get("parent") == CRASH_CTX["parent_id"]]
            assert roots, stored["events"][:3]
            chained = chained_to(stored["events"], CRASH_CTX["parent_id"])
            assert len(chained) == len(stored["events"]), \
                (len(chained), len(stored["events"]))
            say("restart trace context: the recovered job %s keeps trace %s "
                "and parent %s from the journal; its stored trace:%s has "
                "that id, %d spans parented to the context's parent (%s), "
                "all %d chain up to it; check %.6f s" % (
                    again.id, again.trace_id, again.trace_parent, again.id,
                    len(roots), ", ".join(sorted({e["span"] for e in roots})),
                    len(stored["events"]),
                    ctx_s + time.perf_counter() - t))
            header = {"spec": again.spec.to_wire(),
                      "public_input": [hex(x) for x in again.public_input]}
            check_proof(svc, header, again.proof_bytes,
                        functools.partial(direct_v1, 16), "crashed v1")
            m = svc.metrics.snapshot()
            ctr, hist = m["counters"], m["histograms"]
            assert ctr.get("jobs_recovered_finished") == \
                len(done_blobs) + len(loadgen_done), ctr
            assert ctr.get("jobs_recovered") == 1, ctr
            assert ctr.get("checkpoint_resumes", 0) >= 1, ctr
            assert ctr.get("bucket_disk_hits", 0) >= 1, ctr
            assert "bucket_misses" not in ctr, ctr
            assert "prove_round/round1" not in hist, hist.keys()
            for k in ("job_retries", "dispatch_errors", "jobs_failed"):
                assert k not in ctr, (k, ctr)
            say("restart: %d finished jobs (and the loadgen's %d) served "
                "from their proof artifacts; the crashed job resumed from "
                "its store checkpoint after round 2 (no round 1) to the "
                "direct prove's bytes; v1 keys loaded from disk in %.3f s"
                % (len(done_blobs), len(loadgen_done),
                   hist["bucket_disk_load"]["sum_s"]))
        finally:
            svc.shutdown()
        steps.done("service 3, restarted")
        launches = read_launches("the service phase", PATH_KERNELS + (
            "proj_add", "proj_add_mixed"))
        say("service phase: %.3f s, peak device memory above the resident "
            "%.1f MiB; launches %s" % (time.perf_counter() - t_phase,
                                       peak_mib(mem0), json.dumps(launches)))
        direct_s = {}
        for label, header, blob, vk, direct in checks:
            t = time.perf_counter()
            want = direct()
            sync()
            direct_s[label] = round(time.perf_counter() - t, 3)
            assert blob == want, "%s: service bytes differ from the " \
                "direct prove" % label
            pub = [int(x, 16) for x in header["public_input"]]
            assert verify(vk, pub, proof_io.deserialize_proof(blob),
                          rng=random.Random(2)), "%s: verify" % label
        steps.done("the direct proves")
        say("every service proof equals its direct prove on an earlier "
            "phase's warm backend (v1 on phase 3's, the rollup on the "
            "zoo's with the bucket's pk, v2 on phase 8's; circuit build "
            "included, one thread, seconds: %s) and verifies under the "
            "bucket's vk" % json.dumps(direct_s))
        return launches
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


DAEMON_LIMIT_S = 300
CONSOLE = os.path.join(HERE, "scripts", "console.py")


def daemon_checks(smi, v1_ref, device="cuda:0",
                  spec=SERVICE_SPECS["v1"], seed=11):
    """The daemon step (13b): `python -m distributed_plonk_tpu_torch.service`
    as an operator starts it, a child with --port 0 --obs-port 0, a
    temporary store and journal, --build-dir at this run's build (so no
    second nvcc) and --autoscale dry. Its start line must name the
    device and the dry mode; over TCP (the port's ServiceClient): PING,
    WARMUP of the v1 spec twice ("built", then "memory"; moved here from
    phase 13) and one v1 job (circuit seed `seed`, prove rng
    Random(seed)) whose bytes equal its direct prove on phase 3's warm
    backend `v1_ref` = (backend, pk, vk) and verify under that vk; on the
    card the job must launch every kernel of PATH_KERNELS in the daemon's
    process (METRICS' `launches`, read just before and just after the
    job); /autoscale shows mode dry, ticks, and no decision applied;
    scripts/console.py --once --logs 5 exits 0 and prints the service's
    readiness; METRICS shows the kernels found in the build directory
    (no nvcc) and no actuation; SIGTERM drains it and it exits 0. Prints
    its start-to-listening seconds, the job's wait and run seconds and
    its launches (the daemon reports no peak device memory); returns the
    launches."""
    from distributed_plonk_tpu_torch import proof_io
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.service import ServiceClient
    from distributed_plonk_tpu_torch.service.jobs import JobSpec, \
        build_circuit
    from distributed_plonk_tpu_torch.verifier import verify

    def say(msg):
        print("[%s] %s" % (smi, msg), flush=True)

    device = torch.device(device)
    be, pk, vk = v1_ref
    workdir = tempfile.mkdtemp(prefix="dpt-daemon-")
    cmd = [sys.executable, "-m", "distributed_plonk_tpu_torch.service",
           "--port", "0", "--obs-port", "0",
           "--store-dir", os.path.join(workdir, "store"),
           "--journal-dir", os.path.join(workdir, "journal"),
           "--autoscale", "dry"]
    if device.type == "cuda":
        cmd += ["--build-dir", os.path.dirname(_build.build_dir())]
    else:
        cmd += ["--device", str(device)]
    steps = Steps(say)
    log = open(os.path.join(workdir, "daemon.log"), "w")
    t = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=log,
                         text=True, start_new_session=True)
    try:
        start = None
        while start is None:
            assert time.perf_counter() - t < DAEMON_LIMIT_S, \
                "no start line from the daemon"
            assert p.poll() is None, "the daemon exited before listening"
            if select.select([p.stdout], [], [], 1.0)[0]:
                line = p.stdout.readline()
                if line.startswith("{"):
                    start = json.loads(line)
        listen_s = time.perf_counter() - t
        say("daemon start line after %.3f s: %s" % (listen_s,
                                                    line.strip()))
        assert start["device"] == ("cuda:0" if device.type == "cuda"
                                   else str(device)), start
        assert start["autoscale"] == "dry", start
        steps.done("the daemon listening")
        host, port = start["listening"].rsplit(":", 1)
        obs = "http://" + start["obs"]
        with ServiceClient(host, int(port)) as c:
            c.ping()
            w = [c.warmup(spec), c.warmup(spec)]
            assert [x["source"] for x in w] == ["built", "memory"], w
            steps.done("PING, WARMUP twice (the keys built, then memory)")
            before = c.metrics()["launches"]
            jid = c.submit(dict(spec, seed=seed))["job_id"]
            st = c.wait(jid, timeout_s=DAEMON_LIMIT_S, poll_s=0.1)
            assert st["state"] == "done", st
            ctr = c.metrics()
            header, blob = c.result(jid)
            steps.done("one v1 job")
        launches = {k: v - before[k] for k, v in ctr["launches"].items()}
        if device.type == "cuda":
            missing = [k for k in PATH_KERNELS if not launches[k]]
            assert not missing, ("the daemon's v1 job", missing, launches)
        built = ctr["build"]
        counters = ctr["counters"]
        if device.type == "cuda":
            assert built["source"] == "local" and built["nvcc_s"] is None, \
                built
        with urllib.request.urlopen(obs + "/autoscale", timeout=30) as r:
            asc = json.loads(r.read())
        assert asc["mode"] == "dry" and asc["ticks"] >= 1, asc
        assert not any(d["applied"] for d in asc["last_decisions"]), asc
        applied = {k: v for k, v in counters.items() if k in (
            "autoscale_scale_ups", "autoscale_scale_downs",
            "autoscale_lease_resizes", "autoscale_sheds")}
        assert counters.get("autoscale_ticks", 0) >= 1 and not applied, \
            counters
        out = subprocess.run([sys.executable, CONSOLE, "--obs",
                              start["obs"], "--once", "--logs", "5"],
                             cwd=HERE, capture_output=True, text=True,
                             timeout=60)
        assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
        lines = out.stdout.splitlines()
        assert lines and lines[0].startswith("service  ok=True"), lines
        assert any(ln.startswith("autoscale mode=dry") for ln in lines)
        steps.done("/autoscale and scripts/console.py --once")
        for ln in lines:
            say("console | " + ln)
        p.send_signal(signal.SIGTERM)
        rest, _ = p.communicate(timeout=60)
        assert p.returncode == 0, (p.returncode, rest)
        drained = json.loads(rest.strip().splitlines()[-1])
        assert drained["drained"] == "SIGTERM" and drained["clean"], drained
        steps.done("SIGTERM drained, exit 0")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
        with open(os.path.join(workdir, "daemon.log")) as f:
            tail = f.read()[-3000:]
        shutil.rmtree(workdir, ignore_errors=True)
    # the job's bytes against its direct prove on phase 3's warm backend
    # and keys, and verify under their vk
    job_ckt = build_circuit(JobSpec.from_wire(dict(spec, seed=seed)))
    want = proof_io.serialize_proof(prove(random.Random(seed), job_ckt, pk,
                                          be))
    assert blob == want, "the daemon's proof differs from the direct prove"
    assert verify(vk, [int(x, 16) for x in header["public_input"]],
                  proof_io.deserialize_proof(blob), rng=random.Random(2))
    say("daemon: one v1 job (seed %d) equal to its direct prove on phase "
        "3's warm backend, verifies; wait %.3f s, run %.3f s, placement "
        "%s; launches in the daemon %s; the kernels from the build "
        "directory (%s); /autoscale mode %s after %d ticks, decisions %d, "
        "none applied; SIGTERM: %s; the daemon reports no peak device "
        "memory" % (
            seed, st["wait_s"], st["run_s"], st["placement"],
            json.dumps(launches), built["source"], asc["mode"],
            asc["ticks"], len(asc["last_decisions"]), json.dumps(drained)))
    if tail.strip():
        say("daemon stderr tail: " + tail.strip().replace("\n", " | ")
            [-1000:])
    return launches


ELASTIC_KERNELS = ("mont_mul", "ntt", "msm_digits", "bucket_sums",
                   "msm_tail", "proj_add")
LIAR = "corrupt:at=data:tag=MSM:rate=1"


def health_launches(d, label, kind="cuda"):
    """{fleet index: (uptime, launches, peak MiB)} of every member that
    answers HEALTH (LEAVEd members are skipped); each must run on a device
    of `kind`."""
    out = {}
    for i, w in enumerate(d.workers):
        if d._left(i):
            continue
        snap = w.probe(timeout_ms=10000)
        assert snap is not None, (label, "worker %d answers no HEALTH" % i)
        assert snap["device"].startswith(kind), (label, i, snap["device"])
        out[i] = (snap["uptime_s"], snap["launches"], snap["peak_mib"])
    return out


def elastic_delta(before, after, label, must=ELASTIC_KERNELS, exempt=()):
    """Per-member launches between two health_launches() reads (a member
    whose process restarted in between counts its new process's
    launches); every member in `after` but those in `exempt` must have
    launched every kernel of `must`. Returns the sum over the members."""
    total = collections.Counter()
    for i, (up, launches, _peak) in sorted(after.items()):
        b = before.get(i)
        delta = dict(launches) if b is None or b[0] > up else \
            {k: launches[k] - b[1][k] for k in launches}
        missing = [k for k in must if not delta.get(k) and i not in exempt]
        assert not missing, (label, i, missing, delta)
        print("  worker %d launches in %s: %s" % (
            i, label, json.dumps({k: v for k, v in delta.items() if v})))
        total.update(delta)
    return total


def chained_to(events, root):
    """The events of a dump whose parent links lead to span id `root`
    (the span itself recorded elsewhere: a client's, or an adopted
    context's parent)."""
    parent = {e.get("sid"): e.get("parent") for e in events}
    out = []
    for e in events:
        p, hops = e.get("parent"), 0
        while p != root and p in parent and hops < len(events):
            p, hops = parent[p], hops + 1
        if p == root:
            out.append(e)
    return out


def incident_checks(svc, obs, job, say, client_ctx=None):
    """The incident of phase 12's step 3 read off one artifact: the job's
    timeline merged with the fleet's (ProofService.merge_fleet_trace)
    carries the job's trace id on every log event; dispatcher, supervisor
    and worker events; the dispatcher's recovery event and the
    supervisor's respawn; spans of a worker/ process; and lost_workers
    naming worker 1 or nothing (its replacement answered). /trace/<job_id>
    serves it raw and as Chrome trace events with the respawn as an
    instant. Prints the spans by process and the log events by subsystem
    and event, and the seconds of the merge.

    client_ctx: the Tracer.context() dict the job was submitted with.
    Then the job, the merged dump and its raw HTTP form carry the
    client's trace id (not the dispatcher tracer's), the job's parent is
    the client's span, at least one pool/ span is parented to that span
    and every pool/ span chains up to it, and worker spans are still in
    the dump; one more line prints the ids and the check's seconds.
    Returns the merged dump."""
    t = time.perf_counter()
    merged = svc.merge_fleet_trace(job.id)
    merge_s = time.perf_counter() - t
    logs = merged["logs"]
    assert merged["trace_id"] == job.trace_id, merged["trace_id"]
    assert all(e.get("trace_id") == job.trace_id for e in logs)
    subsystems = {e["subsystem"] for e in logs}
    assert {"dispatcher", "supervisor", "worker"} <= subsystems, subsystems
    assert any(e["subsystem"] == "dispatcher" and e["event"] in (
        "fft_replan", "fft_degraded", "range_adopted") for e in logs)
    assert any(e["subsystem"] == "supervisor" and e["event"] == "respawn"
               for e in logs)
    spans = collections.Counter(str(e.get("proc")) for e in merged["events"])
    assert any(p.startswith("worker/") for p in spans), spans
    assert merged["lost_workers"] in ([], [1]), merged["lost_workers"]
    base = "http://%s:%d/trace/%s" % (obs.host, obs.port, job.id)
    t = time.perf_counter()
    with urllib.request.urlopen(base + "?raw=1", timeout=60) as r:
        raw = json.loads(r.read())
    with urllib.request.urlopen(base, timeout=60) as r:
        chrome = json.loads(r.read())
    http_s = time.perf_counter() - t
    assert raw["trace_id"] == job.trace_id, raw["trace_id"]
    instants = [e for e in chrome["traceEvents"] if e.get("ph") == "i"]
    assert any(e["name"] == "supervisor/respawn" for e in instants)
    if client_ctx is not None:
        t = time.perf_counter()
        tid, sid = client_ctx["trace_id"], client_ctx["parent_id"]
        assert (job.trace_id, job.trace_parent) == (tid, sid), \
            (job.trace_id, job.trace_parent)
        assert merged["trace_id"] == raw["trace_id"] == tid
        assert chrome["otherData"]["trace_id"] == tid
        fleet_tid = svc.fleet_dispatcher.tracer.trace_id
        assert fleet_tid != tid, fleet_tid
        pool = [e for e in merged["events"]
                if str(e.get("proc")).startswith("pool/")]
        direct = [e for e in pool if e.get("parent") == sid]
        assert direct, [(e["span"], e.get("parent")) for e in pool[:5]]
        chained = chained_to(pool, sid)
        assert len(chained) == len(pool), (len(chained), len(pool))
        workers = sum(n for p, n in spans.items() if p.startswith("worker/"))
        assert workers > 0, spans
        say("step 3 trace context: the client's trace %s (span %s) is the "
            "job's, the merged trace:%s's and /trace/%s?raw=1's (the "
            "dispatcher tracer's %s is not); %d of %d pool/ spans parented "
            "to the client's span (%s), all %d chain up to it; %d worker "
            "spans under it; check %.6f s" % (
                tid, sid, job.id, job.id, fleet_tid, len(direct), len(pool),
                ", ".join(sorted({e["span"] for e in direct})), len(pool),
                workers, time.perf_counter() - t))
    events = collections.Counter("%s/%s" % (e["subsystem"], e["event"])
                                 for e in logs)
    say("step 3 incident: merge_fleet_trace %.3f s (both /trace/%s forms "
        "over HTTP %.3f s); %d spans by process %s; %d log events by "
        "subsystem %s, by event %s; lost_workers %s" % (
            merge_s, job.id, http_s, len(merged["events"]),
            json.dumps(dict(sorted(spans.items()))), len(logs),
            json.dumps(dict(sorted(collections.Counter(
                e["subsystem"] for e in logs).items()))),
            json.dumps(dict(sorted(events.items()))),
            merged["lost_workers"]))
    return merged


def elastic_checks(smi, ckt, pk, vk, golden, v1_ref, device="cuda:0",
                   v1_spec=SERVICE_SPECS["v1"]):
    """The elastic fleet on this card: port workers spawned by the port's
    WorkerSupervisor (`--join`, each its own process and CUDA context, the
    kernels already built), joined through the dispatcher's membership
    server, proving the reference's v1 workload through RemoteBackend with
    every NTT sharded:

    1. two supervised workers: the proof equals the fixture;
    2. add_slot twice: both JOIN, the epoch rises, the next prove's
       sharded FFT plans over 4 (each worker serves FFT2); the fixture;
    3. kill:at=proc:tag=FFT1:worker=1:nth=1 through sup.proc_killer(d),
       under a v1 job (seed V1_JOB_SEED) of a ProofService proving
       through RemoteBackend over this fleet, whose dispatcher carries a
       Tracer from step 1: the prove replans and equals the direct
       TorchBackend prove of the same spec; the victim is respawned and
       re-joins at its index with warm stats; heal seconds; then
       merge_fleet_trace(job) is the incident's one artifact (incident_
       checks: the job's trace id on every log event, dispatcher,
       supervisor and worker events, worker spans, lost_workers), also
       served at /trace/<job_id>;
    4. a fifth slot whose first process lies about its MSM partials
       (--faults corrupt:at=data:tag=MSM:rate=1) under duplicate execution
       of every range: the prove catches and quarantines it (LEAVE), the
       supervisor replaces it with a clean process that passes the
       known-answer challenge and rejoins, the proof equals the fixture;
       a worker that still lies fails run_challenge;
    5. a ProofService proving through RemoteBackend over a fresh
       one-worker fleet, with the actuating autoscaler (1 to 2 workers):
       three v1 jobs (seeds 11-13, the first flagship) queue, the
       autoscaler scales up (a JOIN), every proof equals its direct
       TorchBackend prove on `v1_ref` (in the child: its own backend and
       v1 keys), and the idle service retires back to one worker by
       drain-then-LEAVE, with no respawn and no flap.

    Every worker of each step must launch every kernel of the fleet
    prove's path (ELASTIC_KERNELS). Prints each prove's seconds, each
    worker's spawn-to-JOIN seconds, the heal seconds, the autoscaler's
    decisions with their ticks, peak device memory (this process above
    its resident, and each worker's) and each worker's launches, beside
    the card's name and power limit. Returns the launches summed over the
    workers and steps."""
    from distributed_plonk_tpu_torch import proof_io
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.runtime import protocol
    from distributed_plonk_tpu_torch.runtime.dispatcher import (
        Dispatcher, RemoteBackend, WorkerHandle)
    from distributed_plonk_tpu_torch.runtime.faults import (FaultInjector,
                                                            Rule)
    from distributed_plonk_tpu_torch.runtime.integrity import MSM_DUP_RATE
    from distributed_plonk_tpu_torch.runtime.netconfig import NetworkConfig
    from distributed_plonk_tpu_torch.runtime.supervisor import (
        WorkerSupervisor, reserve_port)
    from distributed_plonk_tpu_torch.service import ObsServer, ProofService
    from distributed_plonk_tpu_torch.service.jobs import (
        JobSpec, build_circuit, shape_key)
    from distributed_plonk_tpu_torch.service.metrics import Metrics
    from distributed_plonk_tpu_torch.store import keycache
    from distributed_plonk_tpu_torch.store.artifacts import ArtifactStore
    from distributed_plonk_tpu_torch.trace import Tracer

    def say(msg):
        print("[%s] %s" % (smi, msg), flush=True)

    def wait_for(cond, label, timeout_s=120):
        deadline = time.monotonic() + timeout_s
        while True:
            got = cond()
            if got:
                return got
            assert time.monotonic() < deadline, "elastic: " + label
            time.sleep(0.05)

    def ctr(metrics, name):
        return metrics.snapshot()["counters"].get(name, 0)

    kind = torch.device(device).type
    # the workers' --device: none on the card (their default)
    worker_dev = None if kind == "cuda" else kind
    dev_args = [] if worker_dev is None else ["--device", worker_dev]
    t_phase = time.perf_counter()
    mem0 = reset_peak()
    steps = Steps(say)
    workdir = tempfile.mkdtemp(prefix="dpt-elastic-")
    total = collections.Counter()
    procs = []
    sups, dispatchers = [], []
    joins = []      # (monotonic time, membership join event)

    def fleet(n, metrics, faults=None, spawn_cmd=None, tracer=None):
        """A membership dispatcher and n supervised workers on the card,
        with each join's spawn-to-JOIN seconds printed."""
        d = Dispatcher(NetworkConfig([]), metrics=metrics, faults=faults,
                       tracer=tracer)
        mserver = d.enable_membership()
        sup = WorkerSupervisor("127.0.0.1", mserver.port, n=n,
                               device=worker_dev, store_dirs=[os.path.join(
                                   workdir, "s%d-%d" % (len(sups), i))
                                   for i in range(n)],
                               metrics=metrics, cwd=HERE)
        if spawn_cmd is not None:
            sup.spawn_cmd = functools.partial(spawn_cmd, sup)

        def on_join(ev):
            if ev.get("event") != "join":
                return
            joins.append((time.monotonic(), ev))
            j = sup.slot_for_port(ev["port"])
            if j is not None:
                say("worker %d (slot %d) %s: spawn to JOIN %.3f s, epoch %d"
                    % (ev["index"], j, "rejoined" if ev["rejoin"]
                       else "joined",
                       time.monotonic() - sup.slots[j].spawned_at,
                       ev["epoch"]))
        d.membership.subscribe(on_join)
        sup.attach_registry(d.membership)
        sups.append(sup)
        dispatchers.append(d)
        sup.start()
        return d, sup

    def wait_width(d, k):
        wait_for(lambda: len(d.workers) >= k
                 and len(d.tracker.usable_set()) >= k, "width %d" % k)

    def fleet_prove(d, label, be=None, settle=None):
        """One v1 prove through the fleet; `settle()` runs before the
        launches are read again (a replacement still joining)."""
        before = health_launches(d, label, kind)
        stats0 = d.stats()
        be = be or RemoteBackend(d, dist_fft_min=ckt.n)
        t = time.perf_counter()
        proof = prove(random.Random(1), ckt, pk, be)
        secs = time.perf_counter() - t
        assert proof_io.serialize_proof(proof) == golden, label
        if settle is not None:
            settle()
        after = health_launches(d, label, kind)
        served = [i for i, (s0, s1) in enumerate(zip(stats0, d.stats()))
                  if s1.get(str(protocol.FFT2), 0) > s0.get(
                      str(protocol.FFT2), 0)]
        say("%s: %.3f s, equal to the fixture; sharded FFT over %d "
            "workers %s, epoch %d" % (label, secs, len(served), served,
                                      d.epoch))
        total.update(elastic_delta(before, after, label))
        return be, served

    try:
        metrics = Metrics()
        faults = FaultInjector([], metrics=metrics)
        liar = {"slot": None, "spawned": 0}

        def spawn_cmd(sup, i, slot):
            cmd = sup.worker_cmd(i, slot)
            if i == liar["slot"] and not liar["spawned"]:
                liar["spawned"] += 1     # only the first process lies
                cmd += ["--faults", LIAR]
            return cmd

        # slot 0's store, provisioned offline as an operator would:
        # scripts/torch_warmup.py --aot builds the v1 bucket's keys and
        # publishes this tree's kernel build (kbuild:), what a warm rejoin
        # pulls from its store peers (step 3). It runs beside steps 1-2.
        v1_key = shape_key(JobSpec.from_wire(v1_spec))
        bucket = keycache.bucket_store_key(v1_key)
        s00 = os.path.join(workdir, "s0-0")
        t_warm = time.monotonic()
        warm_proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "scripts", "torch_warmup.py"),
             "--store-dir", s00, "--aot", "--spec", json.dumps(v1_spec),
             *dev_args], cwd=HERE, stdout=subprocess.PIPE, text=True)
        procs.append(warm_proc)

        # --- 1. two supervised workers --------------------------------------
        t = time.perf_counter()
        d, sup = fleet(2, metrics, faults=faults, spawn_cmd=spawn_cmd,
                       tracer=Tracer(proc="dispatcher"))
        wait_width(d, 2)
        say("step 1: 2 workers joined in %.3f s" % (time.perf_counter() - t))
        _be, served = fleet_prove(d, "step 1 prove (2 workers)")
        assert served == [0, 1], served
        steps.done("1")

        # --- 2. two more slots JOIN: the next prove plans over 4 ------------
        epoch = d.epoch
        for _ in range(2):
            sup.add_slot(store_dir=os.path.join(
                workdir, "s0-%d" % len(sup.slots)))
        wait_width(d, 4)
        assert d.epoch == epoch + 2, (epoch, d.epoch)
        _be, served = fleet_prove(d, "step 2 prove (4 workers)")
        assert served == [0, 1, 2, 3], served

        # slot 0's store is provisioned by now
        warm_out = warm_proc.communicate(timeout=600)[0]
        assert warm_proc.returncode == 0, warm_out
        warm_line = json.loads(warm_out.strip().splitlines()[-1])
        say("scripts/torch_warmup.py --aot provisioned slot 0's store beside "
            "steps 1-2 (its wall %.3f s; %.3f s from its spawn to this "
            "step): %s" % (warm_line["wall_s"], time.monotonic() - t_warm,
                           json.dumps(warm_line)))
        assert warm_line["ok"] and warm_line["shapes"][0]["source"] == \
            "built", warm_line
        assert ArtifactStore(s00).get(bucket) is not None
        kbuild = warm_line["kernel_build"]
        if kind == "cuda":
            assert kbuild["key"].startswith("kbuild:") and \
                kbuild["bytes"] > 0, warm_line
            assert kbuild["key"] in ArtifactStore(s00).keys()
        steps.done("2 (and the warmup's wait)")

        # --- 3. a proc kill mid-prove, under a service job, heals at the
        # same index; the incident reads off one merged artifact ----------
        be, v1_pk, _ = v1_ref
        # the direct TorchBackend prove of the job's spec (step 5's first
        # job has the same spec): the service proves with Random(seed),
        # so the fixture's prove seed cannot be a job's
        job_spec = dict(v1_spec, seed=V1_JOB_SEED)
        t = time.perf_counter()
        want_job = proof_io.serialize_proof(prove(
            random.Random(V1_JOB_SEED),
            build_circuit(JobSpec.from_wire(job_spec)), v1_pk, be))
        say("step 3: the direct TorchBackend prove of the job's spec "
            "(seed %d): %.3f s" % (V1_JOB_SEED, time.perf_counter() - t))
        victim_port = d.workers[1].port
        # the victim's replacement starts on an empty disk and an empty
        # build directory, so its warm rejoin must pull the kernel build
        # and the bucket from a store peer (slot 0's), and run no nvcc
        fresh_store = os.path.join(workdir, "s0-victim")
        fresh_build = os.path.join(workdir, "b0-victim")
        victim_slot = sup.slots[sup.slot_for_port(victim_port)]
        victim_slot.store_dir = fresh_store
        victim_slot.build_dir = fresh_build
        kill_at = []
        proc_kill = sup.proc_killer(d)

        def stamped_kill(i):
            kill_at.append(time.monotonic())
            proc_kill(i)
        faults.proc_kill_cb = stamped_kill
        faults.rules.append(Rule.parse("kill:at=proc:tag=FFT1:worker=1:nth=1"))
        # the service proves on slot 0's v1 bucket, copied into its own
        # store (no key build), through this fleet
        s00_store = ArtifactStore(s00)
        ArtifactStore(os.path.join(workdir, "svc3")).put(
            bucket, s00_store.get(bucket), meta=s00_store.meta(bucket))
        svc3 = ProofService(
            port=0, prover_workers=1, device=torch.device(device),
            store_dir=os.path.join(workdir, "svc3"),
            backend_factory=lambda: RemoteBackend(d, dist_fft_min=ckt.n))
        svc3.attach_fleet(d, interval_s=1.0)
        obs3 = ObsServer(svc3).start()
        try:
            svc3.start()
            before = health_launches(d, "step 3", kind)
            # a client's span: the job carries its context, which the
            # service adopts (the job's trace id and parent)
            client = Tracer(proc="client")
            t = time.perf_counter()
            with client.span("client/submit_wait") as client_sid:
                client_ctx = client.context()
                job = svc3.submit_local(dict(job_spec, trace_ctx=client_ctx))
                assert job.done_event.wait(600) and job.state == "done", \
                    (job.state, job.error)
            secs = time.perf_counter() - t
            assert client_ctx == {"trace_id": client.trace_id,
                                  "parent_id": client_sid}, client_ctx
            assert job.proof_bytes == want_job, "step 3 job"
            assert len(kill_at) == 1 and \
                ctr(metrics, "faults_injected_kill") == 1
            wait_for(lambda: len(d.tracker.usable_set()) == 4
                     and ctr(metrics, "membership_rejoins") >= 1
                     and all(w.probe(timeout_ms=2000) is not None
                             for w in d.workers), "heal to full width")
            # the rejoin re-admits the victim at once: full width from then
            heal_s = min(t for t, ev in joins if ev["rejoin"]
                         and t > kill_at[0]) - kill_at[0]
            assert len(d.workers) == 4 and d.workers[1].port == victim_port
            warm = wait_for(lambda: (d.workers[1].probe() or {}).get("warm"),
                            "warm stats")
            say("step 3 job (seed %d) with worker 1 SIGKILLed at its first "
                "FFT1: %.3f s from submit to done (run %.3f s), equal to "
                "its direct prove; replans %d, adopted ranges %d; respawned "
                "and rejoined at index 1, healed to width 4 in %.3f s after "
                "the kill (kill to JOIN); warm stats %s"
                % (V1_JOB_SEED, secs, job.run_s,
                   ctr(metrics, "fleet_fft_replans"),
                   ctr(metrics, "fleet_range_adoptions"), heal_s,
                   json.dumps(warm)))
            incident_checks(svc3, obs3, job, say, client_ctx)
        finally:
            obs3.close()
            svc3.shutdown()
        assert ctr(metrics, "worker_respawns") == 1
        assert warm["artifacts"] >= 1, warm
        if kind == "cuda":
            # the replacement took the kernel build from slot 0's store,
            # into its empty build directory, and ran no nvcc
            build = d.workers[1].probe()["build"]
            assert build["source"] == "peer", build
            assert build["nvcc_s"] is None, build
            assert build["dir"].startswith(fresh_build), build
            assert build["bytes"] == kbuild["bytes"], (build, kbuild)
            pulled_kb = ArtifactStore(fresh_store).get(kbuild["key"])
            assert pulled_kb == ArtifactStore(s00).get(kbuild["key"])
            assert warm["kernel_build"]["source"] == "peer", warm
            say("step 3: the replacement pulled the kernel build (%s, %d "
                "bytes) from a store peer and installed it into its empty "
                "build directory: provisioning %.3f s after its JOIN "
                "(list, fetch, install, load), install %.6f s; no nvcc "
                "(nvcc_s %s); heal to JOIN plus the pull %.3f s" % (
                    kbuild["key"], build["bytes"], build["seconds"],
                    build["install_s"], build["nvcc_s"],
                    heal_s + build["seconds"]))
        pulled = ArtifactStore(fresh_store).get(bucket)
        assert pulled is not None and pulled == ArtifactStore(
            os.path.join(workdir, "s0-0")).get(bucket), "warm rejoin bucket"
        # the job's backend pushes the base ranges anew, so each worker
        # builds its range's MSM context (the shifted key proj_add builds)
        # again, and an adopted range's too. The victim's new process
        # serves only what is left of the prove after its rejoin: it is
        # held to nothing
        total.update(elastic_delta(before, health_launches(d, "step 3", kind),
                                   "step 3", must=BASE_KERNELS, exempt=(1,)))
        faults.rules.clear()
        steps.done("3")

        # --- 4. a lying worker: quarantine, replace, challenge, rejoin ------
        # a worker that keeps lying, for the refused challenge (static
        # config, not a member)
        liar_port = reserve_port()
        cfg = os.path.join(workdir, "liar.json")
        NetworkConfig(["127.0.0.1:%d" % liar_port]).save(cfg)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "distributed_plonk_tpu_torch.runtime."
             "worker", "0", cfg, "--faults", LIAR, *dev_args], cwd=HERE))
        # step 5's one-worker fleet starts now, beside step 4
        m5 = Metrics()
        d5, sup5 = fleet(1, m5)

        d.integrity.msm_dup_rate = 1.0
        liar["slot"] = len(sup.slots)
        sup.add_slot(store_dir=os.path.join(workdir, "s0-liar"))
        wait_width(d, 5)
        liar_index = d.membership._find("127.0.0.1",
                                        sup.slots[liar["slot"]].port)
        q0 = ctr(metrics, "workers_quarantined")
        # the liar's replacement launches its kernels in the challenge
        # (the known-answer NTT and MSM): its count is read once it passed
        _be, _served = fleet_prove(
            d, "step 4 prove (5 workers, one lying, every MSM range "
            "duplicated)", be=RemoteBackend(d, dist_fft_min=ckt.n),
            settle=lambda: wait_for(
                lambda: len(d.tracker.usable_set()) == 5
                and not d.tracker.is_suspect(liar_index),
                "the liar's replacement passes the challenge"))
        assert d.quarantined.get(liar_index), d.quarantined
        assert ctr(metrics, "workers_quarantined") == q0 + 1
        assert ctr(metrics, "integrity_challenges") == 1
        assert ctr(metrics, "integrity_challenges_failed") == 0
        assert liar["spawned"] == 1 and ctr(metrics, "worker_respawns") == 2
        snap = d.workers[liar_index].probe()
        assert snap["sdc_injected"] == 0, snap
        d.integrity.msm_dup_rate = MSM_DUP_RATE
        wait_for(lambda: WorkerHandle("127.0.0.1", liar_port).probe(),
                 "the standing liar")
        t = time.perf_counter()
        refused = d.run_challenge("127.0.0.1", liar_port)
        assert refused is False, "a lying worker passed the challenge"
        say("step 4: worker %d quarantined (%s), LEAVEd, replaced by a clean "
            "process that passed the challenge and rejoined; a standing "
            "liar failed run_challenge (%.3f s); integrity failures %d"
            % (liar_index, d.quarantined[liar_index],
               time.perf_counter() - t, ctr(metrics, "integrity_failures")))
        peaks = {i: p for i, (_u, _l, p) in
                 health_launches(d, "step 4", kind).items()}
        say("workers' peak device memory (MiB): %s" % json.dumps(peaks))
        # where each member's kernel libraries came from (step 4 held every
        # member, the replacement at index 1 included, to launching K1-K4)
        builds = {i: (w.probe() or {}).get("build")
                  for i, w in enumerate(d.workers) if not d._left(i)}
        say("step 4: kernel build source by worker: %s" % json.dumps(
            {i: b and b["source"] for i, b in builds.items()}))
        if kind == "cuda":
            assert builds[1]["source"] == "peer" and \
                builds[1]["nvcc_s"] is None, builds[1]
        sup.stop()      # frees the card for step 5
        steps.done("4")

        # --- 5. the service on the fleet, with the autoscaler ----------------
        wait_width(d5, 1)
        svc = ProofService(
            port=0, prover_workers=1, device=torch.device(device),
            backend_factory=lambda: RemoteBackend(d5, dist_fft_min=ckt.n))
        try:
            svc.attach_membership(d5.membership)
            seeds = (V1_JOB_SEED, 12, 13)
            jobs = [svc.submit_local(dict(
                v1_spec, seed=s,
                **({"slo": "flagship"} if s == V1_JOB_SEED else {})))
                for s in seeds]
            asc = svc.attach_autoscaler(
                supervisor=sup5, mode="1", start=False, tick_s=0.2,
                min_workers=1, max_workers=2, up_queue_per_worker=2,
                up_ticks=2, down_ticks=10, up_cooldown_s=1.0,
                down_cooldown_s=1.0)
            log = []
            tick = asc.tick

            def logged_tick():
                ds = tick()
                if ds:
                    log.append((asc.state()["ticks"], ds))
                return ds
            asc.tick = logged_tick
            asc.start()
            wait_for(lambda: sup5.active_count() == 2, "scale up")
            wait_width(d5, 2)
            before = health_launches(d5, "step 5", kind)
            t = time.perf_counter()
            svc.start()
            for job in jobs:
                assert job.done_event.wait(600) and job.state == "done", \
                    job.error
            serve_s = time.perf_counter() - t
            after = health_launches(d5, "step 5", kind)
            # the fleet observability plane on this service: /fleet over
            # HTTP, and the workers' kernel shares in the autoscaler's
            # mfu_pct sensor
            svc.attach_fleet(d5, interval_s=1.0)
            obs = ObsServer(svc).start()
            try:
                svc.fleet.scrape_once()
                url = "http://%s:%d/fleet" % (obs.host, obs.port)
                with urllib.request.urlopen(url, timeout=30) as r:
                    fl = json.loads(r.read())
                members = [m for m in fl["members"] if m["snapshot"]]
                assert members and fl["width"] >= len(members), fl
                mfu_pct = asc.read_sensors()["mfu_pct"]
                assert mfu_pct is not None and 0 < mfu_pct <= 100, mfu_pct
                shares = check_mfu(svc.metrics.snapshot()["gauges"],
                                   "the service's fleet gauges")
                say("step 5: /fleet over HTTP: width %d, %d members "
                    "scraped; the autoscaler's mfu_pct %s (the workers' "
                    "mean shares %s)" % (fl["width"], len(members),
                                         mfu_pct, json.dumps(shares)))
            finally:
                obs.close()
            wait_for(lambda: sup5.active_count() == 1, "scale down")
            wait_for(lambda: ctr(m5, "worker_retires") == 1,
                     "retire complete")
            total.update(elastic_delta(before, after, "step 5"))
            sc = svc.metrics.snapshot()["counters"]
            assert sc.get("autoscale_scale_ups") == 1, sc
            assert sc.get("autoscale_scale_downs") == 1, sc
            assert ctr(m5, "worker_respawns") == 0
            assert ctr(m5, "worker_flap_capped") == 0
            for s, job in zip(seeds, jobs):
                want = want_job if s == V1_JOB_SEED else \
                    proof_io.serialize_proof(prove(
                        random.Random(s), build_circuit(JobSpec.from_wire(
                            dict(v1_spec, seed=s))), v1_pk, be))
                assert job.proof_bytes == want, "service seed %d" % s
            say("step 5: 3 v1 jobs (placements %s) served through the fleet "
                "in %.3f s, each equal to its direct TorchBackend prove; "
                "run seconds %s" % (
                    sorted({j.placement for j in jobs}), serve_s,
                    [round(j.run_s, 3) for j in jobs]))
            for n_tick, ds in log:
                for dd in ds:
                    say("autoscaler tick %d: %s (%s) applied=%s detail=%s"
                        % (n_tick, dd["action"], dd["reason"], dd["applied"],
                           json.dumps(dd["detail"])))
        finally:
            svc.shutdown()
        steps.done("5")
        say("elastic phase: %.3f s; this process's peak device memory above "
            "its resident %.1f MiB; fleet launches %s" % (
                time.perf_counter() - t_phase, peak_mib(mem0),
                json.dumps(dict(total))))
        return total
    finally:
        for sup_ in sups:
            sup_.stop()
        for d_ in dispatchers:
            try:
                d_.shutdown()
            finally:
                d_.pool.shutdown(wait=False)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(workdir, ignore_errors=True)


def observe_and_calibrate(golden, v1, v2, n, dev):
    """Phase 14 (see the module docstring). The plan is cleared at the
    end, so the phases after this one run the built-in parameters."""
    from distributed_plonk_tpu_torch import proof_io
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend import autotune as AT
    from distributed_plonk_tpu_torch.backend import ntt_torch as N
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.service.metrics import (Metrics,
                                                             device_peak)
    from distributed_plonk_tpu_torch.store import ArtifactStore, calibration
    from distributed_plonk_tpu_torch.trace import Tracer
    props = torch.cuda.get_device_properties(dev)
    peak = device_peak(dev)
    assert peak, "no integer peak known for this card"
    print("the card's own peak: %d SMs x %d IMAD/clk x %.0f MHz (nvidia-smi "
          "clocks.max.sm) = %.6g IMAD/s" % (
              props.multi_processor_count,
              IMAD_PER_SM_CLOCK[(props.major, props.minor)],
              peak / props.multi_processor_count
              / IMAD_PER_SM_CLOCK[(props.major, props.minor)] / 1e6, peak))
    # the fused round 3 (the default) runs its coset iNTT inside
    # quotient_stream_fused
    stages = {"ifft_wires", "commit_wires", "ifft_perm", "commit_perm",
              "quotient_stream_fused", "commit_quot", "commit_open"}
    for label, (c_, b_, p_) in (("v1", v1), ("v2", v2)):
        prove(random.Random(1), c_, p_, b_)
        _build.reset_launches()
        tr = Tracer()
        t = time.perf_counter()
        prove(random.Random(1), c_, p_, b_, tracer=tr)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        read_launches("the %s warm prove, traced" % label)
        m = Metrics()
        m.observe_kernels(tr.events, device=dev)
        g = m.snapshot()["gauges"]
        mfu = check_mfu(g, label)
        assert {k[4:-4] for k in mfu} == stages, sorted(mfu)
        dur = {ev["span"].rsplit("/", 1)[-1]: ev["dur_s"]
               for ev in tr.events if ev.get("flops")}
        print("%s warm prove %.3f s; per stage: seconds, G IMAD/s, mfu %%:"
              % (label, secs))
        for st in sorted(stages):
            print("  %-16s %.6f s  %10.3f  %.6g" % (
                st, dur[st], g["kernel_%s_gflops" % st],
                g["mfu_%s_pct" % st]))
    store_dir = tempfile.mkdtemp(prefix="dpt_autotune_")
    try:
        store = ArtifactStore(store_dir)
        m = Metrics()
        _build.reset_launches()
        t = time.perf_counter()
        rep = calibration.load_or_run(store, mode="run", shapes=[n],
                                      budget_s=120, metrics=m, device=dev)
        cal_s = time.perf_counter() - t
        read_launches("the calibration", ("ntt", "msm_digits",
                                           "bucket_sums", "msm_tail"))
        assert rep["source"] == "fresh" and rep["cells"] == 2, rep
        plan = AT.active_plan()
        print("calibration at n = %d: %.3f s, %s" % (n, cal_s,
                                                       json.dumps(rep)))
        for (kind, size), cell in sorted(plan.cells.items()):
            print("  cell %s:%d winner %s: %.6f s against the default's "
                  "%.6f s (x%s); %d candidates, %d parity rejects, %d "
                  "errors" % (kind, size, json.dumps(cell["params"]),
                              cell["best_s"], cell["default_s"],
                              cell["speedup_vs_default"],
                              cell["candidates"], cell["parity_rejects"],
                              cell["errors"]))
            for c in cell["measured"]:
                print("    %s %.6f s %s" % (json.dumps(c["params"]),
                                            c["s"], json.dumps(c["parts"])))
        print("autotune counters: %s" % json.dumps(
            m.snapshot()["counters"]))
        AT.set_active_plan(None)
        rep2 = calibration.load_or_run(store, mode="run", metrics=m,
                                       device=dev)
        assert rep2["source"] == "store" and rep2["measure_runs"] == 0, rep2
        print("second start: %s" % json.dumps(rep2))
        ckt, be, pk = v1
        nplan = N.get_plan(AT.quotient_size(n), dev)
        print("under the plan: ntt 2^%d passes %s, tiles %s; the commit "
              "key's chunk %d" % (
                  nplan.log_n, nplan.digits,
                  [ps.log_cols for ps in nplan.passes[False]],
                  be._ctx(pk.ck).chunk))
        prove(random.Random(1), ckt, pk, be)
        _build.reset_launches()
        t = time.perf_counter()
        proof = prove(random.Random(1), ckt, pk, be)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        read_launches("the v1 prove under the plan")
        assert proof_io.serialize_proof(proof) == golden, "proof under plan"
        print("v1 warm prove under the plan %.3f s, equal to the fixture"
              % secs)
    finally:
        AT.set_active_plan(None)
        shutil.rmtree(store_dir, ignore_errors=True)


# phase 16: the multi-process mesh. Each rank's collectives time out after
# MH_COLLECTIVE_S (a rank out of step fails, it does not hang); the parent
# kills a child that has not exited after MH_CHILD_LIMIT_S.
MH_COLLECTIVE_S = 120
MH_CHILD_LIMIT_S = 300
MH_SEED = 20261017      # the same seeded inputs on both ranks
MH_NTT_SIZES = (1 << 16, 1 << 21)
MH_CHILD_CMD = [sys.executable, os.path.abspath(__file__),
                "--multihost-child"]
MH_KERNELS = ("mont_mul", "ntt", "msm_digits", "bucket_sums", "msm_tail",
              "proj_add")


def must_launch(got, want):
    """want: kernel names that must have launched, or {name: count}."""
    if isinstance(want, dict):
        assert {k: got[k] for k in want} == want, (want, got)
    else:
        assert all(got[k] for k in want), (want, got)


def _digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _collectives(transport):
    return {op: dict(rec) for op, rec in transport.stats.items()}


def mh_no_whole_gathers(stats, n):
    """A prove's all-gathers carry the MSM planes and the carries only:
    less than one n-lane handle (32 n bytes) in all, where each mesh NTT
    used to all-gather its whole output."""
    gathered = stats["all_gather"]["bytes"]
    assert gathered < 32 * n, gathered


def multihost_child(pid, nccl_coord, gloo_coord, workdir, device="cuda:0"):
    """python3 chip_smoke.py --multihost-child PID NCCL GLOO WORKDIR: rank
    PID of phase 16's two-process mesh on cuda:0. Loads the kernels the
    set-up built (no nvcc), checks that an NCCL group of two ranks on one
    card is refused at init, joins the gloo group and runs (a) the mesh
    NTT at 2^16 and 2^21 in all four modes (its digests, held by the
    parent to the single card's) and the mesh MSM over v2's device key
    against the single card, (b) the v1 workload (the parent's
    pickled circuit) on MeshBackend from the device SRS: preprocess, a
    cold and a warm prove, each equal to the fixture, and verify. Prints
    one "MH {json}" line per step; any failure raises. (device="cpu"
    rehearses it on the plain versions, without the NCCL step, with
    MH_NTT_SIZES, V2_POWERS, FIXTURE and the CUDA helpers replaced.)"""
    import pickle
    from distributed_plonk_tpu_torch import kzg, proof_io
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    from distributed_plonk_tpu_torch.parallel import memory_plan
    from distributed_plonk_tpu_torch.parallel.mesh import (
        init_multihost, make_mesh, shutdown_multihost)
    from distributed_plonk_tpu_torch.parallel.mesh_backend import \
        MeshBackend
    from distributed_plonk_tpu_torch.parallel.msm_mesh import MeshMsmContext
    from distributed_plonk_tpu_torch.parallel.ntt_mesh import MeshNttPlan
    from distributed_plonk_tpu_torch.poly import Domain
    from distributed_plonk_tpu_torch.prover import prove
    from distributed_plonk_tpu_torch.trace import Tracer
    from distributed_plonk_tpu_torch.verifier import verify

    def emit(step, **kw):
        print("MH " + json.dumps(dict(step=step, rank=pid, **kw)),
              flush=True)

    dev = torch.device(device)
    total = collections.Counter()

    def launches():
        got = dict(_build.LAUNCHES)
        total.update(got)
        return got

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        t = time.perf_counter()
        _build.load()
        assert not _build.build_seconds, "a child ran nvcc"
        emit("load", seconds=time.perf_counter() - t,
             source_hash=_build.source_hash())

        # NCCL refuses two ranks on one card: init_multihost raises first
        t = time.perf_counter()
        try:
            init_multihost(nccl_coord, 2, pid, local_device_ids=[0],
                           backend="nccl", timeout_s=MH_COLLECTIVE_S)
        except RuntimeError as e:
            assert "NCCL needs one card per rank" in str(e), e
            emit("nccl refused", seconds=time.perf_counter() - t,
                 error=str(e))
        else:
            shutdown_multihost()
            raise AssertionError("two NCCL ranks on one card were not "
                                 "refused")

    t = time.perf_counter()
    counts = init_multihost(gloo_coord, 2, pid, local_device_ids=[0],
                            device=dev, backend="gloo",
                            timeout_s=MH_COLLECTIVE_S)
    assert counts == (2, 2), counts
    mesh = make_mesh(4)
    assert (mesh.size, mesh.first, mesh.devices) == (4, 2 * pid, (dev, dev))
    tp = mesh.transport
    emit("init", seconds=time.perf_counter() - t, counts=list(counts),
         mesh=repr(mesh))
    rng = random.Random(MH_SEED)

    # (a) the mesh NTT; the parent holds each result's digest to the
    # single card's on the same seeded input (mh_single_card_digests)
    for size in MH_NTT_SIZES:
        mplan = MeshNttPlan(mesh, size)
        v = seeded_words(dev, rng, 2, size)
        for inverse, coset in MODES:
            t = time.perf_counter()
            mplan.tables(inverse, coset)
            sync()
            tables_s = time.perf_counter() - t
            tp.reset_stats()
            _build.reset_launches()
            t = time.perf_counter()
            got = mplan.ntt(v, inverse, coset)
            sync()
            secs = time.perf_counter() - t
            got_l = launches()
            must_launch(got_l, ("mont_mul", "ntt"))
            emit("ntt", size=size, mode=mode_name(inverse, coset),
                 seconds=secs, tables_s=tables_s, launches=got_l,
                 collectives=_collectives(tp), digest=_digest(got))
        del v, got

    # (a) the mesh MSM over v2's device key, a round-1 batch of 5 handles
    t = time.perf_counter()
    srs2 = kzg.universal_setup_device(V2_POWERS - 1, tau=0xDEADBEEF,
                                      device=dev)
    ck = kzg.device_commit_key(srs2, V2_POWERS, dev)
    sync()
    srs_s = time.perf_counter() - t
    _build.reset_launches()
    t = time.perf_counter()
    mctx = MeshMsmContext(mesh, ck)
    sync()
    key_s = time.perf_counter() - t
    key_l = launches()
    words = seeded_words(dev, rng, 5, V2_POWERS - 1)
    hs = [words[:, i] for i in range(5)]
    mem0 = reset_peak()
    tp.reset_stats()
    _build.reset_launches()
    t = time.perf_counter()
    got = mctx.msm_mont_limbs_many(hs)
    msm_s = time.perf_counter() - t
    msm_mib = peak_mib(mem0)
    got_l = launches()
    # per rank: K3 on its 2 shards, K4 folds 2 -> 1 here and 2 -> 1 across
    # the ranks, one tail
    must_launch(got_l, {"msm_digits": 2, "bucket_sums": 2, "msm_tail": 1,
                        "proj_add": 2})
    t = time.perf_counter()
    want = TorchBackend(device=dev).commit_many_h(ck, hs)
    single_s = time.perf_counter() - t
    assert got == want, "two-process mesh msm vs single card"
    plan = memory_plan.msm_mesh_plan(len(ck), mesh.size, batch=5,
                                     n_processes=mesh.world)
    emit("msm", points=len(ck), local_n=mctx.local_n, srs_s=srs_s,
         key_s=key_s, key_launches=key_l, seconds=msm_s, single_s=single_s,
         launches=got_l, collectives=_collectives(tp), peak_mib=msm_mib,
         plan_mib=plan["per_process"] / 2**20,
         commitments=[[str(c) for c in p] for p in got])
    del mctx, ck, srs2, words, hs, want

    # (b) v1 on MeshBackend across the two processes
    with open(os.path.join(workdir, "v1.pkl"), "rb") as f:
        ckt = pickle.load(f)
    with open(FIXTURE) as f:
        golden = bytes.fromhex(f.read().strip())
    n = ckt.n
    m = Domain(6 * (n + 1) + 1).size
    t = time.perf_counter()
    srs = kzg.universal_setup_device(n + 2, tau=0xDEADBEEF, device=dev)
    be = MeshBackend(mesh)
    tp.reset_stats()
    _build.reset_launches()
    pk, vk = kzg.preprocess(srs, ckt, be)
    sync()
    emit("preprocess", seconds=time.perf_counter() - t,
         launches=launches(), collectives=_collectives(tp),
         counters={"mesh_ntt_calls": be.mesh_ntt_calls,
                   "mesh_msm_calls": be.mesh_msm_calls})
    r3 = memory_plan.round3_mesh_plan(n, m, mesh.size,
                                      n_processes=mesh.world)
    for label in ("cold", "warm"):
        be.mesh_ntt_calls.clear()
        be.replicated_ntt_calls.clear()
        be.mesh_msm_calls = 0
        be.sharded_handles.clear()
        be.replicated_handles.clear()
        mem0 = reset_peak()
        tp.reset_stats()
        _build.reset_launches()
        tr = Tracer()
        t = time.perf_counter()
        proof = prove(random.Random(1), ckt, pk, be, tracer=tr)
        sync()
        secs = time.perf_counter() - t
        mib = peak_mib(mem0)
        got_l = launches()
        must_launch(got_l, BASE_KERNELS + ("proj_add",))
        blob = proof_io.serialize_proof(proof)
        assert blob == golden, "%s two-process mesh proof" % label
        assert not be.replicated_ntt_calls, be.replicated_ntt_calls
        assert set(be.mesh_ntt_calls) == {n, m}, be.mesh_ntt_calls
        assert be.mesh_msm_calls == 13, be.mesh_msm_calls
        # every handle in lane shards across the two ranks, and no whole
        # NTT output gathered
        assert {n, n + 2, n + 3, m} <= set(be.sharded_handles) and \
            not be.replicated_handles, (be.sharded_handles,
                                        be.replicated_handles)
        mh_no_whole_gathers(tp.stats, n)
        emit("prove", label=label, seconds=secs,
             rounds=tr.totals(0), peak_mib=mib,
             plan_mib=r3["per_process"] / 2**20,
             launches=got_l, collectives=_collectives(tp),
             counters={"mesh_ntt_calls": {str(k): c for k, c in
                                          be.mesh_ntt_calls.items()},
                       "mesh_msm_calls": be.mesh_msm_calls,
                       "sharded_handles": {str(k): c for k, c in
                                           be.sharded_handles.items()},
                       "replicated_handles": {str(k): c for k, c in
                                              be.replicated_handles.items()}},
             digest=hashlib.sha256(blob).hexdigest()[:16])
    t = time.perf_counter()
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(2))
    emit("verify", seconds=time.perf_counter() - t)
    shutdown_multihost()
    emit("done", launches=dict(total))
    return 0


def nccl_mesh_check(dev, rng):
    """Phase 16 (c): a one-process NCCL group (world size 1) and a 2-shard
    mesh on this card: the 2^16 mesh NTT, its all-to-all and all-gather
    called on device tensors through NCCL, equal to the single card in all
    four modes."""
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend import ntt_torch as N
    from distributed_plonk_tpu_torch.parallel.mesh import (
        init_multihost, make_mesh, shutdown_multihost)
    from distributed_plonk_tpu_torch.parallel.ntt_mesh import MeshNttPlan
    from distributed_plonk_tpu_torch.runtime.supervisor import reserve_port
    t = time.perf_counter()
    counts = init_multihost("127.0.0.1:%d" % reserve_port(), 1, 0,
                            backend="nccl", timeout_s=MH_COLLECTIVE_S)
    try:
        assert counts == (1, torch.cuda.device_count()), counts
        mesh = make_mesh(2)
        assert mesh.size == 2 and mesh.transport.backend == "nccl"
        print("NCCL group of one process: init %.3f s; %r"
              % (time.perf_counter() - t, mesh), flush=True)
        size = 1 << 16
        mplan = MeshNttPlan(mesh, size)
        plan = N.get_plan(size, dev)
        v = seeded_words(dev, rng, 2, size)
        for inverse, coset in MODES:
            mplan.tables(inverse, coset)
            mesh.transport.reset_stats()
            _build.reset_launches()
            t = time.perf_counter()
            got = mplan.ntt(v, inverse, coset)
            sync()
            secs = time.perf_counter() - t
            read_launches("the NCCL mesh ntt %s" % mode_name(inverse, coset),
                          ("mont_mul", "ntt"))
            stats = _collectives(mesh.transport)
            assert stats["all_to_all"]["calls"] == 1 and \
                stats["all_gather"]["calls"] == 1, stats
            assert max_abs_err(got, N.ntt(plan, v, inverse, coset)) == 0, \
                ("NCCL mesh ntt vs single card", inverse, coset)
            print("NCCL mesh ntt (8, 2, 2^16) %s over 2 shards: %.4f s, "
                  "equal to the single-card ntt; collectives %s"
                  % (mode_name(inverse, coset), secs, json.dumps(stats)),
                  flush=True)
    finally:
        shutdown_multihost()


def mh_single_card_digests(dev):
    """{(size, mode): digest} of the single-card ntt of the inputs each
    multihost_child draws (the same MH_SEED draws, in its order). The
    parent's plans are warm from the earlier phases, so the children
    build no single-card plan of their own (a 2^21 plan is 16-18 s of
    host tables a child)."""
    from distributed_plonk_tpu_torch.backend import ntt_torch as N
    rng = random.Random(MH_SEED)
    out = {}
    for size in MH_NTT_SIZES:
        plan = N.get_plan(size, dev)
        v = seeded_words(dev, rng, 2, size)
        for inverse, coset in MODES:
            out[size, mode_name(inverse, coset)] = _digest(
                N.ntt(plan, v, inverse, coset))
    return out


def multihost_checks(smi, ckt, dev, rng):
    """Phase 16: two child processes (multihost_child) join a gloo group
    on this card and run (a) and (b) as one program, while this process
    runs (c) (nccl_mesh_check). A child that exits non-zero, overruns
    MH_CHILD_LIMIT_S or misses a step fails the phase; both ranks must
    report the same values. Returns each rank's launches over the phase,
    by kernel: {kernel: [rank 0, rank 1]}."""
    import pickle
    from distributed_plonk_tpu_torch.runtime.supervisor import reserve_port

    def say(msg):
        print("[%s] %s" % (smi, msg), flush=True)

    workdir = tempfile.mkdtemp(prefix="dpt_multihost_")
    procs = []
    try:
        with open(os.path.join(workdir, "v1.pkl"), "wb") as f:
            pickle.dump(ckt, f)
        coords = ["127.0.0.1:%d" % reserve_port() for _ in range(2)]
        t = time.perf_counter()
        procs = [subprocess.Popen(
            MH_CHILD_CMD + [str(pid)] + coords + [workdir], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(2)]
        nccl_mesh_check(dev, rng)           # (c), while the ranks start
        single = mh_single_card_digests(dev)
        outs = []
        for p in procs:
            left = MH_CHILD_LIMIT_S - (time.perf_counter() - t)
            out, err = p.communicate(timeout=max(left, 1))
            outs.append((p.returncode, out, err))
        wall = time.perf_counter() - t
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    ranks = []
    for pid, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise AssertionError("multihost rank %d exited %d:\n%s"
                                 % (pid, rc, err[-4000:]))
        steps = [json.loads(ln[3:]) for ln in out.splitlines()
                 if ln.startswith("MH ")]
        ranks.append(steps)
    names = [[(s["step"], s.get("size"), s.get("mode"), s.get("label"))
              for s in steps] for steps in ranks]
    assert names[0] == names[1] and names[0][-1][0] == "done", names
    assert len([s for s in names[0] if s[0] == "ntt"]) == \
        4 * len(MH_NTT_SIZES), names[0]
    for a, b in zip(*ranks):
        for key in ("digest", "commitments", "counters"):
            assert a.get(key) == b.get(key), (a["step"], key)
    for s in ranks[0]:
        if s["step"] == "ntt":
            assert s["digest"] == single[s["size"], s["mode"]], \
                ("two-process mesh ntt vs single card", s["size"],
                 s["mode"])
    for steps in ranks:
        for s in steps:
            body = {k: v for k, v in s.items()
                    if k not in ("step", "rank", "digest", "commitments")}
            say("rank %d %s: %s" % (s["rank"], s["step"], json.dumps(body)))
    per_rank = [steps[-1]["launches"] for steps in ranks]
    for got in per_rank:
        must_launch(got, MH_KERNELS)
    say("two-process mesh: both ranks equal the single card and each "
        "other (mesh ntt 2^16 and 2^21, mesh msm over %d powers, v1 cold "
        "and warm proofs equal to the fixture); %.3f s for both ranks"
        % (V2_POWERS, wall))
    return {k: [got.get(k, 0) for got in per_rank]
            for k in sorted(set().union(*per_rank))}



class Steps:
    """Prints the seconds of each step of a phase: done(label) ends the
    step that started at the last done() (or at construction)."""

    def __init__(self, say=print):
        self.say = say
        self.t = time.perf_counter()

    def done(self, label):
        now = time.perf_counter()
        self.say("step %s: %.3f s" % (label, now - self.t))
        self.t = now


def same_vk(a, b):
    return all(getattr(a, k) == getattr(b, k) for k in (
        "domain_size", "num_inputs", "selector_comms", "sigma_comms",
        "k", "g2", "tau_g2"))


# phases 11 (b)-(e) and 12 run in child processes beside phase 13 and the
# daemon step: the whole child, set-up included, must end within this
CHILD_LIMIT_S = 720
CHILD_SEED = 20261018   # phase 11's seeded values in its child
CHILD_CMD = [sys.executable, os.path.abspath(__file__), "--phase-child"]


class PhaseChild:
    """One phase in a child process (`chip_smoke.py --phase-child NAME
    DIR`, its own session, its output to DIR/NAME.log). join() waits up to
    CHILD_LIMIT_S from the start, prints the child's lines (each prefixed
    with its name) and fails unless it exited 0 and wrote its result;
    close() stops the child and every process it started (its session)
    and prints its lines if join() did not."""

    def __init__(self, name, inputs, workdir):
        self.name = name
        self.dir = os.path.join(workdir, name)
        os.makedirs(self.dir)
        self.log_path = os.path.join(self.dir, name + ".log")
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                CHILD_CMD + [name, inputs, self.dir], cwd=HERE, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)
        self.printed = False

    def _print_log(self):
        if self.printed:
            return
        self.printed = True
        with open(self.log_path) as f:
            for line in f:
                sys.stdout.write("[%s] %s" % (self.name, line))
        sys.stdout.flush()

    def _stop(self):
        """SIGTERM (the child's finally blocks stop its workers), then
        SIGKILL to whatever of its session is left."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait()

    def join(self):
        left = CHILD_LIMIT_S - (time.perf_counter() - self.t0)
        try:
            rc = self.proc.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            rc = None
        wall = time.perf_counter() - self.t0
        self._stop()
        self._print_log()
        assert rc == 0, "the %s child %s after %.3f s" % (
            self.name, "overran %d s" % CHILD_LIMIT_S if rc is None
            else "exited %d" % rc, wall)
        with open(os.path.join(self.dir, "result.json")) as f:
            result = json.load(f)
        print("the %s child: exit 0, %.3f s from its start (%.3f s of it "
              "its own set-up)" % (self.name, wall, result["setup_s"]),
              flush=True)
        return result

    def close(self):
        self._stop()
        self._print_log()


def phase_child(name, inputs, workdir, device="cuda:0"):
    """`python3 chip_smoke.py --phase-child NAME INPUTS DIR`: phase 11's
    (b)-(e) (name "fleet") or phase 12 (name "elastic") on the parent's
    v1 circuit, fixture bytes and vk (INPUTS, pickled), with the kernels
    the parent built (no nvcc) and the v1 keys preprocessed here from the
    device SRS (tau 0xDEADBEEF: the parent's vk, asserted). Writes
    DIR/result.json ({"launches": ..., "setup_s": ...}); any failure
    exits non-zero. SIGTERM exits through the finally blocks, which stop
    the workers."""
    from distributed_plonk_tpu_torch import kzg
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    t0 = time.perf_counter()
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    ckt, golden, smi = inp["ckt"], inp["golden"], inp["smi"]
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.load()
        assert not _build.build_seconds, "the child ran nvcc"
    be = TorchBackend(device=dev)
    srs = kzg.universal_setup_device(ckt.n + 2, tau=0xDEADBEEF, device=dev)
    pk, vk = kzg.preprocess(srs, ckt, be)
    assert same_vk(vk, inp["vk"]), "the child's v1 vk"
    setup_s = time.perf_counter() - t0
    print("%s child: kernels loaded (%s), v1 keys preprocessed from the "
          "device SRS in %.3f s" % (name, _build.report()["source"],
                                    setup_s), flush=True)
    if name == "fleet":
        t = time.perf_counter()
        srs2 = kzg.universal_setup_device(V2_POWERS - 1, tau=0xDEADBEEF,
                                          device=dev)
        ck2 = kzg.device_commit_key(srs2, V2_POWERS, dev)
        print("v2's commit key (%d powers) from the device SRS: %.3f s"
              % (V2_POWERS, time.perf_counter() - t), flush=True)
        fleet_checks(ckt, pk, vk, golden, ck2, TorchBackend(device=dev),
                     dev, random.Random(CHILD_SEED))
        launches = {}
    elif name == "elastic":
        launches = elastic_checks(smi, ckt, pk, vk, golden, (be, pk, vk),
                                  device=str(dev))
    else:
        raise ValueError("no phase child %r" % name)
    with open(os.path.join(workdir, "result.json"), "w") as f:
        json.dump({"launches": dict(launches), "setup_s": setup_s}, f)
    print("%s child: %.3f s" % (name, time.perf_counter() - t0), flush=True)
    return 0


def phase(name):
    print("== phase: %s" % name, flush=True)
    return time.perf_counter()


def done(name, t0):
    print("== phase %s: %.3f s" % (name, time.perf_counter() - t0),
          flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--zoo-cpu"] and len(argv) == 2:
        return zoo_cpu_child(argv[1])
    if argv[:1] == ["--analysis-cpu"] and len(argv) == 2:
        return analysis_cpu_child(argv[1])
    if argv[:1] == ["--multihost-child"] and len(argv) == 5:
        return multihost_child(int(argv[1]), argv[2], argv[3], argv[4])
    if argv[:1] == ["--phase-child"] and len(argv) == 4:
        return phase_child(argv[1], argv[2], argv[3])
    if argv:
        print("usage: python3 chip_smoke.py (the check; needs one card)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check needs a card",
              file=sys.stderr)
        return 2
    cleanup = []        # run last, whatever happens: stop the children
    try:
        return run_phases(cleanup)
    finally:
        for fn in reversed(cleanup):
            fn()


def stop_process(p):
    if p.poll() is None:
        p.kill()
        p.wait()


def run_phases(cleanup):
    """Phases 1-17; appends to `cleanup` what must run at the end (the
    processes it starts are stopped there)."""
    from distributed_plonk_tpu_torch import curve as C, kzg, proof_io
    from distributed_plonk_tpu_torch.checkpoint import ProverCheckpoint
    from distributed_plonk_tpu_torch.constants import R_MOD
    from distributed_plonk_tpu_torch.prover import (prove, prove_many,
                                                    prove_pipelined)
    from distributed_plonk_tpu_torch.trace import Tracer
    from distributed_plonk_tpu_torch.verifier import verify
    from distributed_plonk_tpu_torch.workload import generate_circuit
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.backend import curve_torch as CT
    from distributed_plonk_tpu_torch.backend import fixed_base_torch as FB
    from distributed_plonk_tpu_torch.backend import field_torch as F
    from distributed_plonk_tpu_torch.backend import msm_torch as M
    from distributed_plonk_tpu_torch.backend import ntt_torch as N
    from distributed_plonk_tpu_torch.backend.limbs import (ints_to_words,
                                                          lift, to_tensor)
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    from distributed_plonk_tpu_torch.runtime import native
    from distributed_plonk_tpu_torch.runtime.dispatcher import _split_rc
    from distributed_plonk_tpu_torch.runtime.torch_stages import \
        StageKernels
    from distributed_plonk_tpu_torch.runtime.worker import FftTask
    from distributed_plonk_tpu_torch.parallel.dryrun import dryrun_multichip
    from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
    from distributed_plonk_tpu_torch.parallel.msm_mesh import MeshMsmContext

    class Interrupted(Exception):
        pass

    class KillAfterRound(ProverCheckpoint):
        """Saves like the real checkpoint, then stops the prove."""

        def __init__(self, path, kill_round):
            super().__init__(path)
            self.kill_round = kill_round

        def save(self, round_no, *args, **kwargs):
            super().save(round_no, *args, **kwargs)
            if round_no == self.kill_round:
                raise Interrupted(round_no)

    class TimedCheckpoint(ProverCheckpoint):
        load_s = 0.0

        def load(self, fingerprint):
            t = time.perf_counter()
            try:
                return super().load(fingerprint)
            finally:
                self.load_s += time.perf_counter() - t

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

    def build():
        _build.load()
        return time.perf_counter() - t
    # the zoo's CPU proves (plain versions, pure host work) run in a child
    # process beside nvcc; phase 10 holds the card's proofs to them
    zoo_dir = tempfile.mkdtemp(prefix="dpt_zoo_cpu_")
    cleanup.append(lambda: shutil.rmtree(zoo_dir, ignore_errors=True))
    zoo_out = os.path.join(zoo_dir, "zoo_cpu.json")
    with open(os.path.join(zoo_dir, "zoo_cpu.log"), "w") as log:
        zoo_cpu = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--zoo-cpu",
             zoo_out], cwd=HERE, stdout=log, stderr=subprocess.STDOUT)
    cleanup.append(lambda: stop_process(zoo_cpu))
    # the static verifier's host passes and its mutants (phase 17), in a
    # child beside nvcc too
    analysis_out = os.path.join(zoo_dir, "analysis_cpu.json")
    analysis_log = os.path.join(zoo_dir, "analysis_cpu.log")
    with open(analysis_log, "w") as log:
        analysis_cpu = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--analysis-cpu",
             analysis_out], cwd=HERE, stdout=log, stderr=subprocess.STDOUT)
    cleanup.append(lambda: stop_process(analysis_cpu))
    # nvcc runs in child processes; this thread makes the host SRS, the v2
    # circuit and the zoo's circuits (pure Python) meanwhile
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        built = pool.submit(build)
        ckt, _ = generate_circuit(rng=random.Random(11), height=32,
                                  num_proofs=1)
        n = ckt.n
        t_srs = time.perf_counter()
        srs = kzg.universal_setup(n + 3, tau=0xDEADBEEF)
        host_srs_s = time.perf_counter() - t_srs
        # phase 8's v2 circuit, pure Python too
        t_v2 = time.perf_counter()
        ckt2, _ = generate_circuit(rng=random.Random(11), height=32,
                                   num_proofs=50)
        ckt2_s = time.perf_counter() - t_v2
        # phase 10's circuits
        zoo_built = zoo_build({"height": 16, "updates": 8})
        build_s = built.result()
    print("kernels built and loaded in %.3f s (%s); nvcc seconds by "
          "library: %s" % (build_s, _build.source_hash(),
                           json.dumps({k: round(v, 1) for k, v in
                                       _build.build_seconds.items()})),
          flush=True)
    for name, log in sorted(_build.build_log.items()):
        for fn, regs, spill in ptxas_report(log):
            print("ptxas %-6s %-40s %s; %s" % (name, fn[:40], regs, spill))
    print("circuit n = %d; host SRS of %d powers in %.3f s, v2 circuit in "
          "%.3f s (while nvcc ran)" % (n, len(srs.powers_of_g1), host_srs_s,
                                      ckt2_s), flush=True)
    done("setup", t0)

    # --- 2. kernel parity -----------------------------------------------------
    t0 = phase("kernel parity")
    kernels = {}
    # kernel name -> (one launch at its main-path shape, launches per
    # timing): phase 4 takes each kernel's device time from these
    runs = {}
    bounds = {}     # rows that are timed but not in the kernels line

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

    def plain_ms(fn, warm=True):
        """(output, milliseconds) of one call of a plain version, timed
        with CUDA events, after an untimed call (the first use of each
        torch kernel loads it) unless warm is False (its torch kernels
        ran already)."""
        if warm:
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
        with GcPauses() as pauses:
            py_ms = launch_ms(fn, 50)
        print("mont_mul %s launched from Python: %.4f ms per call over 50 "
              "calls; garbage collections in that window: %s"
              % (spec.name, py_ms, pauses.summary()))
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
        # the call path, piece by piece (host us per call): the entry, its
        # allocation and bare launch, and the pieces the entry no longer
        # runs (broadcast_tensors + contiguous, a device context, a stream
        # object, the library lookup)
        raw = _build.load()["field"].dpt_mont_mul
        out = torch.empty_like(a)
        stream = F._stream(a)
        grid = (spec.index, out.data_ptr(), a.data_ptr(), lanes, 0, 1,
                b.data_ptr(), lanes, 0, 1, 1, lanes, stream)

        def ctx():
            with torch.cuda.device(a.device):
                pass

        pieces = {
            "entry mont_mul": lambda: F.mont_mul(spec, a, b),
            "torch.empty": lambda: torch.empty_like(a),
            "bare ctypes launch": lambda: raw(*grid),
            "lane_layout": lambda: F.lane_layout(a, b),
            "raw stream handle": lambda: F._stream(a),
            "(gone) broadcast_tensors+contiguous": lambda: [
                t.contiguous() for t in torch.broadcast_tensors(a, b)],
            "(gone) torch.cuda.device context": ctx,
            "(gone) current_stream().cuda_stream": lambda:
                torch.cuda.current_stream(a.device).cuda_stream,
            "(gone) _build.load() lookup": lambda: _build.load()["field"],
        }
        print("call path %s (%d lanes), host us per call: %s" % (
            spec.name, lanes, json.dumps({k: round(call_path_us(f, 200), 2)
                                          for k, f in pieces.items()})))
        print("call spread %s, 200 calls of the entry: %s"
              % (spec.name, json.dumps(call_spread(fn, 200))), flush=True)

    # K1 on the operands the prover hands it, read through their strides:
    # a broadcast (L, 1) scalar against 330 lanes (the plain Horner's), a
    # slice x[:, i] of a stacked (L, 13, 2^16) tensor (round 3's
    # selectors), two lane axes ((L, 5, 66) by (L, 5, 1)), one lane, and
    # a width that is not a multiple of the 256-thread block
    for spec in (F.FR, F.FQ):
        stacked = rand_field(spec, 13 << 16).reshape(spec.n_words, 13,
                                                     1 << 16)
        cases = {
            "broadcast (L,1) x (L,330)": (rand_field(spec, 3)[:, 1:2],
                                          rand_field(spec, 330)),
            "slice x[:, 7] of (L,13,2^16)": (stacked[:, 7],
                                             stacked[:, 12]),
            "(L,5,66) x (L,5,1)": (rand_field(spec, 330).reshape(
                spec.n_words, 5, 66), rand_field(spec, 5).reshape(
                    spec.n_words, 5, 1)),
            "one lane": (rand_field(spec, 3)[:, 2:], rand_field(spec, 3)[
                :, 2:]),
            "4,099 lanes": (rand_field(spec, 4099), rand_field(spec, 4099)),
        }
        for label, (x, y) in cases.items():
            err = max_abs_err(F.mont_mul_cuda(spec, x, y),
                              F.mont_mul_ref(spec, x, y))
            assert err == 0, (spec.name, label, err)
        print("parity mont_mul %s strided/broadcast: %s: exact"
              % (spec.name, ", ".join(cases)))
        if spec is F.FR:
            zs, acc = cases["broadcast (L,1) x (L,330)"]
            x, y = cases["slice x[:, 7] of (L,13,2^16)"]
            runs["mont_mul broadcast"] = (
                lambda zs=zs, acc=acc: F.mont_mul_cuda(F.FR, acc, zs), 50)
            runs["mont_mul slice"] = (
                lambda x=x, y=y: F.mont_mul_cuda(F.FR, x, y), 50)
            # one launch and no copy for a broadcast or a sliced operand
            for label, (p, q) in (("broadcast", (acc, zs)),
                                  ("slice", (x, y))):
                torch.cuda.synchronize()
                with _profiler() as prof:
                    F.mont_mul(F.FR, p, q)
                    torch.cuda.synchronize()
                rows = _device_kernels(prof)
                assert len(rows) == 1 and "mont_mul_kernel" in rows[0][0] \
                    and rows[0][1] == 1, rows
                print("mont_mul %s under the profiler: %s" % (label, ", ".join(
                    "%s x%d" % (k[:40], c) for k, c, _ in rows)))

    # K2: all four modes at 2^13 (batch 5, round 1's wires), at 2, 32 and
    # 512 (one and two passes, odd log2 n, batch 3), the round-3 mode
    # (forward coset) at 2^16 with batch 8 and 25, and the quotient's
    # coset inverse at 2^16
    def ntt_case(size, batch, inverse, coset):
        plan = N.get_plan(size, dev)
        v = lift([rng.randrange(R_MOD) for _ in range(size * batch)],
                 dev).reshape(8, batch, size)
        got = N.ntt_cuda(plan, v, inverse, coset)
        want, pms = plain_ms(lambda: N.ntt_ref(plan, v, inverse, coset))
        return plan, v, max_abs_err(got, want), pms

    for size, batch in ((1 << 13, 5), (2, 3), (32, 3), (512, 3)):
        for inverse in (False, True):
            for coset in (False, True):
                _, _, err, pms = ntt_case(size, batch, inverse, coset)
                assert err == 0, ("ntt", size, inverse, coset, err)
                print("parity ntt %d x%d inverse=%d coset=%d exact  plain "
                      "%.3f ms" % (size, batch, inverse, coset, pms))
    _, _, err, pms = ntt_case(1 << 16, 1, True, True)
    assert err == 0, ("ntt coset inverse 2^16", err)
    print("parity ntt 65536 x1 inverse=1 coset=1 exact  plain %.3f ms" % pms)
    size = 1 << 16
    for batch in (8, 25):
        plan, v, err, pms = ntt_case(size, batch, False, True)
        name = "ntt" if batch == 8 else "ntt x25"
        runs[name] = ((lambda plan=plan, v=v: N.ntt_cuda(plan, v, False,
                                                         True)), 10)
        py_ms = launch_ms(runs[name][0], 10)
        muls = batch * (size // 2 * 16 + size)  # butterflies + pre-scale
        nbytes = 32 * (2 * batch * size + size // 2 + size)
        if batch == 8:
            record("ntt", "distributed_plonk_tpu_torch/csrc/ntt.cu",
                   "distributed_plonk_tpu/backend/ntt_pallas.py:341", err,
                   py_ms, pms, nbytes, muls * FR_MUL_IMADS,
                   "coset fwd (8, 8, 65536)")
        else:
            assert err == 0, err
            bounds["ntt x25"] = (nbytes, muls * FR_MUL_IMADS)
            print("parity %-18s %-34s exact  launched from Python %.4f ms  "
                  "plain %.3f ms  bound %.4f ms (%s)"
                  % ("ntt", "coset fwd (8, 25, 65536)", py_ms, pms,
                     bound_ms(*bounds["ntt x25"]),
                     bound_by(*bounds["ntt x25"])), flush=True)
    print("ntt passes: 2^16 %s, 2^13 %s (log2 rows per pass)"
          % (N.get_plan(1 << 16, dev).digits, N.get_plan(1 << 13, dev).digits))

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
    tail_out = got

    # K4's window finish: the same batch over the base layout of the key
    # (its 8,224 points, one lane per (handle, window): the round-1 batch
    # shape of v1 and v2, 5 handles x 37 windows x 64 buckets), its bucket
    # sums through msm_finish, equal to msm_finish_ref and, as points, to
    # the shifted key's totals. The plain version (about 320 dependent
    # plain adds on the card) runs once: msm_tail_ref loaded its kernels
    base_ctx = M.MsmContext(ck, dev, layout="base")
    fin_args = tuple(p.contiguous() for p in base_ctx.bucket_planes(hv)) \
        + (base_ctx.windows, base_ctx.c, base_ctx.signed)

    def finish(args=fin_args):
        return M.msm_finish_cuda(*args)

    got = finish()
    want, pms = plain_ms(lambda: M.msm_finish_ref(*fin_args), warm=False)
    err = max_abs_err(got, want)
    assert CT.proj_to_affine(got) == CT.proj_to_affine(tail_out), \
        "the base layout's totals differ from the shifted key's"
    runs["msm_finish"] = (finish, 5)
    fin_w, fin_c = base_ctx.windows, base_ctx.c
    record("msm_finish", "distributed_plonk_tpu_torch/csrc/msm_finish.cu",
           "distributed_plonk_tpu/backend/curve_pallas.py:289", err,
           launch_ms(finish, 5), pms, 3 * 48 * B * (fin_w * nb + 1),
           (tail_adds * fin_w + B * (fin_w - 1) * (fin_c + 1)) * 12
           * FQ_MUL_IMADS,
           "(12, %d, %d) -> (12, %d)" % (B * fin_w, nb, B))
    print("msm_finish: %d handles' totals over the base layout equal the "
          "shifted key's msm_tail totals as points" % B, flush=True)
    # its registers and spills (nvcc's ptxas report), and each of its two
    # kernels' device time under the profiler at the round-1 batch
    for fn, regs, spill in ptxas_report(_build.build_log.get("finish", "")):
        print("msm_finish ptxas %-40s %s; %s" % (fn[:40], regs, spill))
    for fn, regs, spill in ptxas_report(_build.build_log.get("curve", "")):
        if "msm_tail_kernel" in fn:     # the single-thread window sums
            print("msm_tail ptxas   %-40s %s; %s" % (fn[:40], regs, spill))
    finish()
    torch.cuda.synchronize()
    with _profiler(cpu=False) as prof:
        for _ in range(5):
            finish()
        torch.cuda.synchronize()
    # per event: the profiler can lose some of a window's events
    stages = {k.split("(")[0].split()[-1]: round(us / count, 2)
              for k, count, us in _device_kernels(prof)}
    steps = (fin_w - 1) * (fin_c + 1)
    kernels["msm_finish"]["stages_us"] = stages or None
    print("msm_finish stages at the round-1 batch (profiler, us per call): "
          "%s; the Horner's %d steps at %s us each" % (
              json.dumps(stages) if stages else "not measured", steps,
              "%.4f" % (stages["horner_kernel"] / steps)
              if "horner_kernel" in stages else "not measured"), flush=True)
    # more batches, each against its plain version: msm24's (1 handle), 33
    # handles (more than one block of Horner warps), sums that are all the
    # identity (the total (0 : 1 : 0)); one plain call holds the three
    # signed batches side by side (each handle's chain is its own). Then
    # unsigned c = 4 (64 windows of 16 buckets) over the key's first 64
    # points, a key of under 256 points.
    fin_rng = random.Random(20261018)
    cases = {
        "B=1 (msm24's batch)": base_ctx.bucket_planes(hv[:, :1]),
        "B=33": base_ctx.bucket_planes(seeded_words(dev, fin_rng, 33,
                                                    base_ctx.n)),
        "identity sums": CT.proj_inf((fin_w, nb), dev)}
    cases = {k: tuple(p.contiguous() for p in v) for k, v in cases.items()}
    wcs = fin_args[3:]
    got = {k: M.msm_finish_cuda(*v, *wcs) for k, v in cases.items()}
    want, pms = plain_ms(lambda: M.msm_finish_ref(
        *(torch.cat(p, dim=1) for p in zip(*cases.values())), *wcs),
        warm=False)
    at = 0
    for k, v in cases.items():
        b = v[0].shape[1] // fin_w
        err = max_abs_err(got[k], tuple(w[:, at:at + b] for w in want))
        assert err == 0, ("msm_finish", k, err)
        at += b
        print("parity msm_finish %-28s exact  launched from Python %.4f "
              "ms" % (k, launch_ms(lambda v=v: M.msm_finish_cuda(*v, *wcs),
                                   5)))
    assert max_abs_err(got["identity sums"], CT.proj_inf((1,), dev)) == 0
    print("msm_finish: the three batches' plain version in one call "
          "(%d handles): %.3f ms; the identity sums' total is (0 : 1 : 0)"
          % (at, pms), flush=True)
    small = M.MsmContext(ck[:64], dev, layout="base")
    assert (small.signed, small.c, small.windows) == (False, 4, 64)
    planes = tuple(p.contiguous() for p in small.bucket_planes(
        seeded_words(dev, fin_rng, 2, small.n)))
    small_args = (small.windows, small.c, small.signed)
    got = M.msm_finish_cuda(*planes, *small_args)
    want, pms = plain_ms(lambda: M.msm_finish_ref(*planes, *small_args),
                         warm=False)
    assert max_abs_err(got, want) == 0, "msm_finish unsigned c = 4"
    print("parity msm_finish %-28s exact  launched from Python %.4f ms  "
          "plain %.3f ms" % ("unsigned c=4 W=64 B=2", launch_ms(
              lambda: M.msm_finish_cuda(*planes, *small_args), 5), pms),
          flush=True)
    del base_ctx, want, cases, got, small, planes

    # K4 elementwise: the key build's launch (c doublings of the key's
    # 8,224 bases in one launch), the full add by width against the one
    # thread a point, and full and mixed adds at 370 lanes
    kx, ky = ctx.key[:, :12].t(), ctx.key[:, 12:].t()

    def proj(a, b):
        pt = CT.from_affine(kx[:, a:b].contiguous(), ky[:, a:b].contiguous(),
                            torch.zeros(b - a, dtype=torch.bool, device=dev))
        return tuple(c.contiguous() for c in pt)

    base = proj(0, ctx.n)
    out = CT.proj_dbl(base, ctx.c)
    want, pms = plain_ms(lambda: CT.proj_dbl_ref(base, ctx.c))
    err = max_abs_err(out, want)
    runs["proj_add"] = (lambda: CT.proj_dbl(base, ctx.c), 50)
    record("proj_add", "distributed_plonk_tpu_torch/csrc/curve_add.cu",
           "distributed_plonk_tpu/backend/curve_pallas.py:289", err,
           launch_ms(runs["proj_add"][0], 50), pms, 6 * 48 * ctx.n,
           ctx.n * ctx.c * 12 * FQ_MUL_IMADS,
           "%d doublings P + P (12, %d)" % (ctx.c, ctx.n))
    wide = proj(0, P)
    q = CT._add_cuda(wide, tuple(torch.roll(c, 5, 1) for c in wide))
    proj_add_widths(q)                          # on P_i + P_(i-5): general Z
    p = proj(0, 370)
    p2, q2 = CT._add_cuda(p, proj(P - 370, P)), p
    assert max_abs_err(CT._add_cuda(p2, q2), CT.proj_add_ref(p2, q2)) == 0
    affine = (kx[:, 1000:1370].contiguous(), ky[:, 1000:1370].contiguous())
    assert max_abs_err(CT._add_cuda(p2, affine),
                       CT.proj_add_mixed_ref(p2, affine)) == 0
    print("parity proj_add full (12, 370) and mixed (12, 370): exact")
    del wide, q, p, p2, q2

    # K4 mixed: one step of the fixed-base walk of the v2 SRS (2^18 + 3
    # lanes: a projective accumulator plus a gathered affine table row)
    fb = V2_POWERS
    acc = CT._add_cuda(proj(0, fb), proj(P - fb, P))           # general Z
    row = (kx[:, 1:fb + 1].contiguous(), ky[:, 1:fb + 1].contiguous())
    out = CT._add_cuda(acc, row)
    want, pms = plain_ms(lambda: CT.proj_add_mixed_ref(acc, row))
    err = max_abs_err(out, want)
    runs["proj_add_mixed"] = (lambda: CT._add_cuda(acc, row), 10)
    record("proj_add_mixed", "distributed_plonk_tpu_torch/csrc/curve_add.cu",
           "distributed_plonk_tpu/backend/curve_pallas.py:289", err,
           launch_ms(runs["proj_add_mixed"][0], 10), pms, 8 * 48 * fb,
           fb * 11 * FQ_MUL_IMADS, "mixed P + Q (12, %d)" % fb)
    del want, out

    # round 3's folds at v1's shapes (13 selectors, 5 sigmas, the combine
    # at 2^16) and v2's (4 x 2^21, 4 x 2^21, the combine at 2^21)
    r3_parity(dev, rng, record, plain_ms, kernels, runs)
    # round 4's evaluation (kernel 8) at v1's, v2's and 2^20's shapes and
    # a fleet worker's EVAL, and its registers and spills (none)
    eval_parity(dev, rng, record, plain_ms, kernels, runs)
    for fn, regs, spill in ptxas_report(_build.build_log.get("eval", "")):
        print("poly_eval ptxas %-40s %s; %s" % (fn[:40], regs, spill))
        assert "0 bytes spill stores" in spill \
            and "0 bytes spill loads" in spill, (fn, spill)
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
    # preprocess builds the shifted key: the elementwise add's main path,
    # one launch of c doublings a window after the first
    assert pre_launches["proj_add"] == M.W7 - 1, pre_launches
    print("the key build's proj_add launches in preprocess: %d (one launch "
          "of 7 doublings a window)" % pre_launches["proj_add"])
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
    ntt_calls = _build.CALLS["ntt"]
    blob = proof_io.serialize_proof(proof)
    assert blob == golden, "warm proof bytes differ from the fixture"
    t = time.perf_counter()
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(2))
    verify_s = time.perf_counter() - t
    for name in PATH_KERNELS:
        assert launches[name] > 0, \
            "kernel %s never launched in the warm prove" % name
        kernels[name]["launches"] = launches[name]
        kernels[name]["launches_in"] = "warm prove"
    # the fused round 3: one launch per fold (13 selectors and 5 sigmas in
    # one batch each at m = 2^16)
    assert {k: launches[k] for k in R3_KERNELS} == R3_LAUNCHES["v1"], \
        launches
    # one digit decode, accumulation and tail per commit batch (wires,
    # permutation, quotient splits, openings), and no elementwise add
    batches = sum(1 for k in tr_warm.totals(1) if k.startswith("commit"))
    assert batches == 4, tr_warm.totals(1)
    for name in ("msm_digits", "bucket_sums", "msm_tail"):
        assert launches[name] == batches, (name, launches[name], batches)
    assert launches["proj_add"] == launches["proj_add_mixed"] == 0, launches
    # the NTT: one launch per pass, at most 3 per call at 2^13 and 2^16
    assert 0 < launches["ntt"] <= 3 * ntt_calls, (launches, ntt_calls)
    kernels["ntt"]["calls"] = ntt_calls
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
    print("launches in the warm prove: " + json.dumps(launches)
          + "; ntt calls %d" % ntt_calls)
    # round 4's ten evaluations: one poly_eval call (kernel 8), and kernel
    # 1 only for its from_mont
    assert launches["poly_eval"] == 1, launches
    print("round 4 (warm v1 prove, %s): %.4f s; poly_eval launches %d, "
          "mont_mul launches %d in the whole prove"
          % (smi, tr_warm.totals(0)["round4"], launches["poly_eval"],
             launches["mont_mul"]), flush=True)
    print("peak device memory %.1f MiB"
          % (torch.cuda.max_memory_allocated() / 2**20))

    # the same keys with the commit key on the base layout (kernel 4's
    # msm_finish in place of msm_tail): a cold prove (the base context's
    # build) and a warm one, both the fixture; the warm one launches
    # msm_finish once per commit batch, msm_tail never, and every other
    # kernel as often as the shifted key's warm prove
    be_base = TorchBackend(msm_layout="base")
    t = time.perf_counter()
    proof = prove(random.Random(1), ckt, pk, be_base)
    torch.cuda.synchronize()
    base_cold_s = time.perf_counter() - t
    assert proof_io.serialize_proof(proof) == golden, "base-layout cold"
    _build.reset_launches()
    t = time.perf_counter()
    proof = prove(random.Random(1), ckt, pk, be_base)
    torch.cuda.synchronize()
    base_warm_s = time.perf_counter() - t
    base_launches = read_launches(
        "the warm v1 prove on the base layout",
        tuple(k for k in PATH_KERNELS if k != "msm_tail") + ("msm_finish",))
    assert proof_io.serialize_proof(proof) == golden, "base-layout warm"
    assert base_launches["msm_finish"] == batches, base_launches
    assert base_launches["msm_tail"] == 0, base_launches
    for name in PATH_KERNELS:
        if name != "msm_tail":
            assert base_launches[name] == launches[name], (name,
                                                           base_launches)
    kernels["msm_finish"]["launches"] = base_launches["msm_finish"]
    kernels["msm_finish"]["launches_in"] = "warm prove, base layout"
    print("v1 on the base layout: cold prove %.3f s, warm prove %.3f s, "
          "both equal to the fixture" % (base_cold_s, base_warm_s))
    del be_base
    done("prove", t0)

    # --- 4. device SRS: the fixed-base walk (kernel 4's mixed add, kernel
    # 1's Jacobian conversion) equals the host SRS, and the 2^13 workload
    # proves from it to the fixture
    t0 = phase("device srs")
    t = time.perf_counter()
    FB._host_window_table(C.G1_GEN)
    print("fixed-base window table (host, %d x %d affine multiples): %.3f s"
          % (FB.N_WINDOWS, FB.N_BUCKETS, time.perf_counter() - t))
    _build.reset_launches()
    t = time.perf_counter()
    srs_d = kzg.universal_setup_device(n + 2, tau=0xDEADBEEF)
    torch.cuda.synchronize()
    srs_d_s = time.perf_counter() - t
    srs_launches = read_launches("universal_setup_device(%d)" % (n + 2),
                                 ("proj_add_mixed", "mont_mul"))
    assert srs_launches["proj_add_mixed"] == FB.N_WINDOWS, srs_launches
    assert srs_d.count == n + 3
    assert srs_d.powers_affine() == srs.powers_of_g1[:n + 3], "device SRS"
    assert srs_d.tau_g2 == srs.tau_g2
    print("device SRS of %d powers in %.3f s (host SRS of %d powers: %.3f s"
          " in set-up); equal to the host powers and tau_g2"
          % (n + 3, srs_d_s, len(srs.powers_of_g1), host_srs_s))
    be_d = TorchBackend()
    _build.reset_launches()
    t = time.perf_counter()
    pk_d, vk_d = kzg.preprocess(srs_d, ckt, be_d)
    torch.cuda.synchronize()
    pre_d_s = time.perf_counter() - t
    pre_d = read_launches("the device-SRS preprocess", ("proj_add",))
    assert pre_d["proj_add"] == M.W7 - 1, pre_d
    print("the key build's proj_add launches in the device-SRS preprocess: "
          "%d" % pre_d["proj_add"])
    assert vk_d.selector_comms == vk.selector_comms
    assert vk_d.sigma_comms == vk.sigma_comms
    secs = []
    for label in ("cold", "warm"):
        _build.reset_launches()
        t = time.perf_counter()
        proof = prove(random.Random(1), ckt, pk_d, be_d)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        assert proof_io.serialize_proof(proof) == golden, label
    read_launches("the warm prove from the device SRS")
    print("device-SRS preprocess %.3f s (vk equal to the host SRS's); cold "
          "prove %.3f s, warm prove %.3f s, both equal to the fixture"
          % (pre_d_s, secs[0], secs[1]))
    del be_d, pk_d, srs_d
    done("device srs", t0)

    # --- 5. round 3 fused (the default), streamed (quotient_poly_streamed
    # set to None on the backend) and one-shot (both hooks None), and the
    # warm prove's host synchronisations per round
    t0 = phase("round 3")
    r3_peaks = {}
    for label, hooks in (("fused", {}), ("streamed", STREAMED_R3),
                         ("one-shot", ONE_SHOT_R3)):
        for k, v in hooks.items():
            setattr(be, k, v)
        try:
            prove(random.Random(1), ckt, pk, be)     # the path's tables
            mem0 = reset_peak()
            _build.reset_launches()
            tr = Round3Peak()
            t = time.perf_counter()
            proof = prove(random.Random(1), ckt, pk, be, tracer=tr)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            assert proof_io.serialize_proof(proof) == golden, label
            got = read_launches("the %s warm prove" % label,
                                PATH_KERNELS if label == "fused"
                                else BASE_KERNELS)
            if label != "fused":
                assert not any(got[k] for k in R3_KERNELS), got
            r3_peaks[label] = tr.peak_mib
            print("%s round 3: warm prove %.3f s (round3 %.4f s, the device "
                  "drained at its end), equal to the fixture; peak device "
                  "memory above the resident %.1f MiB in the prove, %.1f MiB "
                  "in round 3" % (label, secs, tr.totals(0)["round3"],
                                  peak_mib(mem0), tr.peak_mib), flush=True)
        finally:
            for k in hooks:
                delattr(be, k)
    assert r3_peaks["fused"] <= r3_peaks["streamed"], r3_peaks
    r3_ab(be, ckt, pk, golden, "v1 (%s)" % smi)
    per_round, sites = sync_counts(
        lambda tr: prove(random.Random(1), ckt, pk, be, tracer=tr))
    print("host synchronisations per round of the warm prove (sync debug "
          "mode): %s" % json.dumps(per_round))
    print("  by call chain in the port: %s"
          % json.dumps(dict(sites.most_common())))
    done("round 3", t0)

    # --- 6. checkpoint: a prove killed right after saving round k resumes
    # in the same process to the fixture, and leaves no file behind
    t0 = phase("checkpoint")
    ckdir = tempfile.mkdtemp(prefix="dpt_ckpt_")
    try:
        for k in range(1, 5):
            path = os.path.join(ckdir, "after_r%d.npz" % k)
            tr = Tracer()
            try:
                prove(random.Random(1), ckt, pk, be, tracer=tr,
                      checkpoint=KillAfterRound(path, k))
                raise AssertionError("the prove ran past round %d" % k)
            except Interrupted:
                pass
            size = os.path.getsize(path)
            timed = TimedCheckpoint(path)
            restore = []
            load_h = be.load_h

            def timed_load_h(arr):
                t = time.perf_counter()
                h = load_h(arr)
                torch.cuda.synchronize()
                restore.append(time.perf_counter() - t)
                return h
            be.load_h = timed_load_h
            try:
                _build.reset_launches()
                t = time.perf_counter()
                proof = prove(random.Random(1), ckt, pk, be, checkpoint=timed)
                torch.cuda.synchronize()
                resumed_s = time.perf_counter() - t
            finally:
                del be.load_h
            assert proof_io.serialize_proof(proof) == golden, k
            assert not os.path.exists(path)
            # rounds 4 and 5 run no NTT and no round-3 fold
            read_launches("the prove resumed after round %d" % k,
                          PATH_KERNELS if k < 3 else
                          tuple(x for x in BASE_KERNELS if x != "ntt"))
            print("checkpoint after round %d: %d bytes; dump + write %.4f s "
                  "over %d saves; load %.4f s; load_h %.4f s over %d handles;"
                  " resumed prove %.3f s, equal to the fixture"
                  % (k, size, tr.totals(0)["checkpoint_save"], k,
                     timed.load_s, sum(restore), len(restore), resumed_s))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    done("checkpoint", t0)

    # --- 7. four members of the 2^13 workload, prove rngs Random(1..4),
    # through each driver: the same bytes per member, member 0 the fixture
    t0 = phase("batched and pipelined")
    seeds = (1, 2, 3, 4)
    _build.reset_launches()
    t = time.perf_counter()
    seq = [prove(random.Random(s), ckt, pk, be) for s in seeds]
    torch.cuda.synchronize()
    rates = {"sequential prove": len(seeds) / (time.perf_counter() - t)}
    read_launches("4 sequential proves")
    want = [proof_io.serialize_proof(member) for member in seq]
    assert want[0] == golden
    drivers = [("prove_many", lambda: prove_many(
        [random.Random(s) for s in seeds], [ckt] * 4, pk, be))]
    for depth in (1, 2, 4):
        drivers.append(("prove_pipelined depth %d" % depth,
                        lambda depth=depth: prove_pipelined(
                            [random.Random(s) for s in seeds], [ckt] * 4, pk,
                            be, depth=depth)))
    for name, run in drivers:
        _build.reset_launches()
        t = time.perf_counter()
        proofs, errors = run()
        torch.cuda.synchronize()
        rates[name] = len(seeds) / (time.perf_counter() - t)
        assert errors == [None] * 4, (name, errors)
        assert [proof_io.serialize_proof(member)
                for member in proofs] == want, name
        read_launches(name)
    t = time.perf_counter()
    for member in seq:
        assert verify(vk, ckt.public_input(), member, rng=random.Random(2))
    print("4 members equal per member across the drivers, member 0 equal to "
          "the fixture, all verify (%.3f s)" % (time.perf_counter() - t))
    print("proofs per second: " + json.dumps(
        {k: round(v, 3) for k, v in rates.items()}))
    done("batched and pipelined", t0)

    # --- 8. v2: the reference's 2^18 workload at full size, from the device
    # SRS; correctness is verify plus an identical one-shot round-3 prove
    t0 = phase("v2")
    n2 = ckt2.n
    print("v2 circuit (height 32, 50 Merkle proofs): n = %d, %d public "
          "inputs, generated in %.3f s (in the set-up)" % (
              n2, ckt2.num_inputs, ckt2_s))
    assert n2 == 1 << 18 and n2 + 3 == V2_POWERS, n2
    _build.reset_launches()
    t = time.perf_counter()
    srs2 = kzg.universal_setup_device(n2 + 2, tau=0xDEADBEEF)
    torch.cuda.synchronize()
    srs2_s = time.perf_counter() - t
    v2_srs = read_launches("universal_setup_device(%d)" % (n2 + 2),
                           ("proj_add_mixed", "mont_mul"))
    kernels["proj_add_mixed"]["launches"] = v2_srs["proj_add_mixed"]
    kernels["proj_add_mixed"]["launches_in"] = \
        "universal_setup_device, %d powers" % V2_POWERS
    t = time.perf_counter()
    _, powers = kzg._tau_powers(n2 + 2, tau=0xDEADBEEF)
    tau_s = time.perf_counter() - t
    t = time.perf_counter()
    FB.digits_of_scalars(powers)
    digits_s = time.perf_counter() - t
    print("device SRS of %d powers in %.3f s (host parts timed again alone: "
          "tau powers %.3f s, digits %.3f s); %d mixed-add launches, %d "
          "mont_mul launches" % (n2 + 3, srs2_s, tau_s, digits_s,
                                 v2_srs["proj_add_mixed"],
                                 v2_srs["mont_mul"]))
    del powers
    be2 = TorchBackend()
    mem0 = reset_peak()
    _build.reset_launches()
    t = time.perf_counter()
    pk2, vk2 = kzg.preprocess(srs2, ckt2, be2)
    torch.cuda.synchronize()
    print("v2 preprocess %.3f s; peak device memory above the resident %.1f "
          "MiB" % (time.perf_counter() - t, peak_mib(mem0)))
    read_launches("the v2 preprocess", ("proj_add", "ntt", "msm_digits",
                                        "bucket_sums", "msm_tail"))
    del srs2
    blobs = []
    v2_peaks = {}
    for label, hooks in (("cold", {}), ("warm", {}),
                         ("warm streamed round 3", STREAMED_R3),
                         ("warm one-shot round 3", ONE_SHOT_R3)):
        for k, v in hooks.items():
            setattr(be2, k, v)
        try:
            mem0 = reset_peak()
            _build.reset_launches()
            tr = Round3Peak()
            t = time.perf_counter()
            proof2 = prove(random.Random(1), ckt2, pk2, be2, tracer=tr)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            mib = peak_mib(mem0)
        finally:
            for k in hooks:
                delattr(be2, k)
        blobs.append(proof_io.serialize_proof(proof2))
        got = read_launches("the v2 %s prove" % label,
                            BASE_KERNELS if hooks else PATH_KERNELS)
        if label == "warm":
            assert {k: got[k] for k in R3_KERNELS} == R3_LAUNCHES["v2"], got
            for k in R3_KERNELS:
                kernels[k]["launches_v2"] = got[k]
            assert got["poly_eval"] == 1, got
            kernels["poly_eval"]["launches_v2"] = got["poly_eval"]
            print("round 4 (warm v2 prove, %s): %.4f s; poly_eval launches "
                  "%d, mont_mul launches %d in the whole prove"
                  % (smi, tr.totals(0)["round4"], got["poly_eval"],
                     got["mont_mul"]), flush=True)
        v2_peaks[label] = tr.peak_mib
        print("v2 %s prove %.3f s; peak device memory above the resident "
              "%.1f MiB in the prove, %.1f MiB in round 3"
              % (label, secs, mib, tr.peak_mib))
        print("  rounds: " + json.dumps(
            {k: round(v, 4) for k, v in tr.totals(0).items()}))
        print("  spans: " + json.dumps(
            {k: round(v, 4) for k, v in tr.totals(1).items()}))
    assert len(set(blobs)) == 1, "v2 proofs differ"
    assert v2_peaks["warm"] <= v2_peaks["warm streamed round 3"], v2_peaks
    r3_ab(be2, ckt2, pk2, blobs[0], "v2 (%s)" % smi)
    t = time.perf_counter()
    assert verify(vk2, ckt2.public_input(), proof2, rng=random.Random(2))
    print("v2 proofs identical (cold, warm fused, streamed and one-shot "
          "round 3); verify ok in %.3f s" % (time.perf_counter() - t))
    del proof2
    # v2's round-1 batch (5 handles of width n + 2) over the base layout
    # of its device key equals the shifted key's commitments
    t = time.perf_counter()
    base2 = M.MsmContext(pk2.ck, dev, layout="base")
    sync()
    base2_key_s = time.perf_counter() - t
    words2 = seeded_words(dev, rng, 5, n2 + 2)
    hs2 = [words2[:, i] for i in range(5)]
    _build.reset_launches()
    t = time.perf_counter()
    got2 = base2.msm_mont_limbs_many(hs2)
    base2_s = time.perf_counter() - t
    read_launches("v2's round-1 batch on the base layout",
                  ("msm_digits", "bucket_sums", "msm_finish"))
    assert got2 == be2.commit_many_h(pk2.ck, hs2), "v2 base layout"
    print("v2 round-1 batch on the base layout (%d points, context %.3f "
          "s): %.3f s, equal to the shifted key's commitments"
          % (base2.n, base2_key_s, base2_s), flush=True)
    del base2, words2, hs2, got2
    done("v2", t0)

    # --- 8b. the reference-scale runners: scripts/torch_scale_run.py on v1
    # and scripts/torch_kernel_bench.py at 2^16, their functions in this
    # process
    t0 = phase("scale scripts")
    scale_script_checks(dev)
    done("scale scripts", t0)

    # --- 9. mesh: MeshBackend over four shards of this card (one process,
    # every shard's kernels on the card): the dry run, the mesh NTT and
    # MSM against the single-card kernels, the v2 prove against phase 8's
    t0 = phase("mesh")
    mesh = make_mesh(4)
    print("mesh: %r" % (mesh,))
    _build.reset_launches()
    t = time.perf_counter()
    counts = dryrun_multichip(4)
    sync()
    read_launches("dryrun_multichip(4)", BASE_KERNELS + ("proj_add",))
    print("dryrun_multichip(4): %.3f s; the mesh iNTT, coset NTT, MSM and "
          "tiny prove equal their oracles; counters %s"
          % (time.perf_counter() - t, json.dumps(counts)), flush=True)
    mesh_runs = {}      # graph-timed in the last phase
    # the coset modes at 2^21 run on sharded handles in mesh_scale_checks
    mesh_ntt_checks(mesh, (1 << 16, 1 << 21), dev, rng, mesh_runs,
                    skip={(1 << 21, "forward coset"),
                          (1 << 21, "inverse coset")})
    mesh_scale_checks(ckt, dev, mesh_runs)
    t = time.perf_counter()
    mctx = MeshMsmContext(mesh, pk2.ck)
    sync()
    key_s = time.perf_counter() - t
    words = seeded_words(dev, rng, 5, n2 + 2)
    hs = [words[:, i] for i in range(5)]
    _build.reset_launches()
    t = time.perf_counter()
    got = mctx.msm_mont_limbs_many(hs)
    msm_s = time.perf_counter() - t
    lm = read_launches("the mesh msm of 5 handles", (
        "msm_digits", "bucket_sums", "msm_tail", "proj_add"))
    assert [lm[k] for k in ("msm_digits", "bucket_sums", "msm_tail",
                            "proj_add")] == [4, 4, 1, 3], lm
    t = time.perf_counter()
    assert got == be2.commit_many_h(pk2.ck, hs), "mesh msm"
    print("mesh msm over v2's device key (%d powers, %d shards of %d "
          "points, keys built in %.3f s): 5 handles in %.3f s, equal to "
          "TorchBackend.commit_many_h (%.3f s)"
          % (len(pk2.ck), mesh.size, mctx.local_n, key_s, msm_s,
             time.perf_counter() - t), flush=True)
    # kernel 4 at the fold's shape: two shards' bucket planes of the batch
    blocks = mctx.stack(hs)
    fold = tuple(tuple(c.contiguous() for c in mctx.shards[s].bucket_planes(
        blocks[s])) for s in (0, 1))
    want, pms = plain_ms(lambda: CT.proj_add_ref(*fold))
    assert max_abs_err(CT._add_cuda(*fold), want) == 0
    lanes = fold[0][0].numel() // 12
    runs["proj_add fold"] = (lambda: CT._add_cuda(*fold), 50)
    print("parity proj_add fold %s exact  launched from Python %.4f ms  "
          "plain %.3f ms  bound %.4f ms (%s)" % (
              tuple(fold[0][0].shape), launch_ms(runs["proj_add fold"][0], 50),
              pms, bound_ms(9 * 48 * lanes, lanes * 12 * FQ_MUL_IMADS),
              bound_by(9 * 48 * lanes, lanes * 12 * FQ_MUL_IMADS)))
    del mctx, blocks, hs, words
    mesh_launches = mesh_prove_checks(mesh, ckt2, pk2, vk2, blobs[0], be2,
                                      "v2")
    for name, rec in kernels.items():
        rec["mesh_launches"] = mesh_launches[name]
    gc.collect()
    torch.cuda.empty_cache()
    done("mesh", t0)

    # --- 10. the circuit zoo: every kind builds; range and preimage prove
    # on the card, range also on the CPU to one proof; the rollup at
    # n = 2^16 on TorchBackend and on the mesh to one proof
    t0 = phase("zoo")
    t = time.perf_counter()
    if zoo_cpu.wait(timeout=600) != 0:
        with open(os.path.join(zoo_dir, "zoo_cpu.log")) as f:
            raise AssertionError("the zoo's CPU proves failed:\n"
                                 + f.read()[-4000:])
    with open(zoo_out) as f:
        zoo_cpu_ref = json.load(f)
    print("the zoo's CPU proves (started in the set-up): waited %.3f s"
          % (time.perf_counter() - t), flush=True)
    _, rollup_ref = zoo_checks(dev, zoo_built, zoo_cpu_ref)
    del zoo_built
    gc.collect()
    torch.cuda.empty_cache()
    done("zoo", t0)

    # --- 11. fleet: four port workers on this card (each its own process
    # and CUDA context, so the card is time-shared and the times measure
    # the protocol, not a four-card fleet): the stage panels against their
    # plain versions, the sharded FFT and the fleet MSM at v2 size against
    # the single-card kernels, the v1 proof through the fleet
    t0 = phase("fleet")
    panel_runs = {}     # graph-timed in the last phase

    for size in (1 << 16, 1 << 21):
        r, c = _split_rc(size)
        rows = [c * j // 4 for j in range(5)]
        cols = [(r * j // 4, r * (j + 1) // 4) for j in range(4)]
        st = StageKernels(dev)
        for inverse, coset in ((False, False), (True, False), (False, True),
                               (True, True)):
            mode = "%s%s" % ("inverse" if inverse else "forward",
                             " coset" if coset else "")
            t = time.perf_counter()
            calls = []
            for me in range(4):
                task = FftTask(inverse, coset, size, r, c, rows[me],
                               rows[me + 1], cols, me)
                pre, mid = st._stage1_tables(task, task.rs, task.re)
                post = st._stage2_tables(task, task.cs, task.ce)
                calls.append((seeded_words(dev, rng, task.re - task.rs, r), r,
                              {"pre": pre, "mid": mid}))
                calls.append((seeded_words(dev, rng, task.ce - task.cs, c), c,
                              {"post": post}))
            torch.cuda.synchronize()
            tables_s = time.perf_counter() - t
            _build.reset_launches()
            outs = [st.panel_words(v, n_, inverse, **tb)
                    for v, n_, tb in calls]
            read_launches("the %s stage panels at 2^%d" % (
                mode, size.bit_length() - 1), ("mont_mul", "ntt"))
            for (v, n_, tb), got in zip(calls, outs):
                want = st.panel_words(v, n_, inverse, plain=True, **tb)
                assert max_abs_err(got, want) == 0, (size, mode, n_)
            print("stage panels 2^%d %s: 4 row panels (8, %d, %d) and 4 "
                  "column panels (8, %d, %d) exact against their plain "
                  "versions; tables %.3f s" % (
                      size.bit_length() - 1, mode, rows[1], r, cols[0][1], c,
                      tables_s), flush=True)
            tag = "2^%d %s" % (size.bit_length() - 1, mode)
            v1, n1, tb1 = calls[2]
            v2_, n2_, tb2 = calls[3]
            panel_runs["stage-1 panel " + tag] = (
                lambda v=v1, n_=n1, tb=tb1, inv=inverse, st=st:
                st.panel_words(v, n_, inv, **tb), 5)
            panel_runs["stage-2 panel " + tag] = (
                lambda v=v2_, n_=n2_, tb=tb2, inv=inverse, st=st:
                st.panel_words(v, n_, inv, **tb), 5)
            panel_runs["8 panels, one sharded FFT " + tag] = (
                lambda calls=calls, inv=inverse, st=st: [
                    st.panel_words(v, n_, inv, **tb)
                    for v, n_, tb in calls], 3)
            whole = seeded_words(dev, rng, 1, size)
            panel_runs["single-card ntt (8, 1, 2^%d) %s" % (
                size.bit_length() - 1, mode)] = (
                lambda whole=whole, plan=N.get_plan(size, dev), inv=inverse,
                co=coset: N.ntt_cuda(plan, whole, inv, co), 5)
            del outs, calls

    # (b)-(e), the four workers, and phase 12 run in child processes
    # (phase_child) beside phase 13 and the daemon step in this one: the
    # three are host-bound (the fleets' round math, the service's
    # interpreter lock) and each owns its processes, ports and launch
    # counters; the card is time-shared by every worker anyway
    native.build_native()     # before the workers, which load it
    children_dir = tempfile.mkdtemp(prefix="dpt_children_")
    cleanup.append(lambda: shutil.rmtree(children_dir, ignore_errors=True))
    inputs = os.path.join(children_dir, "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump({"ckt": ckt, "golden": golden, "smi": smi, "vk": vk},
                    f)
    children = {}
    for name in ("fleet", "elastic"):
        children[name] = PhaseChild(name, inputs, children_dir)
        cleanup.append(children[name].close)
    done("fleet", t0)

    # --- 13. service: the port's ProofService on this card over TCP, the
    # v1, rollup and v2 workloads through batch, pool and mesh placement,
    # a killed worker, a crash and a restart
    t0 = phase("service")
    service_launches = service_checks(smi, (be, pk, vk), rollup_ref,
                                      (ckt2, be2, pk2, vk2))
    for name, rec in kernels.items():
        rec["service_launches"] = service_launches[name]
    del rollup_ref
    gc.collect()
    torch.cuda.empty_cache()
    done("service", t0)

    # --- 13b. the daemon: python -m distributed_plonk_tpu_torch.service
    # with the dry autoscaler, one v1 job over TCP, the console, SIGTERM
    t0 = phase("daemon")
    daemon_launches = daemon_checks(smi, (be, pk, vk))
    for name, rec in kernels.items():
        rec["daemon_launches"] = daemon_launches[name]
    done("daemon", t0)

    # --- 11 and 12, joined: the fleet and elastic children's lines, and
    # the launches the elastic one counted over its workers' HEALTH
    t0 = phase("fleet and elastic children")
    results = {name: child.join() for name, child in children.items()}
    for name, rec in kernels.items():
        rec["elastic_launches"] = results["elastic"]["launches"].get(name, 0)
    done("fleet and elastic children", t0)

    # --- 14. observe and calibrate: the kernel shares of the v1 and v2 warm
    # proves against this card's peak, then a kernel plan measured on a
    # fresh store at the v1 sizes, loaded again with no measurement, and
    # the v1 proof under it
    t0 = phase("observe and calibrate")
    observe_and_calibrate(golden, (ckt, be, pk), (ckt2, be2, pk2), n, dev)
    done("observe and calibrate", t0)

    # --- 15. device time, after the counters were read and the proves timed:
    # torch.profiler, then CUDA graphs (captured last, so that no capture
    # precedes a timing of calls from Python)
    t0 = phase("profile")
    profile_kernels(runs)
    profile_prove(lambda: prove(random.Random(1), ckt, pk, be))
    profile_prove(lambda: prove(random.Random(1), ckt2, pk2, be2),
                  "v2 warm prove")
    round3_profile(be, ckt, pk, "v1")
    round3_profile(be2, ckt2, pk2, "v2")
    del be2, pk2, ckt2
    gc.collect()
    torch.cuda.empty_cache()
    graph_kernels(runs, kernels)
    graph_kernels(panel_runs, {})
    graph_kernels(mesh_runs, {})
    nbytes, imads = bounds["ntt x25"]
    print("ntt coset fwd (8, 25, 65536): bound %.4f ms (%s)"
          % (bound_ms(nbytes, imads), bound_by(nbytes, imads)))
    done("profile", t0)

    # --- 16. the multi-process mesh: two processes on this card joined by
    # init_multihost over gloo run the mesh NTT, the mesh MSM and the v1
    # prove as one program; a one-process NCCL group runs the mesh NTT's
    # collectives on device tensors
    t0 = phase("multi-process mesh")
    mh_launches = multihost_checks(smi, ckt, dev, rng)
    for name, rec in kernels.items():
        rec["multihost_launches"] = mh_launches[name]
    done("multi-process mesh", t0)

    # --- 17. the static verifier: its host passes ran in the set-up's
    # child; here the kernels held to the same value contracts on the card
    t0 = phase("analysis")
    analysis_checks(smi, analysis_cpu, analysis_out, analysis_log, kernels)
    done("analysis", t0)

    assert all(k["ms"] is not None for k in kernels.values()), kernels
    assert all(kernels[k]["v2"]["ms"] is not None
               for k in R3_KERNELS + ("poly_eval",))
    assert all(kernels["poly_eval"][label]["ms"] is not None
               for label, _, _, _ in EVAL_PARITY[1:])
    print(json.dumps({"kernels": [kernels[k] for k in (
        "mont_mul", "ntt", "msm_digits", "bucket_sums", "msm_tail",
        "msm_finish", "proj_add", "proj_add_mixed") + R3_KERNELS
        + ("poly_eval",)]}))
    # count: the cards this run used
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
