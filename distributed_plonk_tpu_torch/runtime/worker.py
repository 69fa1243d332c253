"""Worker daemon: serves MSM, NTT and the sharded 4-step FFT over the
native framed transport, with its kernels on the card.

The port of the JAX package's runtime/worker.py, and the analog of the
reference's worker binary (reference src/worker.rs:441-536): it holds its
base sets across requests (State, worker.rs:42-59) and runs kernels per
RPC. One thread per connection; the state is guarded by a lock, and the
kernels run outside it, so concurrent connections overlap.

Compute: a `TorchBackend` serves MSM (an `MsmContext` per base set, in the
backend's bounded cache), NTT and EVAL through its int-list methods; a
`torch_stages.StageKernels` runs each FFT1 frame and each FFT2 column
panel as one batched panel transform (kernels 1 and 2). Both sit on the
card unless `--device cpu` asks for the host, which runs the kernels'
plain versions (the tests).

The sharded FFT (the reference's signature protocol): FFT_INIT allocates a
task (worker.rs:187-233), FFT1 runs the stage-1 rows (worker.rs:235-278 ->
66-94), FFT2_PREPARE pushes each peer its column slices over direct
worker<->worker connections (worker.rs:280-345 sender, 412-438 receiver),
FFT2 runs the stage-2 columns and returns the result shard (worker.rs:
347-381 -> 96-115), with the integrity plane's partial power sums
piggybacked when the dispatcher sends a check point. Peer exchange frames
arrive on the same port, told apart by tag.

The wire protocol is the JAX package's (runtime/protocol.py), so the JAX
package's dispatcher drives this worker too. Launched with --store DIR,
the worker serves its artifact store (bucket keys, checkpoints, proofs)
to peers over STORE_FETCH and STORE_LIST (store/remote.py), so a fresh
host pulls a warm peer's keys instead of rebuilding them.

Membership (runtime/membership.py): a worker started with `--join
host:port` binds, announces itself to the dispatcher's membership server,
adopts the returned index, epoch and roster, and serves; then it
warm-rejoins in the background (bucket keys pulled from the roster's
store peers) and reports the stats, which HEALTH shows under `warm`.
ROSTER pushes advance its epoch (never backwards), and an FFT_INIT planned
against another epoch is refused (ERR "stale epoch", counted as
`stale_epoch`). `--faults RULES` arms the data plane of runtime/faults.py
(the JAX worker's DPT_FAULTS): a `corrupt:at=data` rule perturbs this
worker's own MSM / NTT / FFT2 / EVAL results before they are framed.

Observability: a `Metrics` registry (service/metrics.py) holds the
`served_<tag>` counters and, per kernel stage (msm, ntt, fft1, fft2,
eval), a `worker_<stage>_s` latency histogram and the
`kernel_<stage>_gflops` / `mfu_<stage>_pct` gauges of the work model
(trace.py) against this card's peak; each timed interval ends with the
result on the host, so it covers the device work. METRICS_FETCH serves
the snapshot (obs/fleet.py scrapes it), LOG_FETCH the structured-log ring
(obs/log.py), PROFILE an on-demand capture (obs/profiling.py:
torch.profiler on the card, the stack sampler on the host).

Calibration: with --store, the worker adopts the store's kernel plan for
this card at start (store/calibration.py; `--autotune off|load|run`,
default load: `run` calibrates a plan-less store), and a --join worker
again after its warm sync, which pulls `autotune:` plans with the bucket
keys.

Kernel build (store/kernels.py): on the card, before its first kernel
load, the worker takes the first of its build directory (`--build-dir
DIR`, default the checkout's), its own store's `kbuild:` artifact, the
roster's store peers (a --join worker, right after the JOIN reply) and
nvcc, and publishes the loaded build into its own store when the store
lacks it (a store-serving worker hands the build on). The pull runs
before the accept loop starts (early connects wait in the bound
listener's backlog), so no request can start nvcc while a pull is due;
an nvcc build runs on a thread while the worker serves (a request's
first kernel load waits for it). HEALTH and METRICS_FETCH report where
the libraries came from under `build` (backend/_build.build_report).

Run: python -m distributed_plonk_tpu_torch.runtime.worker <index>
    <network.json> [--device cuda|cpu] [--store DIR] [--build-dir DIR]
    [--faults RULES] [--autotune off|load|run]
  or python -m distributed_plonk_tpu_torch.runtime.worker --join H:P
    [--listen H:P] [--device cuda|cpu] [--store DIR] [--build-dir DIR]
    [--faults RULES] [--autotune off|load|run]
"""

import json
import struct
import sys
import threading
import time
from collections import OrderedDict
from contextlib import nullcontext

import numpy as np
import torch

from . import native, protocol
from .faults import FaultInjector, parse_rules
from .netconfig import NetworkConfig
from .torch_stages import StageKernels
from ..backend import _build
from ..backend.torch_backend import TorchBackend
from ..constants import R_MOD, FR_GENERATOR
from ..fields import fr_inv, fr_root_of_unity
from ..obs import log as olog
from ..obs import profiling
from ..poly import Domain, poly_eval
from ..service.metrics import Metrics
from ..trace import (FR_BYTES, FR_MUL_IMADS, NULL_TRACER, Tracer, msm_flops,
                     ntt_flops)

# resident per-trace span buffers: the dispatcher fetches-and-forgets
# them via TRACE_DUMP, but a dispatcher that dies mid-prove must not
# leak its trace buffers forever — LRU cap, oldest trace dropped
_TRACE_CAP = 32


class FftTask:
    """In-flight sharded FFT state (the reference's FftTask,
    reference src/worker.rs:50-54): stage-1 results for our rows, stage-2
    input columns filled in by peer exchanges.

    The data plane is numpy limb panels end to end (exchange panels land
    with one slice assignment); `created` supports age-based GC, fixing the
    reference's task leak on dispatcher abort (worker.rs:378)."""

    def __init__(self, inverse, coset, n, r, c, rs, re, col_ranges, me,
                 keep_raw=False):
        self.inverse = inverse
        self.coset = coset
        self.n, self.r, self.c = n, r, c
        self.rs, self.re = rs, re          # our stage-1 rows (j2 indices)
        self.col_ranges = col_ranges       # every worker's stage-2 range (k1)
        self.cs, self.ce = col_ranges[me]
        self.rows_mat = None               # (16, re - rs, r) staged rows
        self.rows_filled = np.zeros(re - rs, dtype=bool)
        # RAW stage-1 input panels as received (first_row -> limbs): the
        # integrity plane's input-side partial is a power sum of what this
        # worker actually holds. Kept only when FFT_INIT announced an
        # armed integrity plane (keep_raw).
        self.keep_raw = keep_raw
        self.raw_panels = {}
        # [16, local k1, j2] stage-2 input columns; fill_mask tracks the
        # exchange per (column, row) cell — a REGION mask, not a counter,
        # so a retried FFT2_PREPARE stays idempotent
        self.cols = np.zeros((16, self.ce - self.cs, c), dtype=np.uint32)
        self.fill_mask = np.zeros((self.ce - self.cs, c), dtype=bool)
        self.cols_lock = threading.Lock()
        self.created = time.monotonic()
        # FFT2 caches its reply here instead of deleting the task, so a
        # dispatcher retry gets the same bytes back; completed tasks are
        # GC'd by age at the next FFT_INIT
        self.result = None
        self.done_at = None


class WorkerState:
    def __init__(self, backend, stages, config=None, me=0, store=None,
                 faults=None):
        self.backend = backend
        self.stages = stages
        self.config = config
        self.me = me
        self.store = store   # store.ArtifactStore served over STORE_FETCH
        # membership-roster version this worker last adopted (0 = static
        # fleet / never joined): FFT_INIT frames planned against another
        # epoch are refused, and ROSTER pushes advance it
        self.epoch = 0
        # the data plane of runtime/faults.py (--faults): perturbs OUR
        # computed results before framing; None is the plain path
        self.faults = faults
        self.sdc_injected = 0
        self.warm = None     # warm-rejoin stats (store/remote.warm_sync)
        # the calibration pickup report (store/calibration.load_or_run)
        self.autotune = {"source": "off"}
        # the structured registry served over METRICS_FETCH (served
        # counters, kernel latency histograms, gauges); the structured
        # log ring publishes its counters here too
        self.metrics = Metrics()
        olog.set_metrics(self.metrics)
        self.started = time.monotonic()
        self.base_sets = {}  # set_id -> bases (a worker can adopt ranges)
        self.lock = threading.Lock()
        self.domains = {}
        self.fft_tasks = {}
        self.peers = {}
        self.peer_lock = threading.Lock()
        self.counters = {}
        # trace_id -> Tracer holding this worker's spans for that trace
        # (shipped back + forgotten on TRACE_DUMP; LRU-capped)
        self.traces = OrderedDict()

    def on_device(self):
        """The device context a connection thread runs its kernels in."""
        dev = self.backend.device
        return torch.cuda.device(dev) if dev.type == "cuda" \
            else nullcontext()

    def domain(self, n):
        if n not in self.domains:
            self.domains[n] = Domain(n)
        return self.domains[n]

    def count(self, tag):
        with self.lock:
            self.counters[tag] = self.counters.get(tag, 0) + 1
        # served_<tag>: what the fleet scraper sums into dpt_fleet_served_*
        self.metrics.inc("served_" + protocol.tag_name(tag).lower())

    def observe_kernel(self, stage, dur_s, flops=0, data_bytes=0):
        """Fold one kernel execution into the live per-stage surfaces: a
        latency histogram, and the kernel_<stage>_gflops / mfu_<stage>_pct
        gauges of its work model against this card's peak (no mfu_* on
        the host). `dur_s` must end after the work's result reached the
        host, or the gauge would time the launch."""
        self.metrics.observe(f"worker_{stage}_s", dur_s)
        if flops:
            self.metrics.observe_kernels(
                [{"span": stage, "flops": flops, "dur_s": dur_s,
                  "data_bytes": data_bytes}], device=self.backend.device)

    def tracer_for(self, ctx):
        """The per-trace Tracer an incoming traced frame records under
        (created on first sight of the trace id, LRU past _TRACE_CAP)."""
        tid = ctx.get("trace_id") if isinstance(ctx, dict) else None
        if not tid:
            return NULL_TRACER
        with self.lock:
            tr = self.traces.get(tid)
            if tr is None:
                tr = self.traces[tid] = Tracer(
                    trace_id=tid, proc=f"worker/{self.me}")
                while len(self.traces) > _TRACE_CAP:
                    self.traces.popitem(last=False)
            else:
                self.traces.move_to_end(tid)
            return tr

    def pop_trace(self, trace_id):
        with self.lock:
            return self.traces.pop(trace_id, None)

    def health(self):
        """The HEALTH snapshot (cheap, lock-scoped: a probe must stay fast
        even mid-FFT). `launches` is this process's kernel launch counters
        (backend/_build.py), which a caller reads before and after a run."""
        with self.lock:
            return {
                "uptime_s": round(time.monotonic() - self.started, 3),
                "served": sum(self.counters.values()),
                "fft_tasks": len(self.fft_tasks),
                "base_sets": sorted(self.base_sets),
                "backend": self.backend.name,
                "device": str(self.backend.device),
                # wall-clock sample: the dispatcher brackets the probe with
                # its own clock to estimate this worker's offset
                "now": time.time(),
                "traces": len(self.traces),
                "launches": dict(_build.LAUNCHES),
                "epoch": self.epoch,
                # data-plane chaos visibility (0 without --faults)
                "sdc_injected": self.sdc_injected,
                # warm-rejoin stats of a --join worker (None until its
                # peer sync finished)
                "warm": self.warm,
                # this process's peak device memory (MiB; 0 on the CPU)
                "peak_mib": _peak_mib(self.backend.device),
                # where the kernel libraries came from (source None on
                # the CPU, which loads none)
                "build": _build.report(),
            }

    def peer(self, p):
        """Lazy worker->worker connection (the reference opens peer
        connections per exchange, worker.rs:297-338; here they are cached).
        Includes the self-loop via TCP, as the reference does."""
        with self.peer_lock:
            if p not in self.peers:
                host, port = self.config.workers[p]
                conn = native.connect(host, port)
                self.peers[p] = (conn, threading.Lock())
            return self.peers[p]

    def drop_peer(self, p):
        """Forget a cached peer connection (it broke mid-exchange)."""
        with self.peer_lock:
            entry = self.peers.pop(p, None)
        if entry is not None:
            try:
                entry[0].close()
            except OSError:  # pragma: no cover - already dead
                pass

    def peer_call(self, p, tag, payload):
        """One request/reply to peer p, retrying ONCE on a fresh
        connection: a cached stream goes stale when the peer restarts, and
        the exchange payload is idempotent at the receiver (region-mask
        overwrite). Raises on the second failure."""
        for attempt in (0, 1):
            pconn, plock = self.peer(p)
            with plock:
                try:
                    pconn.send(tag, payload)
                    return pconn.recv()
                except (ConnectionError, OSError):
                    self.drop_peer(p)
                    if attempt:
                        raise


def _peak_mib(dev):
    if dev.type != "cuda":
        return 0.0
    return round(torch.cuda.max_memory_allocated(dev) / 2**20, 1)


def _sdc_due(state, tag):
    """True when the data-plane chaos should corrupt the result just
    computed for `tag` (runtime/faults.py, at=data)."""
    if state.faults is None or not state.faults.on_data(state.me, tag):
        return False
    with state.lock:
        state.sdc_injected += 1
    olog.emit("worker", "sdc_injected", level="warn", worker=state.me,
              tag=protocol.tag_name(tag))
    return True


# sum_j row[j] * base^j — exactly dense-poly Horner evaluation
_horner = poly_eval


def _fft2_partials(task, point):
    """The integrity piggyback (runtime/integrity.py): (input-side,
    output-side) partial power sums at the dispatcher's random point.
    Input side walks the RAW stage-1 rows as received (flat index
    j1*c + j2 -> row j2 Horner in base t^c, scaled t^j2); output side
    walks the computed result panel (flat index k1 + r*k2 -> row k1
    Horner in base t^r, scaled t^k1). Both come from the buffers the data
    plane serves, so an SDC in either shows up in the partials exactly as
    in the data. O(n/k) host muls."""
    a = 0
    tc = pow(point, task.c, R_MOD)
    for first_row, panel in sorted(task.raw_panels.items()):
        count, row_len = panel.shape[1], panel.shape[2]
        ints = protocol.matrix_to_ints(panel.reshape(16, count * row_len))
        tk = pow(point, first_row, R_MOD)
        for off in range(count):
            row = ints[off * row_len:(off + 1) * row_len]
            a = (a + _horner(row, tc) * tk) % R_MOD
            tk = tk * point % R_MOD
    b = 0
    vals = protocol.decode_scalars(task.result)
    c = task.c
    tr = pow(point, task.r, R_MOD)
    tk = pow(point, task.cs, R_MOD)
    for k1 in range(task.ce - task.cs):
        b = (b + _horner(vals[k1 * c:(k1 + 1) * c], tr) * tk) % R_MOD
        tk = tk * point % R_MOD
    return a, b


def _stage1_row(backend, domain_r, task, j2, row):
    """Stage-1 oracle for one global row j2 (fft1_helper, reference
    src/worker.rs:66-94), on the int-list API: optional forward-coset
    pre-scale g^(j2 + c*j1), r-point (i)FFT, mid twiddle w^(+-j2*k1).
    torch_stages.StageKernels computes whole panels of these."""
    n, r, c = task.n, task.r, task.c
    if task.coset and not task.inverse:
        gc = pow(FR_GENERATOR, c, R_MOD)
        t = pow(FR_GENERATOR, j2, R_MOD)
        scaled = []
        for v in row:
            scaled.append(v * t % R_MOD)
            t = t * gc % R_MOD
        row = scaled
    out = backend.ifft(domain_r, row) if task.inverse \
        else backend.fft(domain_r, row)
    w = fr_root_of_unity(n)
    base = pow(fr_inv(w) if task.inverse else w, j2, R_MOD)
    t = 1
    tw = []
    for v in out:
        tw.append(v * t % R_MOD)
        t = t * base % R_MOD
    return tw


def _stage2_row(backend, domain_c, task, k1, row):
    """Stage-2 oracle for one global column k1 (fft2_helper, reference
    src/worker.rs:96-115): c-point (i)FFT + inverse-coset post-scale
    g^-(k1 + r*k2); the 1/n factor comes from the two stage iFFTs
    (1/r * 1/c), as in the reference."""
    out = backend.ifft(domain_c, row) if task.inverse \
        else backend.fft(domain_c, row)
    if task.inverse and task.coset:
        g_inv = fr_inv(FR_GENERATOR)
        step = pow(g_inv, task.r, R_MOD)
        t = pow(g_inv, k1, R_MOD)
        scaled = []
        for v in out:
            scaled.append(v * t % R_MOD)
            t = t * step % R_MOD
        return scaled
    return out


def handle(conn, state):
    """Serve one connection until EOF/shutdown. Returns False to stop the
    whole daemon."""
    while True:
        try:
            tag, payload = conn.recv()
        except ConnectionError:
            return True
        try:
            # a TRACED frame carries the caller's {trace_id, parent_id};
            # the request is served under a span in that trace's buffer
            # (shipped back via TRACE_DUMP)
            tag, ctx, payload = protocol.strip_context(tag, payload)
            tracer = state.tracer_for(ctx) if ctx is not None \
                else NULL_TRACER
            parent = ctx.get("parent_id") if ctx else None
            with tracer.span("serve/" + protocol.tag_name(tag).lower(),
                             parent=parent), \
                    state.on_device():
                cont = _dispatch(conn, state, tag, payload, tracer=tracer)
        except Exception as e:  # malformed payload / backend failure
            try:
                conn.send(protocol.ERR, repr(e).encode())
            except ConnectionError:
                return True
            continue
        if cont is False:
            return False


# abandoned FFT tasks (dispatcher died mid-protocol) are purged when older
# than this; COMPLETED tasks (kept only so FFT2 retries can re-read their
# reply) are purged much sooner; both checked on every FFT_INIT
_FFT_TASK_TTL_S = 600.0
_FFT_DONE_TTL_S = 60.0
# hard cap on resident tasks: LRU eviction, completed tasks first (a retry
# after eviction recomputes), then the oldest in-flight
_FFT_TASK_CAP = 64


def _evict_fft_tasks(tasks, cap, now):
    """TTL purge + LRU cap for the task table (state.lock held). Keeps at
    most `cap` - 1 entries so the task the caller is about to insert fits."""
    stale = [tid for tid, t in tasks.items()
             if (now - t.created > _FFT_TASK_TTL_S
                 or (t.done_at is not None
                     and now - t.done_at > _FFT_DONE_TTL_S))]
    for tid in stale:
        del tasks[tid]
    room = max(cap - 1, 0)
    if len(tasks) <= room:
        return
    done = sorted((tid for tid, t in tasks.items() if t.done_at is not None),
                  key=lambda tid: tasks[tid].done_at)
    live = sorted((tid for tid, t in tasks.items() if t.done_at is None),
                  key=lambda tid: tasks[tid].created)
    for tid in done + live:
        if len(tasks) <= room:
            break
        del tasks[tid]


def _dispatch(conn, state, tag, payload, tracer=NULL_TRACER):
    """Handle one request frame. Returns False to stop the daemon, anything
    else to keep serving.

    Locking: state.lock guards only STATE lookups/mutations (base sets,
    domain/task tables); kernels run OUTSIDE it, so one worker overlaps
    compute for concurrent connections."""
    state.count(tag)
    if tag == protocol.PING:
        conn.send(protocol.OK)
    elif tag == protocol.INIT_BASES:
        set_id, bases = protocol.decode_init_bases(payload)
        with state.lock:
            state.base_sets[set_id] = bases
        conn.send(protocol.OK)
    elif tag == protocol.MSM:
        set_id, scalars = protocol.decode_msm_request(payload)
        with state.lock:
            bases = state.base_sets.get(set_id)
        if bases is None:
            conn.send(protocol.ERR, b"no bases for set %d" % set_id)
            return None
        work = {"flops": msm_flops(len(scalars)),
                "data_bytes": len(scalars) * FR_BYTES}
        t0 = time.perf_counter()
        with tracer.span("msm", n=len(scalars), **work):
            result = state.backend.msm(bases, scalars)  # a host point
        state.observe_kernel("msm", time.perf_counter() - t0, **work)
        if _sdc_due(state, protocol.MSM):
            # a WELL-FORMED wrong answer (on the curve, in the subgroup):
            # only duplicate execution can catch it
            from .. import curve as C
            result = C.g1_add_affine(result, C.G1_GEN)
        conn.send(protocol.OK, protocol.encode_point(result))
    elif tag == protocol.NTT:
        values, inverse, coset = protocol.decode_ntt_request(payload)
        with state.lock:
            domain = state.domain(len(values))
        work = {"flops": ntt_flops(len(values)),
                "data_bytes": len(values) * FR_BYTES}
        t0 = time.perf_counter()
        with tracer.span("ntt", n=len(values), inverse=inverse, coset=coset,
                         **work):
            # the int-list API returns host ints: the interval ends after
            # the device work
            if inverse and coset:
                out = state.backend.coset_ifft(domain, values)
            elif inverse:
                out = state.backend.ifft(domain, values)
            elif coset:
                out = state.backend.coset_fft(domain, values)
            else:
                out = state.backend.fft(domain, values)
        state.observe_kernel("ntt", time.perf_counter() - t0, **work)
        if _sdc_due(state, protocol.NTT):
            out = list(out)
            out[0] = (out[0] + 1) % R_MOD  # one flipped field element
        conn.send(protocol.OK,
                  protocol.encode_scalar_matrix(protocol.ints_to_matrix(out)))
    elif tag == protocol.FFT_INIT:
        (task_id, inverse, coset, n, r, c, rs, re,
         col_ranges, epoch, keep_raw) = protocol.decode_fft_init(payload)
        now = time.monotonic()
        with state.lock:
            if epoch and state.epoch and epoch != state.epoch:
                # a roster mismatch in EITHER direction is unservable: an
                # older plan's col_ranges no longer match the fleet, and a
                # newer one names peers this worker's table lacks (it
                # missed a push); the dispatcher re-pushes the roster and
                # replans (epoch 0 on either side: no membership plane,
                # always accepted)
                state.counters["stale_epoch"] = \
                    state.counters.get("stale_epoch", 0) + 1
                conn.send(protocol.ERR,
                          b"stale epoch: frame %d, roster %d"
                          % (epoch, state.epoch))
                return None
            _evict_fft_tasks(state.fft_tasks, _FFT_TASK_CAP, now)
            state.fft_tasks[task_id] = FftTask(
                inverse, coset, n, r, c, rs, re, col_ranges, state.me,
                keep_raw=keep_raw)
        conn.send(protocol.OK)
    elif tag == protocol.FFT1:
        task_id, first_row, panel = protocol.decode_fft1_matrix(payload)
        with state.lock:
            task = state.fft_tasks[task_id]
        count = panel.shape[1]
        if task.keep_raw:
            # the FFT2 integrity piggyback's input-side partial is computed
            # over exactly what we received
            task.raw_panels[first_row] = panel
        work = {"flops": ntt_flops(task.r, count),
                "data_bytes": count * task.r * FR_BYTES}
        t0 = time.perf_counter()
        with tracer.span("fft1_rows", rows=count, r=task.r, **work):
            # a numpy panel: the interval ends after the device work
            staged = state.stages.stage1_panel(task, first_row, panel)
        state.observe_kernel("fft1", time.perf_counter() - t0, **work)
        lo = first_row - task.rs
        with task.cols_lock:
            if task.rows_mat is None:
                task.rows_mat = np.zeros(
                    (16, task.re - task.rs, task.r), dtype=np.uint32)
            task.rows_mat[:, lo:lo + count, :] = staged
            task.rows_filled[lo:lo + count] = True
        conn.send(protocol.OK)
    elif tag == protocol.FFT2_PREPARE:
        (task_id,) = struct.unpack_from("<Q", payload, 0)
        with state.lock:
            task = state.fft_tasks[task_id]
        # push every peer its column slice of our rows (the all-to-all,
        # worker.rs:280-345); each send waits for the peer's ACK, so our OK
        # to the dispatcher implies all our data has landed. Rows go out as
        # ONE contiguous limb panel per peer.
        if task.re > task.rs:
            # loud failure if any row range never saw an FFT1 frame: the
            # zero-initialized panel must not ship silently
            assert task.rows_mat is not None and task.rows_filled.all(), \
                f"fft2_prepare before stage 1 complete " \
                f"({task.rows_filled.sum()}/{task.rows_filled.size})"
            # re-inject our trace context into each peer frame so the
            # receiving workers' exchange spans land in the SAME trace
            with tracer.span("fft_exchange_push") as push_sid:
                for p, (ps, pe) in enumerate(task.col_ranges):
                    if pe == ps:
                        continue
                    panel = np.ascontiguousarray(task.rows_mat[:, :, ps:pe])
                    xtag, xpayload = protocol.FFT_EXCHANGE, \
                        protocol.encode_fft_exchange(
                            task_id, ps, pe - ps, task.rs, panel)
                    if push_sid is not None:
                        xtag, xpayload = protocol.wrap_traced(
                            xtag, xpayload, {"trace_id": tracer.trace_id,
                                             "parent_id": push_sid})
                    rtag, rpayload = state.peer_call(p, xtag, xpayload)
                    if rtag != protocol.OK:
                        raise RuntimeError(
                            f"peer {p} exchange failed: {rpayload!r}")
        conn.send(protocol.OK)
    elif tag == protocol.FFT_EXCHANGE:
        task_id, col_start, col_count, row_start, panel = \
            protocol.decode_fft_exchange(payload)
        with state.lock:
            task = state.fft_tasks[task_id]
        lo = col_start - task.cs
        with task.cols_lock:
            task.cols[:, lo:lo + col_count,
                      row_start:row_start + panel.shape[1]] = \
                panel.transpose(0, 2, 1)
            task.fill_mask[lo:lo + col_count,
                           row_start:row_start + panel.shape[1]] = True
        conn.send(protocol.OK)
    elif tag == protocol.FFT2:
        task_id, check_point = protocol.decode_fft2_request(payload)
        with state.lock:
            task = state.fft_tasks[task_id]
        if task.result is None:
            assert task.fill_mask.all(), \
                f"fft2 before exchange complete ({task.fill_mask.sum()}" \
                f"/{task.fill_mask.size})"
            task.result = b""
            if task.ce > task.cs:
                cols = task.ce - task.cs
                work = {"flops": ntt_flops(task.c, cols),
                        "data_bytes": cols * task.c * FR_BYTES}
                t0 = time.perf_counter()
                with tracer.span("fft2_cols", cols=cols, c=task.c, **work):
                    staged = state.stages.stage2_panel(task, task.cols)
                state.observe_kernel("fft2", time.perf_counter() - t0,
                                     **work)
                task.result = protocol.encode_scalar_matrix(
                    staged.reshape(16, staged.shape[1] * staged.shape[2]))
            if task.result and _sdc_due(state, protocol.FFT2):
                # one element perturbed IN the cached buffer: retries and
                # the integrity partials see the same wrong result
                v = (protocol.decode_scalar(task.result) + 1) % R_MOD
                task.result = protocol.encode_scalar(v) \
                    + task.result[protocol.FR_BYTES:]
            task.done_at = time.monotonic()
        if check_point is not None and task.result \
                and (task.keep_raw or task.re <= task.rs):
            # integrity piggyback: (input-side, output-side) partial power
            # sums at the dispatcher's random point. A task whose FFT_INIT
            # did not announce the plane answers plain.
            a, b = _fft2_partials(task, check_point)
            conn.send(protocol.OK,
                      protocol.encode_fft2_partials(a, b, task.result))
        else:
            conn.send(protocol.OK, task.result)
    elif tag == protocol.EVAL:
        # distributed partial evaluation (round 4 of the fleet prove):
        # sum_i c_i * point^i over the shipped coefficient chunk
        point, chunk = protocol.decode_eval_request(payload)
        # Horner: one Fr product per coefficient
        work = {"flops": len(chunk) * FR_MUL_IMADS,
                "data_bytes": len(chunk) * FR_BYTES}
        t0 = time.perf_counter()
        with tracer.span("eval", n=len(chunk), **work):
            val = state.backend.eval_h(state.backend.lift(chunk), point)
        state.observe_kernel("eval", time.perf_counter() - t0, **work)
        if _sdc_due(state, protocol.EVAL):
            val = (val + 1) % R_MOD
        conn.send(protocol.OK, protocol.encode_scalar(val))
    elif tag == protocol.STATS:
        with state.lock:
            snap = dict(state.counters)
        conn.send(protocol.OK, json.dumps(snap).encode())
    elif tag == protocol.HEALTH:
        conn.send(protocol.OK, json.dumps(state.health()).encode())
    elif tag == protocol.ROSTER:
        # membership push: adopt the epoch table iff it is NEWER (epochs
        # only move forward), and drop every cached peer stream: indices
        # are stable, but a rejoin means the old socket to that index is
        # dead
        req = protocol.decode_json(payload)
        new_epoch = int(req.get("epoch", 0))
        adopted = False
        with state.lock:
            if new_epoch > state.epoch:
                state.epoch = new_epoch
                state.config = NetworkConfig(req.get("workers", []))
                adopted = True
        if adopted:
            with state.peer_lock:
                stale = list(state.peers)
            for p in stale:
                state.drop_peer(p)
        conn.send(protocol.OK, json.dumps(
            {"epoch": state.epoch, "adopted": adopted}).encode())
    elif tag == protocol.TRACE_DUMP:
        # fetch-and-forget one trace's worker-side spans; an unknown id
        # answers {}
        req = protocol.decode_json(payload)
        tr = state.pop_trace(req.get("trace_id"))
        conn.send(protocol.OK,
                  json.dumps(tr.dump() if tr is not None else {}).encode())
    elif tag == protocol.STORE_FETCH:
        # peer-serving plane: a replacement host pulls SRS/pk/checkpoint
        # blobs from us instead of rebuilding them
        from ..store import remote as store_remote
        store_remote.serve_fetch(
            state.store, payload, conn,
            no_store_reason="no store on this worker (--store)")
    elif tag == protocol.STORE_LIST:
        from ..store import remote as store_remote
        store_remote.serve_list(
            state.store, payload, conn,
            no_store_reason="no store on this worker (--store)")
    elif tag == protocol.METRICS_FETCH:
        # the fleet-scrape surface (obs/fleet.py): this worker's whole
        # structured registry plus identity fields, one JSON blob
        snap = state.metrics.snapshot()
        with state.lock:
            snap.update({
                "index": state.me,
                "epoch": state.epoch,
                "backend": state.backend.name,
                "device": str(state.backend.device),
                "uptime_s": round(time.monotonic() - state.started, 3),
                "sdc_injected": state.sdc_injected,
                "fft_tasks": len(state.fft_tasks),
                "base_sets": len(state.base_sets),
                "traces": len(state.traces),
                "log_seq": olog.buffer().seq,
                "autotune": state.autotune,
                "build": _build.report(),
            })
        conn.send(protocol.OK, json.dumps(snap).encode())
    elif tag == protocol.LOG_FETCH:
        # structured-log ring fetch (obs/log.py), optionally filtered to
        # one trace id or tailed from since_seq; reads never clear it
        req = protocol.decode_json(payload)
        out = olog.fetch(trace_id=req.get("trace_id"),
                         since_seq=int(req.get("since_seq") or 0),
                         limit=req.get("limit"))
        conn.send(protocol.OK, json.dumps(out).encode())
    elif tag == protocol.PROFILE:
        # on-demand capture (obs/profiling.py): torch.profiler on the
        # card, the stack sampler on the host. It blocks only this
        # connection's thread; the kernels other connections run are what
        # it records. The reply is header + blob, as STORE_FETCH's.
        req = protocol.decode_json(payload)
        meta, blob = profiling.capture(
            duration_ms=req.get("duration_ms"),
            kind=req.get("kind", "auto"), device=state.backend.device)
        meta["worker"] = state.me
        state.metrics.inc("profiles_captured")
        olog.emit("worker", "profile_captured", worker=state.me,
                  format=meta.get("format"), bytes=len(blob))
        conn.send(protocol.OK, protocol.encode_result(meta, blob))
    elif tag == protocol.SHUTDOWN:
        conn.send(protocol.OK)
        return False
    else:
        conn.send(protocol.ERR, b"unknown tag")
    return None


def _run_server(listener, state, ready_event=None):
    """Accept loop until a SHUTDOWN frame lands."""
    if ready_event is not None:
        ready_event.set()
    stop = threading.Event()

    def run_conn(conn):
        if not handle(conn, state):
            stop.set()
        conn.close()

    def accept_loop():
        while True:
            conn = listener.accept()
            if conn.fd < 0:
                return
            threading.Thread(target=run_conn, args=(conn,),
                             daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()
    stop.wait()  # SHUTDOWN flips this; daemon threads die with the process
    listener.close()


def _make_state(device, store_dir, faults, build_dir=None, **kw):
    """The worker's backend on `device` (None: the card, raising without
    one; "cpu" runs the kernels' plain versions), its artifact store at
    `store_dir` (served over STORE_FETCH/STORE_LIST), its data-plane
    rules (`faults`: the text form of runtime/faults.py, or None) and the
    kernels' build directory (None: the checkout's)."""
    if build_dir is not None:
        _build.set_build_dir(build_dir)
    backend = TorchBackend(device)
    stages = StageKernels(backend.device)
    store = None
    if store_dir is not None:
        from ..store import ArtifactStore
        store = ArtifactStore(store_dir)
    injector = FaultInjector(parse_rules(faults)) if faults else None
    return WorkerState(backend, stages, store=store, faults=injector, **kw)


def _load_calibration(state, mode):
    """Adopt the store's kernel plan for this card (store/calibration.py;
    mode off|load|run) and record the report in state.autotune (served
    in METRICS_FETCH). Without a store there is nothing to load. A plan
    only changes launch arguments, so a failure leaves the built-in
    constants in force: it is recorded as {"source": "error", ...} and
    logged, never hidden and never fatal."""
    if state.store is None:
        return state.autotune
    from ..store import calibration
    try:
        rep = calibration.load_or_run(state.store, mode=mode,
                                      metrics=state.metrics,
                                      device=state.backend.device)
    except Exception as e:  # noqa: BLE001 - see the docstring
        rep = {"source": "error", "error": repr(e)[:300]}
        olog.emit("worker", "calibration_failed", level="warn",
                  worker=state.me, error=rep["error"])
    state.autotune = rep
    olog.emit("worker", "calibration", worker=state.me,
              source=rep.get("source"), cells=rep.get("cells"))
    return rep


def _provision_kernels(state, peers=()):
    """Give the worker its kernel libraries before its first load, on the
    card only (store/kernels.ensure_build: the build directory, its own
    store, `peers`, else nvcc on a thread; the loaded build is published
    into its own store). Returns backend/_build.build_report's copy, which
    HEALTH serves as `build`."""
    if state.backend.device.type != "cuda":
        return None
    from ..store import kernels
    rep = kernels.ensure_build(state.store, peers,
                               device=state.backend.device,
                               metrics=state.metrics)
    olog.emit("worker", "kernel_build", worker=state.me, **rep)
    return rep


def serve(index, config, device=None, ready_event=None, store_dir=None,
          faults=None, autotune="load", build_dir=None):
    """Static-fleet daemon: index and config fixed at startup (epoch 0)."""
    host, port = config.workers[index]
    state = _make_state(device, store_dir, faults, build_dir=build_dir,
                        config=config, me=index)
    listener = native.Listener(host, port)
    _provision_kernels(state)
    _load_calibration(state, autotune)
    _run_server(listener, state, ready_event=ready_event)


def serve_joined(join_addr, listen_addr=("127.0.0.1", 0), device=None,
                 store_dir=None, faults=None, ready_event=None,
                 autotune="load", build_dir=None):
    """Dynamic-membership daemon (`--join host:port`): build the backend
    (a worker that cannot reach its device raises before it joins), bind
    (port 0 = ephemeral), announce to the membership server, adopt the
    returned index, epoch and roster, and serve. Then warm-rejoin in the
    background: pull the roster's store peers' `bucket:` and `autotune:`
    artifacts (store/remote.warm_sync) so a replacement worker finds its
    keys and this card's kernel plan without a rebuild, adopt the plan,
    and report the stats (JOIN phase=ready; HEALTH's `warm`). The worker
    is schedulable from the JOIN reply; the sync only speeds up first
    touches, it gates nothing. Before the sync the worker only LOADS a
    local plan: a joiner must not spend its start measuring when a peer
    may hold this card's plan; `autotune` applies after the sync.

    The kernel build is the exception: it is pulled (or found) between
    the JOIN reply and the accept loop, synchronously, because a request
    that reached the worker first would start minutes of nvcc inside its
    kernel load (_provision_kernels; the JOIN's store peers are its third
    tier). Early requests wait in the listener's backlog meanwhile."""
    from . import membership
    from ..backend import autotune as _autotune
    state = _make_state(device, store_dir, faults, build_dir=build_dir)
    _load_calibration(state, "load" if autotune != "off" else "off")
    host, port = listen_addr
    listener = native.Listener(host, port)
    port = port or native.listener_port(listener)
    reply = membership.join_fleet(join_addr[0], join_addr[1], host, port,
                                  store=store_dir is not None)
    with state.lock:
        state.config = NetworkConfig(reply["workers"])
        state.me = int(reply["index"])
        state.epoch = int(reply["epoch"])
    olog.emit("worker", "joined", worker=state.me, port=port,
              epoch=state.epoch, device=str(state.backend.device))
    me = f"{host}:{port}"
    peers = [(h, int(p)) for h, p in (
        a.rsplit(":", 1) for a in reply.get("stores", []) if a != me)]
    _provision_kernels(state, peers)

    def warm_sync():
        from ..store import remote as store_remote
        stats = {"warm_rejoin_s": 0.0, "artifacts": 0, "peers": 0,
                 "errors": 0}
        if state.store is not None and peers:
            stats = store_remote.warm_sync(state.store, peers)
        stats["kernel_build"] = _build.report()
        if _autotune.active_plan() is None:
            _load_calibration(state, autotune)
        state.warm = stats
        olog.emit("worker", "warm_rejoin", worker=state.me, **stats)
        if state.store is not None:
            # a storeless joiner has nothing to sync: a report would count
            # a zero-length warm rejoin
            membership.report_ready(join_addr[0], join_addr[1], host,
                                    port, stats)

    threading.Thread(target=warm_sync, daemon=True).start()
    _run_server(listener, state, ready_event=ready_event)


def _pop_flag(argv, flag):
    """(value of `flag VALUE` in argv or None, argv without the pair)."""
    if flag not in argv:
        return None, argv
    i = argv.index(flag)
    return argv[i + 1], argv[:i] + argv[i + 2:]


def _parse_hostport(s):
    h, _, p = s.rpartition(":")
    return h or "127.0.0.1", int(p)


USAGE = ("usage: python -m distributed_plonk_tpu_torch.runtime.worker "
         "(<index> <network.json> | --join H:P [--listen H:P]) "
         "[--device cuda|cpu] [--store DIR] [--build-dir DIR] "
         "[--faults RULES] [--autotune off|load|run]")


def main(argv):
    device, argv = _pop_flag(argv, "--device")
    store_dir, argv = _pop_flag(argv, "--store")
    build_dir, argv = _pop_flag(argv, "--build-dir")
    faults, argv = _pop_flag(argv, "--faults")
    join, argv = _pop_flag(argv, "--join")
    listen, argv = _pop_flag(argv, "--listen")
    autotune, argv = _pop_flag(argv, "--autotune")
    autotune = autotune or "load"
    if autotune not in ("off", "load", "run"):
        raise SystemExit(USAGE)
    if join is not None:
        if argv:
            raise SystemExit(USAGE)
        serve_joined(_parse_hostport(join),
                     _parse_hostport(listen) if listen
                     else ("127.0.0.1", 0),
                     device, store_dir=store_dir, faults=faults,
                     autotune=autotune, build_dir=build_dir)
        return
    if len(argv) != 2 or listen is not None:
        raise SystemExit(USAGE)
    serve(int(argv[0]), NetworkConfig.load(argv[1]), device,
          store_dir=store_dir, faults=faults, autotune=autotune,
          build_dir=build_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
