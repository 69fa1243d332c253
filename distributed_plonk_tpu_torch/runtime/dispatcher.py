"""Dispatcher client: drives a worker fleet over the native transport.

The port's copy of the JAX package's runtime/dispatcher.py (WorkerHandle,
Dispatcher, RemoteBackend). It speaks the same wire protocol, so it drives
the port's workers (runtime/worker.py, kernels on the card) and the JAX
package's alike. Dynamic membership (`enable_membership`: JOIN / LEAVE /
ROSTER, runtime/membership.py) grows and shrinks the fleet at runtime.
The observability plane reads the workers over the wire: `fleet_metrics`
(METRICS_FETCH, obs/fleet.py), `fetch_logs` (LOG_FETCH) and
`profile_worker` (PROFILE, obs/profiling.py).

The analog of the reference's dispatcher client library
(reference src/dispatcher.rs:29-175) + the v2 distributed compute
entry points (`Prover::fft` dispatcher2.rs:731-787, `commit_polynomial`
dispatcher2.rs:834-893), with the sharding convention fixed: every worker
receives exactly the base chunk its scalar range covers (the reference
mixed v1 full-broadcast with v2 chunking and indexed out of bounds —
SURVEY.md §2.3.1).

Fault domain (the reference treats every worker failure as an unwrap
panic, src/worker.rs:303): every dispatcher->worker call runs behind a
reconnect loop with exponential backoff + jitter, a per-worker circuit
breaker (runtime/health.py) fast-fails calls to a worker that has died so
its ranges get adopted instead of timing out, half-open probes re-admit a
worker that comes back, and the sharded 4-step FFT re-plans around deaths
at ANY protocol phase (mirroring `_recover_msm`), and a deterministic fault
injector (runtime/faults.py, wire and proc planes) can be threaded through
every frame for chaos runs. Only a lost connection is routed around; an
ERR reply (the worker is alive and its code or its kernel failed) raises
WorkerError to the caller, except a stale-epoch FFT_INIT, which the
sharded FFT answers with a roster push and a replan. Every recovery is
counted in the duck-typed `metrics` registry (inc / gauge / observe):
fleet_reconnects, fleet_backoff_waits, fleet_breaker_opens,
fleet_range_adoptions, fleet_ntt_reroutes, fleet_eval_reroutes,
fleet_readmissions, fleet_fft_replans, fleet_fft_degraded,
workers_quarantined.
"""

import concurrent.futures as futures
import json
import random
import struct
import threading
import time

import numpy as np

from contextlib import nullcontext

from . import native, protocol
from .health import LivenessTracker, NullMetrics
from .integrity import (REFEREE_MAX, FleetIntegrity, IntegrityError,
                        g1_sane, power_sum)
from .. import curve as C
from .. import poly as P
from ..backend import curve_torch as CT
from ..backend.python_backend import PythonBackend
from ..constants import R_MOD
from ..obs import log as olog
from ..trace import merge_traces

# worker-side base-set id reserved for known-answer challenges: range ids
# are fleet positions (small ints), so a huge constant can never collide
CHALLENGE_SET_ID = 1 << 62

# what a lost connection raises; the one failure the dispatcher routes
# around (WorkerUnavailable, a breaker-open fast-fail, is one of these)
_LOST = (ConnectionError, OSError)


def _split_rc(n):
    """n = r*c with r = 2^floor(log2(n)/2) (the reference's domain split,
    reference src/worker.rs:142-155)."""
    log_n = n.bit_length() - 1
    r = 1 << (log_n // 2)
    return r, n // r


class _Failure:
    def __init__(self, err):
        self.err = err


def _try(fn, arg):
    """Capture a worker failure as a value so a pool.map survives it."""
    try:
        return fn(arg)
    except Exception as e:
        return _Failure(e)


class WorkerUnavailable(ConnectionError):
    """Fast-fail for a breaker-open worker: no dial, no timeout burned."""


class FleetError(RuntimeError):
    """A distributed protocol attempt lost at least one worker."""


class WorkerError(RuntimeError):
    """An ERR reply: the worker is alive and its handler (its code or its
    kernel) failed. Never routed around."""


class WorkerHandle:
    """One framed connection to a worker, with a per-call timeout and a
    bounded reconnect loop (exponential backoff + jitter) — replacing the
    single reconnect-retry of earlier rounds; the reference has neither
    (every RPC there is .unwrap(), SURVEY.md §5: a worker crash hangs the
    prove).

    A timeout mid-frame desynchronizes the stream, so recovery is always
    reconnect-then-retry, never resend on the same socket. Retried requests
    are idempotent at the worker (MSM/NTT are pure; FFT1/FFT_EXCHANGE
    overwrite the same slots; FFT2 replays its cached reply instead of
    deleting the task — completed tasks are GC'd by age + LRU cap).

    The connection is LAZY: constructing a handle to a not-yet-alive
    worker is fine; the first call dials."""

    # per-call timeout (a CPU worker's FFT2 at 2^21 takes minutes), dial
    # attempts per call, and the backoff between them (seconds)
    TIMEOUT_MS = 600000
    RECONNECT_TRIES = 3
    BACKOFF_BASE_S = 0.05
    BACKOFF_MAX_S = 2.0

    def __init__(self, host, port, index=0, tracker=None, metrics=None,
                 tracer=None, faults=None):
        self.host, self.port = host, port
        self.index = index
        self.tracker = tracker
        self.metrics = metrics or NullMetrics()
        # runtime/faults.FaultInjector (wire and proc planes) or None
        self.faults = faults
        # tracer: when set, every call records an rpc span and injects
        # its {trace_id, parent_id} into the frame (protocol.TRACED), so
        # the worker's serve/kernel spans land in the same trace
        self.tracer = tracer
        self.conn = None
        # one in-flight request per connection: frames are not interleavable
        self._lock = threading.Lock()

    def _connect(self):
        # bound the dial by the call timeout too: a partitioned worker
        # (dropped SYNs) must cost one timeout, not the OS connect
        # default of minutes
        conn = native.connect(self.host, self.port,
                              timeout_ms=self.TIMEOUT_MS)
        if self.TIMEOUT_MS:
            conn.set_timeout(self.TIMEOUT_MS)
        return conn

    def _drop_conn_locked(self):
        """self._lock held (the reconnect loop's own drop)."""
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def drop_conn(self):
        """Discard the cached stream so the next call dials fresh (the
        dispatcher's probe/readmit paths know it is or may be stale).
        Takes the call lock: never closes a socket mid-request."""
        with self._lock:
            self._drop_conn_locked()

    def call(self, tag, payload=b"", traced=True, parent=None):
        """Send one request; reconnect with backoff on transport failure.
        Raises WorkerUnavailable without dialing when the breaker is open
        (callers adopt the range / replan instead of burning a timeout),
        ConnectionError when every reconnect try failed, WorkerError on
        an ERR reply (the worker is ALIVE — errors don't count against
        the breaker). With a tracer armed, the call is recorded
        as an rpc span and its context rides the frame (traced=False
        opts a control call out, e.g. TRACE_DUMP itself); `parent` links
        the span explicitly when the call runs on an executor thread
        that cannot see the caller's span stack (the fleet fan-outs)."""
        if self.tracker is not None and not self.tracker.usable(self.index):
            raise WorkerUnavailable(f"worker {self.index} breaker open")
        span = nullcontext() if self.tracer is None or not traced else \
            self.tracer.span(f"rpc/{protocol.tag_name(tag).lower()}",
                             parent=parent)
        try:
            with span as span_sid, self._lock:
                if span_sid is not None:
                    # context computed once, outside the retry loop: a
                    # reconnect resends the identical (idempotent) frame;
                    # its parent is the rpc span, open on this thread
                    _, payload = protocol.wrap_traced(
                        tag, payload, self.tracer.context())
                rtag, rpayload = self._call_locked(
                    tag, payload, traced=span_sid is not None)
        except (ConnectionError, OSError):
            if self.tracker is not None:
                self.tracker.record_failure(self.index)
            raise
        if self.tracker is not None:
            self.tracker.record_ok(self.index)
        if rtag != protocol.OK:
            raise WorkerError(f"worker {self.index} error: {rpayload!r}")
        return rpayload

    def _call_locked(self, tag, payload, traced=False):
        delay = self.BACKOFF_BASE_S
        for attempt in range(self.RECONNECT_TRIES):
            try:
                if self.conn is None:
                    self.conn = self._connect()
                wire_tag = tag
                if self.faults is not None:
                    # may sleep (delay), raise InjectedDrop (drop),
                    # scramble the tag (corrupt) or kill the worker
                    # (kill); rules match the BASE tag, TRACED rides on
                    # whatever tag the injector returns
                    wire_tag = self.faults.on_send(self.index, tag, payload)
                if traced:
                    wire_tag |= protocol.TRACED
                self.conn.send(wire_tag, payload)
                return self.conn.recv()
            except (ConnectionError, OSError):
                self._drop_conn_locked()
                if attempt + 1 >= self.RECONNECT_TRIES:
                    raise
                # exponential backoff with jitter: a fleet of callers
                # retrying a flapping worker must not stampede it
                sleep_s = min(self.BACKOFF_MAX_S, delay) \
                    * (1.0 + 0.5 * random.random())
                delay *= 2
                self.metrics.inc("fleet_reconnects")
                self.metrics.inc("fleet_backoff_waits")
                self.metrics.observe("fleet_backoff", sleep_s)
                time.sleep(sleep_s)
        raise ConnectionError("unreachable")  # pragma: no cover

    def probe(self, timeout_ms=5000):
        """Liveness check on a FRESH short-timeout connection (half-open
        breaker probe): never touches the cached stream, so a probe racing
        a real call cannot desynchronize it. Returns the HEALTH snapshot
        dict, or None when the worker is unreachable."""
        try:
            # timeout covers the dial as well: probes are the breaker's
            # fast-fail plane and must never block on a partitioned host
            conn = native.connect(self.host, self.port,
                                  timeout_ms=timeout_ms)
        except (ConnectionError, OSError):
            return None
        try:
            conn.set_timeout(timeout_ms)
            conn.send(protocol.HEALTH)
            rtag, rpayload = conn.recv()
            if rtag != protocol.OK:
                return None
            return json.loads(rpayload.decode() or "{}")
        except (ConnectionError, OSError, ValueError):
            return None
        finally:
            conn.close()

    def close(self):
        self.drop_conn()


class Dispatcher:
    """Connections to every worker + distributed MSM / NTT offload, with
    liveness tracking, breaker-gated routing, and re-admission probes."""

    # below this many usable workers a sharded FFT runs whole on one
    FFT_QUORUM = 2

    def __init__(self, config, metrics=None, tracer=None, faults=None):
        self.metrics = metrics or NullMetrics()
        # chaos (runtime/faults.FaultInjector, wire and proc planes) on
        # every frame this dispatcher sends; None keeps the path plain
        self.faults = faults
        # result-integrity plane (runtime/integrity.py): algebraic phase
        # checks on every sharded FFT / NTT offload, duplicate-execution
        # sampling + group-law sanity on MSM partials, dup-checked
        # distributed round-4 evaluation, and quarantine of attributed
        # liars. Always on.
        self.integrity = FleetIntegrity(metrics=self.metrics)
        # tracer: arms the distributed trace plane — every worker call
        # becomes an rpc span carrying context over the wire, and
        # collect_trace() stitches the workers' spans back into one
        # offset-corrected timeline. None keeps the hot path span-free.
        self.tracer = tracer
        self.tracker = LivenessTracker(len(config.workers),
                                       metrics=self.metrics)
        self.workers = [
            WorkerHandle(h, p, index=i, tracker=self.tracker,
                         metrics=self.metrics, tracer=tracer, faults=faults)
            for i, (h, p) in enumerate(config.workers)]
        # headroom past the initial width: membership can grow the fleet
        # mid-life (an undersized executor only costs parallelism)
        self.pool = futures.ThreadPoolExecutor(
            max_workers=max(8, 2 * len(self.workers)))
        self._ranges = None
        self._bases = None
        self._adopted = {}  # base-range i -> worker j that adopted it
        # ranges whose INIT_BASES push failed at the last provisioning:
        # their nominal owner may hold a STALE same-id set from an
        # earlier init_bases, so routing there would succeed with wrong
        # bases — these ranges go straight to the adoption path instead
        self._unprovisioned = set()
        self.quarantined = {}
        # dynamic membership (runtime/membership.py): enable_membership()
        # arms it; a fleet without it is static (epoch 0 frames, fixed
        # width)
        self.membership = None
        self._member_server = None

    @property
    def epoch(self):
        """Current membership-roster version (0 = static fleet)."""
        return self.membership.epoch if self.membership is not None else 0

    def enable_membership(self, host="127.0.0.1", port=0):
        """Own a membership registry and serve it (JOIN/LEAVE/ROSTER) on
        `host:port` (0 = ephemeral). Returns the MembershipServer (its
        `.port` is what workers pass to --join)."""
        from .membership import MembershipRegistry, MembershipServer
        if self.membership is None:
            self.membership = MembershipRegistry(
                self, metrics=self.metrics, tracer=self.tracer)
        if self._member_server is None:
            self._member_server = MembershipServer(
                self.membership, host=host, port=port)
        return self._member_server

    def adopt_worker(self, host, port):
        """Append one worker to the fleet (the membership JOIN path);
        returns its index. Indices are stable forever: the sharded FFT's
        col_ranges and the MSM range table keep indexing by fleet
        position. The new worker is schedulable at once: the next
        fft_dist attempt plans over the wider usable set and the next
        init_bases() range-shards across the full width; until then it
        serves NTTs and adopts dead MSM ranges like any survivor."""
        i = self.tracker.add_worker()
        self.workers.append(
            WorkerHandle(host, port, index=i, tracker=self.tracker,
                         metrics=self.metrics, tracer=self.tracer,
                         faults=self.faults))
        return i

    def _log(self, event, level="info", **fields):
        """One structured log event (obs/log.py) under the dispatcher
        subsystem, trace-correlated when a tracer is armed."""
        olog.emit("dispatcher", event, level=level,
                  trace_id=self.tracer.trace_id
                  if self.tracer is not None else None, **fields)

    def ping(self):
        for w in self.workers:
            w.call(protocol.PING)

    def health(self):
        """Fresh-probe HEALTH snapshot per worker (None = unreachable),
        annotated with the dispatcher-side quarantine verdict."""
        snaps = [w.probe() for w in self.workers]
        for i, s in enumerate(snaps):
            if s is not None:
                s["suspect"] = self.tracker.is_suspect(i)
        return snaps

    # -- liveness maintenance -------------------------------------------------

    def _probe_fleet(self):
        """Find out who is ACTUALLY dead after a distributed attempt
        failed: a worker often reports a peer's death as its own error
        (FFT2_PREPARE push to a dead peer), so failure attribution needs a
        direct probe of everyone. Probes run concurrently; dead workers
        get the breaker opened immediately (authoritative evidence)."""
        def one(iw):
            i, w = iw
            if self._left(i):
                return  # decommissioned: stays dead regardless of probes
            if w.probe() is None:
                self.tracker.mark_dead(i)
                w.drop_conn()
            else:
                self.tracker.record_ok(i)
        list(self.pool.map(one, enumerate(self.workers)))

    def _left(self, i):
        """True for a member declared permanently gone via LEAVE: the
        re-admission planes must not probe or revive it (a decommissioned
        address may still answer); only an explicit JOIN brings it
        back."""
        return self.membership is not None and self.membership.is_left(i)

    def _maybe_readmit(self):
        """Half-open probes for breaker-open workers whose backoff window
        elapsed; a worker that answers is re-admitted and (if bases are
        provisioned) gets its original MSM range re-uploaded so routing
        rebalances instead of leaning on the adopter forever."""
        for i in self.tracker.due_probes():
            if self._left(i):
                continue
            w = self.workers[i]
            if w.probe() is None:
                self.tracker.record_failure(i)
                continue
            w.drop_conn()  # stale pre-death stream, if any
            self.tracker.record_ok(i)  # counts fleet_readmissions
            self._log("readmitted", worker=i)
            self._reprovision(i)

    def _reprovision(self, i):
        """Best effort: push range i's bases back to a re-admitted worker
        i and drop the adoption redirect. A failure here is harmless —
        the lazy recovery path re-adopts at the next msm()."""
        if self._ranges is None or i >= len(self._ranges):
            return
        start, end = self._ranges[i]
        if end <= start:
            return
        try:
            self.workers[i].call(
                protocol.INIT_BASES,
                protocol.encode_init_bases(i, self._bases[start:end]))
            self._adopted.pop(i, None)
            self._unprovisioned.discard(i)
        except Exception:
            pass

    # -- MSM ------------------------------------------------------------------

    def init_bases(self, bases):
        """Range-shard the SRS: worker i holds bases[start_i:end_i]
        (contiguous split, like MsmWorkload ranges) under set id i. The
        full base list is retained host-side so a dead worker's range can
        be re-provisioned onto a healthy worker mid-prove."""
        n = len(bases)
        k = len(self.workers)
        bounds = [n * i // k for i in range(k + 1)]
        self._ranges = list(zip(bounds[:-1], bounds[1:]))
        self._bases = bases
        self._adopted = {}
        # a worker that is dead at provisioning time is tolerated: its
        # range stays unowned and the first msm() adopts it onto a healthy
        # worker through the same lazy-recovery path as a mid-prove death.
        # The map MUST be materialized with list(): Executor.map's result
        # generator CANCELS still-pending futures when it is closed
        # early, so a short-circuiting consumer (the old `all(...)`)
        # could silently skip a worker's INIT_BASES under load — leaving
        # a STALE same-id base set from an earlier provisioning on an
        # alive worker, which then serves later MSMs with wrong bases
        # (caught live as an intermittent wrong-proof in the fleet-TCP
        # tests). Failed pushes are remembered in _unprovisioned so
        # msm() routes those ranges through recovery instead of trusting
        # the nominal owner.
        with self._span("fleet/init_bases") as prov_sid:
            results = list(self.pool.map(
                lambda iw: _try(
                    lambda iw: iw[1].call(protocol.INIT_BASES,
                                          protocol.encode_init_bases(
                                              iw[0],
                                              bases[self._ranges[iw[0]][0]:
                                                    self._ranges[iw[0]][1]]),
                                          parent=prov_sid),
                    iw),
                enumerate(self.workers)))
            self._unprovisioned = {
                i for i, r in enumerate(results) if isinstance(r, _Failure)}
            if results and len(self._unprovisioned) == len(results):
                raise RuntimeError("no worker accepted its base range")

    def msm(self, scalars):
        """Distributed MSM with elastic recovery: scatter scalar ranges,
        fold partial G1 sums on the host (reference dispatcher2.rs:888-890
        — where every worker failure is an unwrap panic, src/worker.rs:303;
        here a dead worker's range is re-provisioned onto a healthy worker
        and recomputed)."""
        assert self._ranges is not None, "init_bases first"
        self._maybe_readmit()

        # the fan-out runs on executor threads that cannot see this
        # thread's span stack, so the fleet span's sid is threaded down
        # explicitly — rpc spans stay children of fleet/msm in the tree
        with self._span("fleet/msm") as fleet_sid:
            return self._msm_inner(scalars, fleet_sid)

    def _msm_inner(self, scalars, fleet_sid=None):
        def part(i):
            start, end = self._ranges[i]
            chunk = scalars[start:end]
            if not chunk:
                return None
            # a range whose provisioning push failed must NOT be served
            # by its nominal owner: an alive worker can hold a stale
            # same-id set from an earlier init_bases and would answer
            # with the wrong partial — force the adoption path, which
            # re-pushes the bases before computing
            if i in self._unprovisioned and i not in self._adopted:
                raise ConnectionError(f"range {i} never provisioned")
            # an adopted range routes straight to its new owner — no
            # re-dialing the dead worker, no re-upload
            server = self._adopted.get(i, i)
            raw = self.workers[server].call(
                protocol.MSM, protocol.encode_msm_request(i, chunk),
                parent=fleet_sid)
            return protocol.decode_point(raw), server

        # per-range (partial point, serving worker) — kept apart until
        # the integrity pass has inspected EVERY partial (primary AND
        # recovery-path adopted — a partial over stale bases must be
        # caught on the recovery path too), only then folded
        results = [None] * len(self._ranges)
        failed = []  # ranges whose server's connection was lost
        for i, res in enumerate(self.pool.map(
                lambda i: _try(part, i), range(len(self._ranges)))):
            if isinstance(res, _Failure):
                if not isinstance(res.err, _LOST):
                    raise res.err  # an ERR reply: never adopted away
                failed.append(i)
            else:
                results[i] = res
        if failed:
            # recoveries run concurrently; _recover_msm spreads adoptions
            # across the fleet starting at dead_i + 1
            for i, rec in zip(failed, self.pool.map(
                    lambda i: self._recover_msm(i, scalars, fleet_sid),
                    failed)):
                results[i] = rec
        results = list(self.pool.map(
            lambda ir: self._msm_check_range(ir[0], ir[1], scalars,
                                             fleet_sid),
            enumerate(results)))
        total = None
        for rec in results:
            if rec is not None:
                total = C.g1_add_affine(total, rec[0])
        return total

    def _msm_check_range(self, i, rec, scalars, fleet_sid=None):
        """Integrity pass for one served MSM partial: group-law sanity
        (on-curve + subgroup) always, duplicate execution at the sampled
        rate (FleetIntegrity.msm_dup_rate). A worker caught serving a wrong
        partial is quarantined and the range recomputed on a healthy
        adopter (whose result is sanity-checked in turn). Returns the
        (partial, server) record to fold — possibly replaced."""
        if rec is None:
            return None
        integ = self.integrity
        point, server = rec
        integ.metrics.inc("integrity_checks")
        if not g1_sane(point):
            # a flipped coordinate limb: not even on the curve (or not
            # in the order-r subgroup) — attribution is immediate
            integ.metrics.inc("integrity_failures")
            self.quarantine(server, f"msm range {i}: partial fails the "
                                    "group-law sanity check")
            return self._msm_requarantine_recompute(i, scalars, fleet_sid)
        if not integ.sample_msm_dup():
            return rec
        integ.metrics.inc("integrity_msm_dups")
        verdict = self._msm_dup_check(i, point, server, scalars, fleet_sid)
        if verdict is None:
            return rec  # agreed (or no second worker to ask)
        liar, good = verdict
        integ.metrics.inc("integrity_failures")
        self.quarantine(liar, f"msm range {i}: duplicate execution "
                              "mismatch")
        if liar != server:
            return rec  # the verifier lied; the served partial stands
        if good is not None:
            return good
        return self._msm_requarantine_recompute(i, scalars, fleet_sid)

    def _msm_requarantine_recompute(self, i, scalars, fleet_sid):
        """Recompute range i after its server was quarantined: the
        normal adoption path (fresh bases pushed to a healthy worker),
        with the new partial re-checked — group-law sanity AND one
        duplicate execution (the adopter may be lying too: an unchecked
        recompute would be the one path a wrong partial could ride into
        the fold). A second failure means the fleet
        cannot serve trustworthy data for this range — loud
        IntegrityError, never a silent wrong fold."""
        rec = self._recover_msm(i, scalars, fleet_sid)
        if rec is None:
            return None
        if not g1_sane(rec[0]):
            self.integrity.metrics.inc("integrity_failures")
            self.quarantine(rec[1], f"msm range {i}: recomputed partial "
                                    "fails the group-law sanity check")
            raise IntegrityError(
                f"msm range {i}: no trustworthy partial", (rec[1],))
        verdict = self._msm_dup_check(i, rec[0], rec[1], scalars, fleet_sid)
        if verdict is not None:
            liar, good = verdict
            self.integrity.metrics.inc("integrity_failures")
            self.quarantine(liar, f"msm range {i}: recomputed partial "
                                  "duplicate mismatch")
            if liar != rec[1]:
                return rec
            if good is not None:
                return good
            raise IntegrityError(
                f"msm range {i}: no trustworthy partial", (liar,))
        return rec

    def _msm_dup_check(self, i, point, server, scalars, fleet_sid=None):
        """Duplicate-execute range i on a second worker with FRESHLY
        pushed bases and compare. None = partials agree (or nobody to
        ask). On a mismatch, a third worker votes (host oracle referees
        small ranges when the fleet is only 2 wide): returns
        (liar_index, (good_point, good_server) | None)."""
        start, end = self._ranges[i]
        chunk = scalars[start:end]

        def compute_on(j):
            w = self.workers[j]
            w.call(protocol.INIT_BASES,
                   protocol.encode_init_bases(i, self._bases[start:end]),
                   parent=fleet_sid)
            raw = w.call(protocol.MSM,
                         protocol.encode_msm_request(i, chunk),
                         parent=fleet_sid)
            return protocol.decode_point(raw)

        k = len(self.workers)
        candidates = [j for j in ((server + off) % k
                                  for off in range(1, k))
                      if j != server and self.tracker.usable(j)]
        verifier = dup = None
        for j in candidates:
            try:
                dup = compute_on(j)
                verifier = j
                break
            except _LOST:
                continue
        if verifier is None:
            return None  # nobody to cross-check against: unsampled
        if dup == point:
            return None
        # disagreement: one of the two is lying — get a third opinion
        for j in candidates:
            if j == verifier:
                continue
            try:
                ref = compute_on(j)
            except _LOST:
                continue
            if ref == dup:
                return server, (dup, verifier)
            if ref == point:
                return verifier, None
            break  # three-way disagreement: fall through to conservative
        if len(chunk) <= REFEREE_MAX:
            ref = C.g1_msm(self._bases[start:end][:len(chunk)], chunk)
            if ref == dup:
                return server, (dup, verifier)
            if ref == point:
                return verifier, None
        # unattributable beyond doubt: the worker SERVING the data is
        # the one whose wrong answer would poison the proof — quarantine
        # it and recompute (conservative: an innocent server stays out
        # for the rest of this dispatcher's life)
        return server, None

    def _recover_msm(self, dead_i, scalars, fleet_sid=None):
        """Re-provision range dead_i's bases onto a healthy worker (set id
        unchanged — ids are ranges, not workers), recompute its part, and
        REMEMBER the adoption so later msm() calls route directly. Workers
        with an open breaker are skipped up front (no timeout burned);
        only if NO usable worker can adopt are the breaker-open ones
        probed directly and re-admitted on an answer — same last-resort
        rule as ntt(): a recovered fleet whose breakers are all still
        open must serve the call, not abort the prove.

        Returns (partial point, adopting worker) — the adopter rides
        along so the integrity pass can attribute/quarantine adopted
        ranges exactly like primary ones."""
        start, end = self._ranges[dead_i]
        chunk = scalars[start:end]
        if not chunk:
            return None
        k = len(self.workers)
        failed_owner = self._adopted.get(dead_i, dead_i)
        # an UNPROVISIONED range's owner never actually failed a call —
        # msm() pre-empted it because its bases may be stale. adopt()
        # re-pushes fresh bases first, so the owner is a legitimate
        # candidate (excluding it could fail a prove with a healthy
        # worker available, e.g. k=2 with the other worker dead)
        if dead_i in self._unprovisioned and dead_i not in self._adopted:
            failed_owner = None
        last_err = None

        def adopt(j):
            w = self.workers[j]
            w.call(protocol.INIT_BASES, protocol.encode_init_bases(
                dead_i, self._bases[start:end]), parent=fleet_sid)
            raw = w.call(protocol.MSM,
                         protocol.encode_msm_request(dead_i, chunk),
                         parent=fleet_sid)
            self._adopted[dead_i] = j
            self._unprovisioned.discard(dead_i)  # freshly pushed to j
            self.metrics.inc("fleet_range_adoptions")
            self._log("range_adopted", level="warn", range=dead_i,
                      worker=j)
            return protocol.decode_point(raw), j

        rotation = [(dead_i + off) % k for off in range(1, k + 1)]
        for j in rotation:
            if j == failed_owner or not self.tracker.usable(j):
                continue
            try:
                return adopt(j)
            except _LOST as e:  # try the next healthy worker
                last_err = e
        for j in self._probe_readmit(
                j for j in rotation
                if j != failed_owner and not self.tracker.usable(j)):
            try:
                return adopt(j)
            except _LOST as e:
                last_err = e
        raise RuntimeError(
            f"no healthy worker could adopt MSM range {dead_i}") from last_err

    def _probe_readmit(self, candidates):
        """Last-resort plane shared by ntt() and _recover_msm(): probe
        each breaker-open candidate directly and yield the ones that
        answer (re-admitted) so the caller can route to them — a
        recovered fleet whose breakers are all still open must serve the
        call, not fast-fail it (call() alone would raise
        WorkerUnavailable without dialing)."""
        for i in candidates:
            if self._left(i) or self.tracker.is_suspect(i):
                continue  # decommissioned/quarantined: a JOIN (plus, for
                # suspects, a passed challenge) is the only way back
            if self.workers[i].probe() is None:
                continue  # actually dead: leave the breaker open
            self.tracker.record_ok(i)  # alive: re-admit, then route to it
            yield i

    # -- result-integrity quarantine ------------------------------------------

    def quarantine(self, i, reason):
        """The integrity plane attributed a WRONG answer to worker i:
        mark it SUSPECT (sticky breaker — probes do NOT re-admit it, its
        process is alive and answering; its answers are wrong), and LEAVE
        it through the membership registry so a supervisor replaces the
        process. The caller recomputes on the others. The verdict is kept
        in `quarantined` (worker -> reason); re-admission is only through
        a fresh JOIN that passes the known-answer challenge
        (run_challenge)."""
        flipped = self.tracker.mark_suspect(i)
        self.quarantined[i] = reason
        self.workers[i].drop_conn()
        self._log("quarantine", level="warn", worker=i, reason=reason)
        if self.membership is not None and flipped:
            try:
                self.membership.leave(index=i, reason="integrity")
            except LookupError:  # a concurrent leave got there first
                pass
        return flipped

    def run_challenge(self, host, port, timeout_s=15.0):
        """Known-answer gate for re-admitting a worker the integrity plane
        quarantined: a fresh random 64-point NTT and a fresh 8-base MSM on
        the reserved CHALLENGE_SET_ID, both compared against the host
        oracle (poly, curve). Values are drawn per call so a lying worker
        cannot replay cached answers. Retries the connection while a
        just-respawned worker binds; an ERR reply fails the challenge."""
        rng = random.Random()
        xs = [rng.randrange(R_MOD) for _ in range(64)]
        want_ntt = P.fft(P.Domain(64), xs)
        bases = [C.g1_mul(C.G1_GEN, k + 2) for k in range(8)]
        sc = [rng.randrange(R_MOD) for _ in range(8)]
        want_msm = C.g1_msm(bases, sc)
        self.metrics.inc("integrity_challenges")
        h = WorkerHandle(host, port, metrics=self.metrics)
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                try:
                    got_ntt = protocol.decode_scalars(h.call(
                        protocol.NTT,
                        protocol.encode_ntt_request(xs, False, False),
                        traced=False))
                    h.call(protocol.INIT_BASES,
                           protocol.encode_init_bases(CHALLENGE_SET_ID,
                                                      bases), traced=False)
                    got_msm = protocol.decode_point(h.call(
                        protocol.MSM,
                        protocol.encode_msm_request(CHALLENGE_SET_ID, sc),
                        traced=False))
                    break
                except _LOST:
                    if time.monotonic() >= deadline:
                        self.metrics.inc("integrity_challenges_failed")
                        return False
                    h.drop_conn()
                    time.sleep(0.2)
                except WorkerError:
                    self.metrics.inc("integrity_challenges_failed")
                    return False
        finally:
            h.close()
        ok = got_ntt == want_ntt and got_msm == want_msm
        if not ok:
            self.metrics.inc("integrity_challenges_failed")
        olog.emit("integrity", "challenge", level="info" if ok else "warn",
                  host=host, port=port, ok=ok)
        return ok

    # -- NTT ------------------------------------------------------------------

    def ntt(self, values, inverse=False, coset=False, worker=0):
        """Offload one whole NTT to a worker (per-polynomial task
        parallelism, reference §2.3.3). NTTs are stateless, so a worker
        whose connection is lost, or whose answer fails the integrity
        check (it is quarantined), is routed around, each time counted in
        fleet_ntt_reroutes: usable workers are tried first (rotation
        order); if every one of them fails, breaker-open workers are
        PROBED directly and re-admitted on an answer — a recovered fleet
        whose breakers are all still open must serve the call, not
        fast-fail it. An ERR reply raises."""
        k = len(self.workers)
        payload = protocol.encode_ntt_request(values, inverse, coset)
        self._maybe_readmit()
        rotation = [(worker + off) % k for off in range(k)]
        last_err = None

        def served_by(i):
            """One attempt on worker i, integrity-checked: a wrong (but
            well-formed) result quarantines the server and raises so the
            rotation tries the next worker — attribution is trivial
            here, exactly one worker computed the answer."""
            raw = self.workers[i].call(protocol.NTT, payload)
            out = protocol.decode_scalars(raw)
            t = self.integrity.draw_point()
            if not self.integrity.check_transform(values, out, t, inverse,
                                                  coset):
                self.quarantine(i, "ntt result fails the Schwartz-Zippel "
                                   "check")
                raise IntegrityError(f"worker {i} served a wrong NTT", (i,))
            return out

        with self._span("fleet/ntt"):
            for i in [i for i in rotation if self.tracker.usable(i)]:
                try:
                    return served_by(i)
                except (*_LOST, IntegrityError) as e:
                    last_err = e
                    self.metrics.inc("fleet_ntt_reroutes")
            for i in self._probe_readmit(
                    i for i in rotation if not self.tracker.usable(i)):
                try:
                    return served_by(i)
                except (*_LOST, IntegrityError) as e:
                    last_err = e
                    self.metrics.inc("fleet_ntt_reroutes")
        raise RuntimeError("no worker could serve the NTT") from last_err

    def ntt_many(self, jobs):
        """Round-robin a batch of NTT jobs [(values, inverse, coset), ...]
        across the fleet concurrently (the join_all pattern,
        reference dispatcher2.rs:294-321)."""
        return list(self.pool.map(
            lambda ij: self.ntt(ij[1][0], ij[1][1], ij[1][2], worker=ij[0]),
            enumerate(jobs)))

    # -- distributed evaluation (round 4) -------------------------------------

    def eval_many(self, pairs):
        """[(coeffs, point)] -> evaluations, each polynomial's Horner
        sum range-sharded across the usable workers (worker j returns
        sum_i chunk[i] * point^i; the host scales by point^start and
        folds). Exact field math — byte-identical to a host evaluation.
        ALL pairs' chunks ride ONE executor fan-out (round 4 submits 10
        polys at once; sequencing them would serialize 10 scatter/gather
        barriers onto the hot path). A chunk whose worker's connection is
        lost goes to the next usable worker (fleet_eval_reroutes); an ERR
        reply raises. Integrity: chunks are duplicate-executed at the
        sampled rate and a mismatch is refereed by the host (a chunk
        evaluation is O(n/k) host muls), so attribution is exact."""
        usable = self.tracker.usable_set()
        if not usable:
            raise RuntimeError("no usable worker for the evaluations")
        k = len(usable)
        plans = []   # (coeffs, point, chunk bounds)
        for coeffs, point in pairs:
            coeffs = [int(v) % R_MOD for v in coeffs]
            n = len(coeffs)
            plans.append((coeffs, int(point) % R_MOD,
                          [n * j // k for j in range(k + 1)]))
        flat = [(pi, j) for pi in range(len(plans)) for j in range(k)]
        out = [0] * len(pairs)
        with self._span("fleet/eval") as sid:
            def one(arg):
                pi, j = arg
                coeffs, point, bounds = plans[pi]
                lo, hi = bounds[j], bounds[j + 1]
                if hi <= lo:
                    return 0
                chunk = coeffs[lo:hi]
                server, val = self._eval_served(j, usable, chunk, point, sid)
                val = self._eval_integrity(server, chunk, point, val,
                                           usable, sid)
                return val * pow(point, lo, R_MOD) % R_MOD

            for (pi, _j), part in zip(flat, self.pool.map(one, flat)):
                out[pi] = (out[pi] + part) % R_MOD
        return out

    def eval_poly(self, coeffs, point):
        return self.eval_many([(coeffs, point)])[0]

    def _eval_chunk(self, i, chunk, point, sid=None):
        raw = self.workers[i].call(
            protocol.EVAL, protocol.encode_eval_request(point, chunk),
            parent=sid)
        return protocol.decode_scalar(raw) % R_MOD

    def _eval_served(self, j, usable, chunk, point, sid=None):
        """(server, value) of chunk j: on usable[j], or on the next usable
        worker when that one's connection is lost (each move counted in
        fleet_eval_reroutes). An ERR reply raises."""
        last_err = None
        for off in range(len(usable)):
            server = usable[(j + off) % len(usable)]
            try:
                return server, self._eval_chunk(server, chunk, point, sid)
            except _LOST as e:
                last_err = e
                self.metrics.inc("fleet_eval_reroutes")
        raise RuntimeError("no worker could serve the evaluation chunk") \
            from last_err

    def _eval_integrity(self, server, chunk, point, val, usable, sid=None):
        """Duplicate-execution sampling for one evaluation chunk. On a
        mismatch the host referee (exact, cheap) names the liar; the
        refereed value is what gets served either way."""
        integ = self.integrity
        integ.metrics.inc("integrity_checks")
        if len(usable) < 2 or not integ.sample_msm_dup():
            return val
        integ.metrics.inc("integrity_eval_dups")
        verifier = usable[(usable.index(server) + 1) % len(usable)]
        try:
            dup = self._eval_chunk(verifier, chunk, point, sid)
        except _LOST:
            return val  # nobody answered the cross-check: unsampled
        if dup == val:
            return val
        integ.metrics.inc("integrity_failures")
        ref = power_sum(chunk, point)
        liar = server if ref != val else verifier
        self.quarantine(liar, "eval chunk duplicate execution mismatch")
        return ref

    # -- sharded 4-step FFT ---------------------------------------------------

    def fft_dist(self, values, inverse=False, coset=False):
        """ONE cross-worker sharded 4-step (i)(coset)FFT — the reference's
        hot protocol (Prover::fft, dispatcher2.rs:731-787): stage-1 rows
        scattered block-wise, direct worker<->worker all-to-all, stage-2
        columns gathered. len(values) must be a power of two.

        Failure recovery: a worker dying at ANY phase (FFT_INIT / FFT1 /
        the EXCHANGE all-to-all / FFT2_PREPARE / FFT2) fails the attempt;
        the fleet is probed to find who actually died (a healthy worker
        reports a dead PEER's loss as its own error), the dead workers'
        panel rows and column ranges are re-provisioned onto the healthy
        subset, and the protocol re-runs under a fresh task id — the FFT
        mirror of `_recover_msm`, leaning on the worker handlers being
        idempotent and tasks being GC'd by TTL/cap. When the healthy set
        shrinks below FFT_QUORUM the call degrades gracefully to the
        whole-poly single-worker NTT path (which itself routes around
        dead workers). Byte-identical output either way — the kernels are
        deterministic and the math doesn't care where it runs."""
        n = len(values)
        assert n >= 4 and n & (n - 1) == 0, n
        k = len(self.workers)
        self._maybe_readmit()
        last_err = None
        same_set_retry = False
        with self._span("fleet/fft_dist") as fft_sid:
            for _attempt in range(k + 1):
                active = self.tracker.usable_set()
                if len(active) < max(self.FFT_QUORUM, 1):
                    if len(active) < k:
                        # a fault shrank the fleet below quorum; a
                        # CONFIGURED sub-quorum fleet (k=1) taking this
                        # path is healthy and must not read as continuous
                        # degradation
                        self.metrics.inc("fleet_fft_degraded")
                        self._log("fft_degraded", level="warn", n=n,
                                  active=len(active), width=k)
                    return self.ntt(values, inverse, coset)
                try:
                    return self._fft_dist_attempt(values, inverse, coset,
                                                  active, fft_sid)
                except (FleetError, ConnectionError, OSError,
                        RuntimeError) as e:
                    last_err = e
                    # attribute the loss: probe everyone, open breakers on
                    # the actually-dead, then replan on the survivors
                    self._probe_fleet()
                    if self.membership is not None:
                        # the failure may be roster lag, not death: a
                        # worker that missed a push rejects plans whose
                        # epoch mismatches its table. Re-push and WAIT
                        # (bounded) so the next attempt, which re-reads
                        # self.epoch, runs against a converged fleet
                        for f in self.membership.push_roster():
                            try:
                                f.result(timeout=5)
                            except Exception:
                                pass
                    if self.tracker.usable_set() == active:
                        # nobody actually died: a transient (dropped/
                        # corrupt frame, one slow call) gets ONE same-set
                        # retry; a second failure on the unchanged set is
                        # a deterministic error — surface it instead of
                        # burning k+1 identical multi-second attempts
                        if same_set_retry:
                            raise
                        same_set_retry = True
                    else:
                        same_set_retry = False
                    self.metrics.inc("fleet_fft_replans")
                    self._log("fft_replan", level="warn", n=n,
                              error=repr(last_err)[:200])
        raise RuntimeError(
            f"sharded FFT failed after {k + 1} replans") from last_err

    def _fft_dist_attempt(self, values, inverse, coset, active,
                          fft_sid=None):
        """One protocol run over the `active` worker subset. Dead workers
        keep zero-width row/column ranges, so the full-length col_ranges
        table still indexes by fleet position (peer routing is by config
        index) while all data lands on the healthy subset. The phase
        fan-outs run on executor threads, so rpc spans link to the
        fleet/fft_dist span through the explicit `fft_sid`."""
        n = len(values)
        r, c = _split_rc(n)
        k = len(self.workers)
        a = len(active)
        task_id = random.getrandbits(63)
        arow = [c * j // a for j in range(a + 1)]
        acol = [r * j // a for j in range(a + 1)]
        row_bounds = {i: (arow[j], arow[j + 1]) for j, i in enumerate(active)}
        col_ranges = [(0, 0)] * k
        for j, i in enumerate(active):
            col_ranges[i] = (acol[j], acol[j + 1])

        # (16, c, r): axis 1 = row index j2 (stride c in the flat poly)
        vm = protocol.ints_to_matrix(values).reshape(16, r, c)
        rows_mat = vm.transpose(0, 2, 1)  # [16, j2, position-in-row]

        def run_phase(fn, targets):
            failures = [res for res in self.pool.map(lambda i: _try(fn, i),
                                                     targets)
                        if isinstance(res, _Failure)]
            if failures:
                raise FleetError(
                    f"fft phase lost {len(failures)} worker(s)") \
                    from failures[0].err

        # the frame carries the membership epoch this plan was made
        # against: a worker whose roster moved on (a join or leave landed
        # mid-attempt) rejects it loudly and the outer loop replans at the
        # CURRENT width, which is how the fleet replans up at the next
        # phase boundary; integrity announces the FFT2 partials
        epoch = self.epoch
        run_phase(
            lambda i: self.workers[i].call(
                protocol.FFT_INIT, protocol.encode_fft_init(
                    task_id, inverse, coset, n, r, c,
                    row_bounds[i][0], row_bounds[i][1], col_ranges,
                    epoch=epoch, integrity=True),
                parent=fft_sid),
            active)

        def scatter(i):
            rs, re = row_bounds[i]
            if re == rs:
                return
            panel = np.ascontiguousarray(rows_mat[:, rs:re, :])
            self.workers[i].call(
                protocol.FFT1, protocol.encode_fft1_matrix(task_id, rs, panel),
                parent=fft_sid)

        run_phase(scatter, active)

        # trigger the all-to-all; each worker's OK implies its slices landed
        run_phase(
            lambda i: self.workers[i].call(
                protocol.FFT2_PREPARE, struct.pack("<Q", task_id),
                parent=fft_sid),
            active)

        # integrity: a random Fr check point rides every FFT2 fetch; the
        # workers piggyback (input-side, output-side) partial power sums
        # at that point on their replies (attribution evidence), and the
        # GATHERED output — the data actually served — must satisfy the
        # closed-form Schwartz-Zippel identity against the input
        check_t = self.integrity.draw_point()
        claimed = {}

        def gather(i):
            cs, ce = col_ranges[i]
            if ce == cs:
                return i, None
            raw = self.workers[i].call(
                protocol.FFT2,
                protocol.encode_fft2_request(task_id, check_t),
                parent=fft_sid)
            partials, panel = protocol.split_fft2_reply(raw)
            if partials is not None:
                claimed[i] = partials  # distinct keys: no lock needed
            flat = protocol.decode_scalar_matrix(panel)
            return i, flat

        out = np.empty((16, r, c), dtype=np.uint32)  # [16, k1, k2]
        failures = []
        for res in self.pool.map(lambda i: _try(gather, i), active):
            if isinstance(res, _Failure):
                failures.append(res)
                continue
            i, flat = res
            if flat is None:
                continue
            cs, ce = col_ranges[i]
            out[:, cs:ce, :] = flat.reshape(16, ce - cs, c)
        if failures:
            raise FleetError(
                f"fft gather lost {len(failures)} worker(s)") \
                from failures[0].err
        # result index is k1 + r*k2 -> transpose to [k2, k1] before flatten
        result = protocol.matrix_to_ints(
            np.ascontiguousarray(out.transpose(0, 2, 1)).reshape(16, n))
        if not self.integrity.check_transform(values, result, check_t,
                                              inverse, coset):
            # detection is O(n); attribution (per-panel bisection against
            # the closed-form panel expectation, plus the workers' own
            # claimed partial pairs) runs only now, on the failed check
            suspects = self.integrity.attribute_fft(
                values, result, check_t, col_ranges, r, c, inverse, coset,
                claimed=claimed, row_bounds=row_bounds)
            for s in suspects:
                self.quarantine(s, "fft panel fails the Schwartz-Zippel "
                                   "check")
            raise IntegrityError(
                f"sharded fft integrity check failed "
                f"(suspect workers {suspects})", suspects)
        return result

    # -- tracing --------------------------------------------------------------

    def _span(self, name):
        if self.tracer is None:
            return nullcontext()
        return self.tracer.span(name)

    def estimate_offsets(self):
        """Per-worker wall-clock offset estimates (seconds each worker's
        clock runs AHEAD of ours), from the HEALTH probe round trip:
        offset = worker_now - (t_send + t_recv)/2. Error is bounded by
        half the round trip — microseconds on a LAN, far below the span
        durations being aligned. Unreachable workers estimate 0.0."""
        offsets = [0.0] * len(self.workers)
        for i, w in enumerate(self.workers):
            t0 = time.time()
            snap = w.probe()
            t1 = time.time()
            if snap is not None and isinstance(snap.get("now"), (int, float)):
                offsets[i] = snap["now"] - (t0 + t1) / 2.0
        return offsets

    def collect_trace(self, logs=True):
        """Stitch the distributed timeline for this dispatcher's trace:
        our own spans + every worker's TRACE_DUMP for the trace id,
        timestamps corrected by the per-worker clock-offset estimate.
        Returns the merged dump (trace.merge_traces shape: store it as a
        `trace:<job_id>` artifact via store.keycache.store_trace, or
        export it with trace.to_chrome_trace); None when no tracer is
        armed. Worker dumps are fetch-and-forget: collect once, at prove
        end.

        With logs=True the merged dump also carries a `logs` list: the
        structured log events (obs/log.py) of THIS process's ring and of
        every worker's LOG_FETCH, either tagged with the trace id or, for
        subsystems that cannot know it (a supervisor respawn), untagged
        and inside the prove's time window; those are stamped with the
        trace id as they are attributed to it.

        No fallback hides a worker: one whose connection is lost (a
        killed worker, an open breaker) adds no spans and no logs, and
        its index lands in `lost_workers` (counter trace_workers_lost);
        one that answers ERR raises WorkerError."""
        if self.tracer is None:
            return None
        dumps = [self.tracer.dump()]
        offsets = [0.0]
        est = self.estimate_offsets()
        req = protocol.encode_json({"trace_id": self.tracer.trace_id})
        log_sets = []  # (events, offset)
        lost = []
        for i, w in enumerate(self.workers):
            try:
                d = protocol.decode_json(
                    w.call(protocol.TRACE_DUMP, req, traced=False))
                lf = protocol.decode_json(w.call(
                    protocol.LOG_FETCH, protocol.encode_json({}),
                    traced=False)) if logs else {}
            except (ConnectionError, OSError):
                lost.append(i)
                self.metrics.inc("trace_workers_lost")
                continue
            if d.get("events"):
                dumps.append(d)
                offsets.append(est[i])
            if logs:
                log_sets.append((lf.get("events") or [], est[i]))
        merged = merge_traces(dumps, offsets=offsets)
        merged["lost_workers"] = lost
        if logs:
            log_sets.append((olog.fetch()["events"], 0.0))
            merged["logs"] = self._trace_logs(merged, log_sets)
        return merged

    def _trace_logs(self, merged, log_sets):
        """Select and offset-correct the log events of one merged
        timeline: events carrying the trace id always; untagged events
        whose corrected timestamp lies inside the span window (padded by
        2 s) too, stamped with the id, since merging is the attribution.
        log_sets: [(events, offset_s)]."""
        tid = merged.get("trace_id")
        events = merged.get("events") or []
        lo = min((e["ts"] for e in events), default=0.0) - 2
        hi = max((e["ts"] + e.get("dur_s", 0.0) for e in events),
                 default=0.0) + 2
        out = []
        for evs, off in log_sets:
            for e in evs:
                e = dict(e)
                e["ts"] = round(float(e.get("ts", 0.0)) - off, 6)
                if e.get("trace_id") == tid:
                    out.append(e)
                elif "trace_id" not in e and lo <= e["ts"] <= hi:
                    e["trace_id"] = tid
                    out.append(e)
        out.sort(key=lambda e: e["ts"])
        return out

    # -- fleet observability (obs/fleet.py consumes these) --------------------

    def fleet_metrics(self):
        """One METRICS_FETCH scrape over the current roster — see
        obs.fleet.scrape for the entry shape (breaker/suspect-aware;
        old workers degrade to snapshot=None)."""
        from ..obs import fleet as obs_fleet
        return obs_fleet.scrape(self)

    def fetch_logs(self, worker=None, trace_id=None, since_seq=0):
        """[{worker, events, seq}] from each (or one) worker's LOG_FETCH
        ring. A worker that predates the tag, or is dead, contributes an
        empty list — never an error."""
        req = protocol.encode_json(
            {k: v for k, v in (("trace_id", trace_id),
                               ("since_seq", since_seq)) if v})
        targets = (enumerate(self.workers) if worker is None
                   else [(worker, self.workers[worker])])
        out = []
        for i, w in targets:
            entry = {"worker": i, "events": [], "seq": 0}
            try:
                lf = protocol.decode_json(
                    w.call(protocol.LOG_FETCH, req, traced=False))
                entry["events"] = lf.get("events") or []
                entry["seq"] = lf.get("seq", 0)
            except Exception:
                pass
            out.append(entry)
        return out

    def profile_worker(self, i, duration_ms=None, kind="auto"):
        """Arm one on-demand profile capture on worker i (PROFILE tag).
        Returns (meta, blob); raises on an unreachable worker, returns
        ({"format": "unsupported", ...}, b"") against one that predates
        the tag. With a tracer armed the capture lands as an obs/profile
        span on the timeline, linked to its profile:<id>.

        The capture rides a DEDICATED connection (fresh dial, closed
        after): the cached WorkerHandle stream serializes frames under
        its call lock, so a capture window there would stall every prove
        RPC to that worker. Worker-side, the capture blocks only this
        connection's thread."""
        t0 = time.time()
        w = self.workers[i]
        h = WorkerHandle(w.host, w.port, index=i, metrics=self.metrics)
        try:
            raw = h.call(
                protocol.PROFILE,
                protocol.encode_json(
                    {"duration_ms": duration_ms, "kind": kind}),
                traced=False)
        except RuntimeError as e:
            # ERR reply: a worker that predates the tag — degrade, the
            # caller still gets a well-formed (meta, blob) pair
            return {"format": "unsupported", "worker": i,
                    "error": str(e)[:200]}, b""
        finally:
            h.close()
        meta, blob = protocol.decode_result(raw)
        if self.tracer is not None:
            from ..obs import profiling as obs_profiling
            self.tracer.add_event(
                "obs/profile", time.time() - t0, ts=t0, worker=i,
                format=meta.get("format"),
                profile_id=obs_profiling.profile_id(blob)
                if blob else None)
        return meta, blob

    # -- misc -----------------------------------------------------------------

    def stats(self):
        """Per-worker served-request counters {tag: count} ({} for a
        worker that can't answer)."""
        def one(w):
            try:
                return json.loads(w.call(protocol.STATS).decode())
            except Exception:
                return {}
        return [one(w) for w in self.workers]

    def shutdown(self):
        if self._member_server is not None:
            self._member_server.close()
        for w in self.workers:
            try:
                w.call(protocol.SHUTDOWN)
            except Exception:
                pass
            w.close()


class RemoteBackend(PythonBackend):
    """Prover backend that routes every FFT/MSM through the worker fleet —
    the v2 fully-distributed prove path (reference dispatcher2.rs:192-713).
    The poly-handle protocol (round math) is inherited from the host
    oracle: like the reference's dispatcher, the sequential round logic
    stays local while the throughput kernels go to the fleet."""

    name = "remote"

    def __init__(self, dispatcher, dist_fft_min=None):
        """dist_fft_min: domain size at or above which a single NTT is run
        as the cross-worker sharded 4-step FFT (fft_dist) instead of being
        shipped whole to one worker; None = never (per-poly parallelism
        only). Round 4's evaluations are always range-sharded across the
        fleet (Dispatcher.eval_many)."""
        self.d = dispatcher
        self._inited = None
        self._rr = 0  # round-robin cursor for single NTTs
        self.dist_fft_min = dist_fft_min
        self._host_ck = None

    def _host_bases(self, ck):
        """The commit key as a host list of affine points (what INIT_BASES
        ships): a DeviceCommitKey (a key preprocessed from a DeviceSrs)
        is normalized once on its device."""
        if isinstance(ck, list):
            return ck
        if self._host_ck is None or self._host_ck[0] is not ck:
            self._host_ck = (ck, CT.affine_to_host(
                *CT.batch_to_affine(ck.point)))
        return self._host_ck[1]

    def _ensure_bases(self, bases):
        if self._inited is not bases:
            self.d.init_bases(self._host_bases(bases))
            self._inited = bases

    def fft(self, domain, values):
        return self._ntt(domain, values, False, False)

    def ifft(self, domain, values):
        return self._ntt(domain, values, True, False)

    def coset_fft(self, domain, values):
        return self._ntt(domain, values, False, True)

    def coset_ifft(self, domain, values):
        return self._ntt(domain, values, True, True)

    def _ntt(self, domain, values, inverse, coset):
        padded = list(values) + [0] * (domain.size - len(values))
        if self.dist_fft_min is not None and domain.size >= self.dist_fft_min:
            return self.d.fft_dist(padded, inverse, coset)
        self._rr += 1
        return self.d.ntt(padded, inverse, coset, worker=self._rr)

    def _many(self, domain, handles, inverse, coset):
        padded = [list(h) + [0] * (domain.size - len(h)) for h in handles]
        if self.dist_fft_min is not None and domain.size >= self.dist_fft_min:
            # each FFT is itself sharded across the whole fleet
            return [self.d.fft_dist(v, inverse, coset) for v in padded]
        return self.d.ntt_many([(v, inverse, coset) for v in padded])

    def ifft_many(self, domain, handles):
        """Concurrent multi-worker batch (join_all across the fleet,
        reference dispatcher2.rs:294-321)."""
        return self._many(domain, handles, True, False)

    def coset_fft_many(self, domain, handles):
        return self._many(domain, handles, False, True)

    def msm(self, bases, scalars):
        self._ensure_bases(bases)
        padded = list(scalars) + [0] * (len(bases) - len(scalars))
        return self.d.msm(padded)

    def commit(self, ck, coeffs):
        return self.msm(ck, coeffs)

    def eval_many_h(self, pairs):
        """Round-4 evaluations range-sharded across the fleet (exact
        field math — bytes identical to the host path), dup-checked by
        the integrity plane."""
        return self.d.eval_many(pairs)
