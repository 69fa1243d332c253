"""Prover worker pool: per-job timeout, bounded retry, checkpoint resume (a
copy of the JAX package's service/pool.py, its workers on TorchBackend).

Each worker is a thread that owns a backend instance (by default
`TorchBackend(device)`: every worker launches on the same card, on the
default stream) and proves one DISPATCH UNIT at a time: a single job,
or, from the placement layer, a GROUP (`dispatch_group`): N same-shape
jobs proved together through `prover.prove_many` (cross-job batched
kernel launches, byte-identical to sequential), or one job on an
override backend (a leased-submesh MeshBackend). A worker that dequeues
a single job also coalesces the single jobs queued behind it up to
PIPELINE_DEPTH and proves them through `prover.prove_pipelined`: members
advance through the five round stages staggered, so one member's device
launches overlap the others' host transcript/checkpoint work, still
byte-identical per job. Unlike the JAX package, a group is never folded
into a pipeline: it proves as one prove_many call, which on the card
outruns a pipeline of the same jobs (PERF.md, the batched drivers).
Every attempt runs with a `checkpoint.ProverCheckpoint` under the job's
id, so when a worker dies mid-prove the retry does NOT restart at round
1: it resumes at the last completed round with the identical
transcript/RNG state and produces the same bytes the uninterrupted run
would have. In a group, failure is member-scoped: a killed batch member
retries ALONE (resuming from its snapshot) while the survivors finish in
the original batch.

Failure semantics:
- worker kill (fault injection / crash analog): the worker thread dies and
  is REPLACED (new generation of the same slot); its in-flight job is
  requeued with retries+1 and resumes from its snapshot.
- generic prove error: bounded retry (`max_retries`), also resuming.
- per-job timeout: checked cooperatively at round boundaries (the
  checkpoint-save hook), because a Python thread cannot be preempted
  mid-kernel; a timed-out job fails and its snapshot is removed.

Fault injection (`kill_worker`) arms a flag the victim observes at its
next round boundary — after the round's snapshot is persisted, modeling a
crash between "state made durable" and "next round started".
"""

import os
import random
import tempfile
import threading
import time
import queue as _stdlib_queue

from ..checkpoint import ProverCheckpoint, StoreCheckpoint
from ..obs import log as olog
from ..prover import PIPELINE_DEPTH, prove, prove_many, prove_pipelined
from ..proof_io import serialize_proof
from ..trace import Tracer
from . import jobs as J
from . import journal as JN
from .metrics import backend_peak

# verify-before-serve mode when the caller gives none (the JAX package's
# DPT_SELF_VERIFY default)
SELF_VERIFY = "auto"


class WorkerKilled(Exception):
    pass


class JobTimeout(Exception):
    pass


class ProofRejected(Exception):
    """Verify-before-serve failed: the finished proof does not pairing-
    verify (silent data corruption somewhere between witness and
    serialization). The proof is BLOCKED — it never reaches a journal
    DONE record or a client; the checkpoint is cleared so the retry
    re-proves from scratch (resuming would replay the corrupt state)."""


class WorkerDrained(Exception):
    """Graceful drain hit its deadline: the worker stops at the next
    round boundary (snapshot already durable) and the job stays
    journaled as in-flight — the restarted service resumes it."""


class _GuardHooks:
    """Round-boundary control points the pool mixes into a checkpoint
    backend: kill flags and deadlines fire AFTER the round's snapshot is
    durable (so the subsequent retry has the maximum state to resume
    from), the fault injector's checkpoint plane (slow-prover delay,
    snapshot corruption) runs at the same boundary, the job journal's
    ROUND record is appended (snapshot first, THEN the journal's promise
    that it exists), and resumes/saves land in the metrics registry."""

    def _arm_guard(self, worker, metrics=None, faults=None, journal=None,
                   job_id=None):
        self.worker = worker
        self._metrics = metrics
        self._faults = faults
        self._journal = journal
        self._job_id = job_id
        return self

    def load(self, fingerprint):
        self.worker.check(round_no=0, job_id=self._job_id)
        state = super().load(fingerprint)
        if state is not None and self._metrics is not None:
            # a non-None load means this attempt RESUMES mid-prove
            # (cross-host or same-host) instead of restarting at round 1
            self._metrics.inc("checkpoint_resumes")
        return state

    def save(self, round_no, *args, **kwargs):
        super().save(round_no, *args, **kwargs)
        if self._metrics is not None:
            self._metrics.inc("checkpoint_saves")
        if self._journal is not None:
            # write-ahead contract: the snapshot IS durable at this point,
            # so a crash at (or any time after) this journal append finds
            # resume-from-round-N state in the store/ckpt file
            self._journal.append(JN.ROUND, self._job_id, round=round_no)
        if self._faults is not None:
            self._faults.on_round(round_no, checkpoint=self)
        # job_id rides along so a job-targeted kill in a BATCHED prove
        # fires on exactly its member's boundary (the other members'
        # guards pass through unharmed)
        self.worker.check(round_no=round_no, job_id=self._job_id)


class _GuardedCheckpoint(_GuardHooks, ProverCheckpoint):
    def __init__(self, path, worker, metrics=None, faults=None,
                 journal=None, job_id=None):
        super().__init__(path)
        self._arm_guard(worker, metrics, faults, journal, job_id)


class _GuardedStoreCheckpoint(_GuardHooks, StoreCheckpoint):
    """Store-backed variant: snapshots are content-addressed artifacts
    (SHA-verified, budget-shared, STORE_FETCHable by a replacement host)."""

    def __init__(self, store, name, worker, metrics=None, faults=None,
                 journal=None, job_id=None):
        super().__init__(store, name)
        self._arm_guard(worker, metrics, faults, journal, job_id)


class _Worker:
    """One pool slot's current thread. A killed slot respawns as a new
    generation (`w2g1` -> `w2g2`) — the slot is permanent, threads are not."""

    def __init__(self, index, generation, drain_stop=None):
        self.index = index
        self.generation = generation
        self.name = f"w{index}g{generation}"
        # None | {"at_round": int|None, "job_id": str|None}: a job_id-
        # scoped arm (set when the kill targeted a specific job inside a
        # BATCHED prove) fires only on that member's round boundaries
        self.kill_arm = None
        self.deadline = None
        self.busy_jobs = []        # jobs this slot is proving right now
        self.thread = None
        # pool-wide forced-drain flag: set once the drain deadline passes,
        # observed here at round boundaries (the snapshot just became
        # durable — the cheapest possible point to stop)
        self.drain_stop = drain_stop

    def check(self, round_no=None, job_id=None):
        arm = self.kill_arm
        if arm is not None and (arm["at_round"] is None
                                or arm["at_round"] == round_no) \
                and (arm.get("job_id") is None
                     or arm["job_id"] == job_id):
            self.kill_arm = None
            raise WorkerKilled(self.name)
        if self.drain_stop is not None and self.drain_stop.is_set():
            raise WorkerDrained(self.name)
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise JobTimeout(f"deadline exceeded on {self.name}")


_STOP = object()


class _Group:
    """One placement unit on the dispatch queue (see
    WorkerPool.dispatch_group): jobs + shared resources, an optional
    backend override (leased-submesh MeshBackend), and the lease-release
    callback that must run when the attempt ends."""

    __slots__ = ("jobs", "res", "backend", "lease", "release")

    def __init__(self, jobs, res, backend, lease, release):
        self.jobs = jobs
        self.res = res
        self.backend = backend
        self.lease = lease
        self.release = release


class WorkerPool:
    def __init__(self, metrics, prover_workers=2, max_retries=2,
                 job_timeout_s=None, ckpt_dir=None, backend_factory=None,
                 verify_on_complete=False, store=None, faults=None,
                 journal=None, requeue=None, self_verify=None,
                 device=None):
        self.metrics = metrics
        self.max_retries = max_retries
        self.job_timeout_s = job_timeout_s
        # verify-before-serve (self_verify): "1" verifies EVERY
        # finished proof with the host pairing verifier before the
        # journal DONE record / client-visible done; "0" never; "auto"
        # (default) verifies work that ran on a non-local compute plane
        # — mesh-placed sharded proves, or any prove on a remote fleet
        # backend — which is where silent data corruption lives. A failing proof is never
        # served: it is BLOCKED (proofs_blocked), the checkpoint
        # dropped, and the job re-proved; with a fleet backend the
        # integrity plane has meanwhile quarantined the suspect workers,
        # so the re-prove runs on the survivors.
        self.self_verify = (SELF_VERIFY if self_verify is None
                            else str(self_verify))
        # requeue: the admission JobQueue (set by ProofService) — a
        # retried MESH-placed job goes back through the scheduler for
        # RE-PLACEMENT (fresh lease + sharded backend) instead of
        # retrying on this worker's shared single-device backend, which
        # is exactly the memory/latency ceiling mesh placement avoids
        self._requeue = requeue
        # checkpoint surface: with a store, snapshots are content-addressed
        # store artifacts (one durability surface + one eviction policy,
        # and a replacement host can STORE_FETCH them); the ckpt-dir file
        # path remains the storeless fallback
        self.store = store
        self.faults = faults
        # journal: service job journal (service/journal.py) — the pool
        # appends START/ROUND/DONE/SHED/FAILED; None runs journal-free
        self.journal = journal
        self.ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="dpt-service-ck-")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        # every worker thread builds its own backend: TorchBackend on the
        # pool's device unless the caller injects a factory (the tests'
        # host oracle); a factory that raises (no card) kills the worker
        # thread, so ProofService resolves the device first
        self.device = device
        self.backend_factory = backend_factory or self._default_backend
        self.verify_on_complete = verify_on_complete
        # small buffer past the worker count: keeps workers fed while the
        # scheduler builds the next bucket, without hoarding the queue's
        # jobs where priorities can no longer reorder them
        self._dispatch_q = _stdlib_queue.Queue(maxsize=2 * prover_workers)
        self._lock = threading.Lock()
        self._workers = []
        self._stopping = False
        self._drain_stop = threading.Event()
        for i in range(prover_workers):
            self._workers.append(self._spawn(i, 1))

    def _default_backend(self):
        from ..backend.torch_backend import TorchBackend
        return TorchBackend(self.device)

    # -- lifecycle ------------------------------------------------------------

    def _spawn(self, index, generation):
        w = _Worker(index, generation, drain_stop=self._drain_stop)
        w.thread = threading.Thread(target=self._loop, args=(w,),
                                    name=f"pool-{w.name}", daemon=True)
        w.thread.start()
        self.metrics.inc("workers_spawned")
        return w

    def _respawn(self, dead):
        with self._lock:
            if self._stopping:
                return
            replacement = self._spawn(dead.index, dead.generation + 1)
            self._workers[dead.index] = replacement

    def shutdown(self):
        # _stopping is the respawn gate _respawn checks under the lock:
        # setting it inside the same lock closes the window where a
        # concurrently dying worker respawns after shutdown decided to
        # stop (LOCK02 finding of the lock-discipline lint)
        with self._lock:
            self._stopping = True
            workers = list(self._workers)
        for _ in workers:
            self._dispatch_q.put(_STOP)
        for w in workers:
            w.thread.join(timeout=10)

    def crash(self):
        """Crash simulation (ProofService.crash): workers stop at their
        next round boundary through the DRAIN path — which parks the job
        with no retry bookkeeping, no terminal journal records, and
        crucially no checkpoint clears (a real dead process can't delete
        the snapshots its successor resumes from)."""
        with self._lock:
            self._stopping = True
        self._drain_stop.set()

    def busy(self):
        """Names of workers currently holding at least one job."""
        with self._lock:
            pool = list(self._workers)
        return [w.name for w in pool if w.busy_jobs]

    def drain(self, deadline):
        """Graceful drain: let in-flight proves finish until `deadline`
        (monotonic), then force the stragglers to stop at their next
        round boundary — the snapshot is durable and the journal still
        shows them in-flight, so a restart resumes with zero recompute.
        Returns True iff everything finished without the forced stop."""
        clean = True
        while self.busy() and time.monotonic() < deadline:
            time.sleep(0.02)
        if self.busy():
            clean = False
            self._drain_stop.set()
            # round boundaries are the check points; wait for the busy
            # set to clear, bounded (a worker inside one long round can
            # exceed this — threads are daemons, the journal is already
            # consistent either way)
            stop_wait = time.monotonic() + 10
            while self.busy() and time.monotonic() < stop_wait:
                time.sleep(0.02)
        self.shutdown()
        return clean

    def workers(self):
        with self._lock:
            return list(self._workers)

    # -- dispatch -------------------------------------------------------------

    def dispatch(self, job, resources):
        """Hand a scheduled job to the pool (blocks for backpressure)."""
        self._dispatch_q.put((job, resources))

    def dispatch_group(self, jobs, resources, backend=None, lease=None,
                       release=None):
        """Hand one PLACEMENT UNIT to the pool (blocks for backpressure):
        N same-shape jobs proved together by one worker through
        prover.prove_many (the data-parallel small-job class), or a
        single job with a `backend` override (a sharded MeshBackend over
        a leased submesh). `release(lease)` runs when the group's attempt
        ends — success, member failure, or drain — so submesh devices
        always return to the leaser."""
        self._dispatch_q.put(_Group(list(jobs), resources, backend,
                                    lease, release))

    def kill_worker(self, worker=None, job_id=None, at_round=None):
        """Fault injection: arm a kill on a specific worker, on whichever
        worker is proving `job_id`, or on any busy (else any) worker.
        Returns the victim's name; raises LookupError if no match.

        A job-targeted kill is scoped to that JOB: on a worker running a
        batched prove only the targeted member dies (it resumes alone
        from its snapshot; the other members finish unaffected) — on a
        single-job worker the semantics are the historical thread kill."""
        with self._lock:
            pool = list(self._workers)
        victim = None
        arm_job = None
        if worker is not None:
            victim = next((w for w in pool if w.name == worker), None)
        elif job_id is not None:
            victim = next((w for w in pool
                           if any(j.id == job_id for j in w.busy_jobs)),
                          None)
            arm_job = job_id
        else:
            victim = next((w for w in pool if w.busy_jobs),
                          pool[0] if pool else None)
        if victim is None:
            raise LookupError("no such worker/job to kill")
        victim.kill_arm = {"at_round": at_round, "job_id": arm_job}
        self.metrics.inc("kill_requests")
        return victim.name

    # -- execution ------------------------------------------------------------

    def _ckpt_path(self, job):
        return os.path.join(self.ckpt_dir, f"{job.id}.ckpt.npz")

    def _make_guard(self, job, worker):
        if self.store is not None:
            return _GuardedStoreCheckpoint(self.store, job.id, worker,
                                           metrics=self.metrics,
                                           faults=self.faults,
                                           journal=self.journal,
                                           job_id=job.id)
        return _GuardedCheckpoint(self._ckpt_path(job), worker,
                                  metrics=self.metrics, faults=self.faults,
                                  journal=self.journal, job_id=job.id)

    def _clear_ckpt(self, job):
        if self.store is not None:
            StoreCheckpoint(self.store, job.id).clear()
            return
        try:
            os.remove(self._ckpt_path(job))
        except OSError:
            pass

    def shed(self, job, reason):
        """Terminal TTL/deadline verdict: journaled (clients can query it
        across a restart), counted, never proved. Shared by the scheduler
        (expired before key build) and the pool loop (expired in the
        dispatch buffer)."""
        self.metrics.inc("jobs_shed")
        self.metrics.inc("slo_sheds_%s" % getattr(job, "slo", "standard"))
        olog.emit("service", "shed", level="warn", job_id=job.id,
                  trace_id=job.trace_id, reason=reason,
                  slo=getattr(job, "slo", "standard"))
        if self.journal is not None:
            self.journal.append(JN.SHED, job.id, reason=reason)
        self._clear_ckpt(job)
        job.finish_shed(reason)

    def _loop(self, worker):
        backend = self.backend_factory()
        while True:
            item = self._dispatch_q.get()
            if item is _STOP:
                return
            if not self._run_item(worker, backend, item):
                return

    def _put_back(self, item):
        """Return an item to the dispatch queue without ever blocking a
        worker thread on its own queue (same hazard as _retry_or_fail:
        workers are the consumers)."""
        try:
            self._dispatch_q.put_nowait(item)
        except _stdlib_queue.Full:
            threading.Thread(target=self._dispatch_q.put, args=(item,),
                             daemon=True).start()

    def _coalesce(self, budget):
        """Opportunistically pop up to `budget` more single jobs off the
        dispatch queue, so mid-shape traffic fills the round pipeline
        instead of proving one job at depth 1 while its queue neighbors
        wait. _STOP and groups (a prove_many batch, a leased-submesh
        prove) are put back and end the scan: their routing is
        per-unit."""
        items = []
        while len(items) < budget:
            try:
                item = self._dispatch_q.get_nowait()
            except _stdlib_queue.Empty:
                break
            if item is _STOP or isinstance(item, _Group):
                self._put_back(item)
                break
            items.append(item)
        return items

    def _run_item(self, worker, backend, item):
        """Route one dequeued dispatch unit. Returns False when this
        worker thread must exit (killed slot or drain)."""
        if isinstance(item, _Group):
            # a batch through prove_many on this worker's backend, or a
            # leased-submesh sharded prove on its override backend: the
            # lease is per-unit, so groups never coalesce with queue
            # neighbors
            be = backend if item.backend is None else item.backend
            try:
                if len(item.jobs) == 1:
                    return self._run_one(worker, be, item.jobs[0], item.res)
                return self._run_group(worker, be, item.jobs, item.res)
            finally:
                if item.release is not None:
                    item.release(item.lease)
        items = [item] + self._coalesce(PIPELINE_DEPTH - 1)
        if len(items) > 1:
            return self._run_pipeline(worker, backend, items)
        return self._run_one(worker, backend, *item)

    def _run_one(self, worker, backend, job, res):
        """One single-job attempt on this worker thread. Returns False
        when the thread must exit (killed slot — already respawned — or
        drain)."""
        if job.expired():
            self.shed(job, "ttl expired before prove start")
            return True
        worker.busy_jobs = [job]
        if job.started_at is None:
            job.started_at = time.monotonic()
            self.metrics.observe("job_wait", job.wait_s)
        job.worker = worker.name
        job.state = J.RUNNING
        if self.journal is not None:
            self.journal.append(JN.START, job.id, worker=worker.name)
        try:
            self._run_attempt(worker, backend, job, res)
            job.attempts.append({"worker": worker.name, "outcome": "ok"})
            self.metrics.inc("jobs_completed")
            self.metrics.observe("job_run", job.run_s)
        except WorkerDrained:
            # deadline-forced drain: the round snapshot is durable and
            # the job's journal entry still reads in-flight — park it
            # (no requeue, no terminal record); the restarted service
            # resumes it from the checkpoint
            job.attempts.append({"worker": worker.name,
                                 "outcome": "drained"})
            job.state = J.QUEUED
            job.worker = None
            worker.busy_jobs = []
            self.metrics.inc("jobs_drain_parked")
            return False  # draining: this thread is done
        except WorkerKilled:
            job.attempts.append({"worker": worker.name,
                                 "outcome": "killed"})
            self.metrics.inc("workers_killed")
            worker.busy_jobs = []
            # replacement first: with a 1-worker pool the requeue below
            # can block on a full dispatch queue until someone consumes
            self._respawn(worker)
            self._retry_or_fail(job, res, "worker killed mid-prove")
            return False  # this thread is the "dead process"
        except JobTimeout:
            job.attempts.append({"worker": worker.name,
                                 "outcome": "timeout"})
            self.metrics.inc("jobs_timeout")
            self._fail(job, f"timeout after {self.job_timeout_s}s")
        except Exception as e:  # prove/verify error: bounded retry
            job.attempts.append({"worker": worker.name,
                                 "outcome": f"error: {e!r}"})
            self.metrics.inc("job_attempt_errors")
            self._retry_or_fail(job, res, f"prove failed: {e!r}")
        finally:
            worker.busy_jobs = []
            # a kill that armed too late to fire on its target (e.g.
            # during round 5, past the last boundary check) must not
            # leak onto the worker's next, unrelated job
            worker.kill_arm = None
        return True

    def _run_group(self, worker, backend, jobs, res):
        """One data-parallel batch attempt: N same-shape jobs proved
        together through prover.prove_many on this worker's backend,
        cross-job kernel launches batched, proof bytes byte-identical to
        N sequential attempts. Member failures are isolated: a killed /
        timed-out / erroring member is retried or failed ALONE (its
        snapshot is durable; the retry resumes it through the sequential
        path) while the surviving members complete in this very call.
        Returns False when the pool is draining (thread exits)."""
        live = []
        for job in jobs:
            if job.expired():
                self.shed(job, "ttl expired before prove start")
            else:
                live.append(job)
        if not live:
            return True
        worker.busy_jobs = list(live)
        for job in live:
            if job.started_at is None:
                job.started_at = time.monotonic()
                self.metrics.observe("job_wait", job.wait_s)
            job.worker = worker.name
            job.state = J.RUNNING
            if self.journal is not None:
                self.journal.append(JN.START, job.id, worker=worker.name)
        self.metrics.inc("batch_proves")
        self.metrics.inc("batch_jobs", len(live))
        self.metrics.observe("batch_jobs_per_launch", len(live))
        tracers = [self._job_tracer(worker, job) for job in live]
        ckts = [J.build_circuit(job.spec) for job in live]
        guards = [self._make_guard(job, worker) for job in live]
        rngs = [random.Random(job.spec.seed) for job in live]
        if self.job_timeout_s is not None:
            worker.deadline = (min(j.started_at for j in live)
                               + self.job_timeout_s)
        try:
            proofs, errors = prove_many(rngs, ckts, res.pk, backend,
                                        tracers=tracers, checkpoints=guards,
                                        abort_on=(WorkerDrained,))
        except WorkerDrained:
            # drain aborts the whole batch: every member parks in-flight
            # (snapshots durable, journal unchanged) — the restarted
            # service resumes or re-proves deterministically
            for job in live:
                job.attempts.append({"worker": worker.name,
                                     "outcome": "drained"})
                job.state = J.QUEUED
                job.worker = None
                self.metrics.inc("jobs_drain_parked")
            worker.busy_jobs = []
            return False
        except Exception as e:  # batch-wide infrastructure failure
            for job in live:
                job.attempts.append({"worker": worker.name,
                                     "outcome": f"error: {e!r}"})
                self.metrics.inc("job_attempt_errors")
                self._retry_or_fail(job, res, f"batch prove failed: {e!r}")
            worker.busy_jobs = []
            worker.kill_arm = None
            return True
        finally:
            worker.deadline = None
        for job, tracer, ckt, proof, err in zip(live, tracers, ckts,
                                                proofs, errors):
            if proof is not None:
                try:
                    self._finish_proved(job, res, ckt, proof, tracer,
                                        backend=backend)
                    job.attempts.append({"worker": worker.name,
                                         "outcome": "ok"})
                    self.metrics.inc("jobs_completed")
                    self.metrics.observe("job_run", job.run_s)
                except Exception as e:  # verify/journal failure
                    job.attempts.append({"worker": worker.name,
                                         "outcome": f"error: {e!r}"})
                    self.metrics.inc("job_attempt_errors")
                    self._retry_or_fail(job, res, f"prove failed: {e!r}")
            elif isinstance(err, WorkerKilled):
                # job-scoped kill: only this member died; it resumes
                # ALONE from its snapshot via the single-job retry path
                job.attempts.append({"worker": worker.name,
                                     "outcome": "killed"})
                self.metrics.inc("batch_member_kills")
                self._retry_or_fail(job, res,
                                    "batch member killed mid-prove")
            elif isinstance(err, JobTimeout):
                job.attempts.append({"worker": worker.name,
                                     "outcome": "timeout"})
                self.metrics.inc("jobs_timeout")
                self._fail(job, f"timeout after {self.job_timeout_s}s")
            else:
                job.attempts.append({"worker": worker.name,
                                     "outcome": f"error: {err!r}"})
                self.metrics.inc("job_attempt_errors")
                self._retry_or_fail(job, res, f"prove failed: {err!r}")
        worker.busy_jobs = []
        worker.kill_arm = None
        return True

    def _pipeline_observer(self):
        """Stage-level pipeline telemetry -> metrics: the live fill
        gauge, the achieved-depth histogram, per-round stage-wait
        histograms, and the host work of each finalize after its device
        force (the serial host work the pipeline overlaps with other
        members' launches)."""
        m = self.metrics

        def observe(ev):
            r = ev["round"]
            m.gauge("pipeline_depth", ev["depth"])
            m.observe("pipeline_depth_achieved", ev["depth"])
            m.observe("pipeline_stage_wait_s", ev["stage_wait_s"])
            m.observe("pipeline_stage_wait_s/round%d" % r,
                      ev["stage_wait_s"])
            m.gauge("pipeline_host_finalize_s/round%d" % r,
                    ev["host_finalize_s"])
        return observe

    def _run_pipeline(self, worker, backend, items):
        """One round-pipelined attempt: the (job, resources) items advance
        through the five round stages with their device launches
        overlapping each other's host finalize work
        (prover.prove_pipelined), proof bytes byte-identical to
        sequential attempts. Failure isolation
        matches _run_group: a killed/timed-out/erroring member is
        retried or failed ALONE (its round snapshot is durable; the
        retry resumes it via the sequential path) while the surviving
        members complete in this very call. Returns False when the pool
        is draining (thread exits)."""
        live, reses = [], []
        for job, res in items:
            if job.expired():
                self.shed(job, "ttl expired before prove start")
            else:
                live.append(job)
                reses.append(res)
        if not live:
            return True
        worker.busy_jobs = list(live)
        for job in live:
            if job.started_at is None:
                job.started_at = time.monotonic()
                self.metrics.observe("job_wait", job.wait_s)
            job.worker = worker.name
            job.state = J.RUNNING
            if self.journal is not None:
                self.journal.append(JN.START, job.id, worker=worker.name)
        self.metrics.inc("pipelined_proves")
        self.metrics.inc("pipelined_jobs", len(live))
        tracers = [self._job_tracer(worker, job) for job in live]
        ckts = [J.build_circuit(job.spec) for job in live]
        guards = [self._make_guard(job, worker) for job in live]
        rngs = [random.Random(job.spec.seed) for job in live]
        pks = [res.pk for res in reses]
        if self.job_timeout_s is not None:
            worker.deadline = (min(j.started_at for j in live)
                               + self.job_timeout_s)
        try:
            proofs, errors = prove_pipelined(
                rngs, ckts, pks, backend, tracers=tracers,
                checkpoints=guards, abort_on=(WorkerDrained,),
                observer=self._pipeline_observer())
        except WorkerDrained:
            # drain aborts the pipeline: every member parks at its own
            # stage latch (snapshots durable, journal unchanged) — the
            # restarted service resumes or re-proves deterministically
            for job in live:
                job.attempts.append({"worker": worker.name,
                                     "outcome": "drained"})
                job.state = J.QUEUED
                job.worker = None
                self.metrics.inc("jobs_drain_parked")
            worker.busy_jobs = []
            return False
        except Exception as e:  # pipeline-wide infrastructure failure
            for job, res in zip(live, reses):
                job.attempts.append({"worker": worker.name,
                                     "outcome": f"error: {e!r}"})
                self.metrics.inc("job_attempt_errors")
                self._retry_or_fail(job, res,
                                    f"pipelined prove failed: {e!r}")
            worker.busy_jobs = []
            worker.kill_arm = None
            return True
        finally:
            worker.deadline = None
        for job, res, tracer, ckt, proof, err in zip(live, reses, tracers,
                                                     ckts, proofs, errors):
            if proof is not None:
                try:
                    self._finish_proved(job, res, ckt, proof, tracer,
                                        backend=backend)
                    job.attempts.append({"worker": worker.name,
                                         "outcome": "ok"})
                    self.metrics.inc("jobs_completed")
                    self.metrics.observe("job_run", job.run_s)
                except Exception as e:  # verify/journal failure
                    job.attempts.append({"worker": worker.name,
                                         "outcome": f"error: {e!r}"})
                    self.metrics.inc("job_attempt_errors")
                    self._retry_or_fail(job, res, f"prove failed: {e!r}")
            elif isinstance(err, WorkerKilled):
                # job-scoped kill: only this member died; it resumes
                # ALONE from its snapshot via the single-job retry path
                job.attempts.append({"worker": worker.name,
                                     "outcome": "killed"})
                self.metrics.inc("batch_member_kills")
                self._retry_or_fail(job, res,
                                    "pipeline member killed mid-prove")
            elif isinstance(err, JobTimeout):
                job.attempts.append({"worker": worker.name,
                                     "outcome": "timeout"})
                self.metrics.inc("jobs_timeout")
                self._fail(job, f"timeout after {self.job_timeout_s}s")
            else:
                job.attempts.append({"worker": worker.name,
                                     "outcome": f"error: {err!r}"})
                self.metrics.inc("job_attempt_errors")
                self._retry_or_fail(job, res, f"prove failed: {err!r}")
        worker.busy_jobs = []
        worker.kill_arm = None
        return True

    def _retry_or_fail(self, job, res, reason):
        job.retries += 1
        if job.retries > self.max_retries:
            self._fail(job, f"{reason} (retries exhausted)")
            return
        self.metrics.inc("job_retries")
        olog.emit("service", "retry", level="warn", job_id=job.id,
                  trace_id=job.trace_id, retries=job.retries,
                  reason=reason[:200])
        job.state = J.QUEUED
        if job.placement == "mesh" and self._requeue is not None:
            # back through the scheduler: the retry must be RE-PLACED on
            # a fresh submesh lease (the snapshot still resumes it — the
            # checkpoint is keyed by job id, not by backend)
            job.worker = None
            job.placement = None
            try:
                self._requeue.submit(job, force=True)
                return
            except Exception:  # queue closed (drain/shutdown): fall back
                pass           # to the in-pool retry below
        # snapshot stays in place: the retry resumes, not restarts.
        # NEVER block a worker thread on the requeue: workers are the
        # dispatch queue's consumers, so a blocking put from one with the
        # queue full can deadlock the whole pool — hand a full queue off
        # to a detached putter instead
        try:
            self._dispatch_q.put_nowait((job, res))
        except _stdlib_queue.Full:
            threading.Thread(target=self._dispatch_q.put, args=((job, res),),
                             daemon=True).start()

    def _fail(self, job, reason):
        self.metrics.inc("jobs_failed")
        olog.emit("service", "job_failed", level="error", job_id=job.id,
                  trace_id=job.trace_id, reason=reason[:200])
        self._clear_ckpt(job)
        if self.journal is not None:
            self.journal.append(JN.FAILED, job.id, reason=reason)
        job.finish_err(reason)

    def _job_tracer(self, worker, job):
        """The prover traces under the JOB's id (stamped/adopted at
        SUBMIT), parented to the client's span when one was propagated —
        every retry attempt re-records from scratch, so the stored
        timeline is the attempt that produced the proof plus the queue
        wait that preceded it. The queued span carries the PLACEMENT
        decision as attrs (placement class + shape-batch size), so the
        trace timeline shows how the scheduler routed the job."""
        tracer = Tracer(trace_id=job.trace_id,
                        parent_id=job.trace_parent,
                        proc=f"pool/{worker.name}")
        tracer.add_event("service/queued", ts=job.submitted_wall,
                         dur_s=job.wait_s, job_id=job.id,
                         placement=job.placement,
                         batch_size=job.batch_size)
        return tracer

    def _finish_proved(self, job, res, ckt, proof, tracer, backend=None):
        """Post-prove completion shared by the single and batched paths:
        verify-before-serve, round/kernel metrics, finished-proof
        durability, trace artifact, client-visible done. ORDER IS THE
        CONTRACT: the self-verify gate runs on the serialized bytes
        BEFORE the journal DONE append, so a corrupted proof can never
        be journaled as done, served from an artifact after a restart,
        or handed to a client."""
        # the top-level spans (round1..round5 and the pipelined finalize
        # halves), as the JAX package's totals(depth=1) reads them: the
        # service's own events (service/queued, ...) are not rounds
        totals = {k: v for k, v in tracer.totals().items() if "/" not in k}
        self.metrics.observe_rounds(totals)
        # the kernel work the prove's events carry (prover.py): per-stage
        # throughput and share of the peak of the cards it proved on
        self.metrics.observe_kernels(tracer.events,
                                     peak=backend_peak(backend))
        proof_bytes = serialize_proof(proof)
        pub = ckt.public_input()
        if self.faults is not None and self.faults.on_proof(job.id):
            # at=proof chaos plane: SDC between prove and serve — flip
            # one byte so only the verify gate below can catch it
            mid = len(proof_bytes) // 2
            proof_bytes = (proof_bytes[:mid]
                           + bytes([proof_bytes[mid] ^ 0xFF])
                           + proof_bytes[mid + 1:])
        if self._should_self_verify(job, backend):
            self._self_verify(job, res, pub, proof_bytes, tracer)
        self._journal_done(job, proof_bytes, pub)
        self._store_trace(job, tracer)
        job.finish_ok(proof_bytes, pub, totals)
        # per-kind served counter: the circuit-zoo mix as the server saw
        # it (aggregation eligibility and console's by-kind pane both
        # read job state; this is the cheap cumulative view)
        self.metrics.inc("circuit_kind_%s" % job.spec.kind)
        # per-SLO-class roundtrip (submit -> served)
        self.metrics.observe(
            "slo_roundtrip/%s" % getattr(job, "slo", "standard"),
            time.monotonic() - job.submitted_at)

    def _should_self_verify(self, job, backend=None):
        if self.verify_on_complete:
            return True
        mode = self.self_verify
        if mode in ("0", "off"):
            return False
        if mode in ("1", "on", "always"):
            return True
        # auto: only the non-local compute planes pay the pairing check:
        # mesh placements, or a prove that ran on a fleet backend
        # (RemoteBackend.name): that is where SDC lives
        return (job.placement == "mesh"
                or getattr(backend, "name", "") == "remote")

    def _self_verify(self, job, res, pub, proof_bytes, tracer):
        """The end-to-end truth oracle, moved into the serving path: the
        host pairing verifier runs on the SERIALIZED bytes (what would
        be journaled/served), its verdict and latency land in metrics +
        the job's trace timeline, and a failure blocks the proof."""
        from ..proof_io import deserialize_proof
        from ..verifier import verify
        w0, p0 = time.time(), time.perf_counter()
        try:
            ok = verify(res.vk, pub, deserialize_proof(proof_bytes),
                        rng=random.Random(1))
        except Exception:  # undecodable bytes are equally blocked
            ok = False
        dur = time.perf_counter() - p0
        self.metrics.inc("self_verify_checks")
        self.metrics.observe("self_verify_s", dur)
        tracer.add_event("service/self_verify", ts=w0, dur_s=dur,
                         job_id=job.id, ok=ok)
        if ok:
            return
        self.metrics.inc("self_verify_failures")
        self.metrics.inc("proofs_blocked")
        olog.emit("service", "self_verify_blocked", level="error",
                  job_id=job.id, trace_id=job.trace_id)
        # never resume the corrupt state: the retry re-proves fresh
        # (deterministic bytes — a transient SDC yields a good proof,
        # a persistent one exhausts retries into a FAILED verdict,
        # which is still never a wrong answer served)
        self._clear_ckpt(job)
        raise ProofRejected(
            f"proof for job {job.id} failed verify-before-serve")

    def _run_attempt(self, worker, backend, job, res):
        if self.job_timeout_s is not None:
            worker.deadline = job.started_at + self.job_timeout_s
        try:
            tracer = self._job_tracer(worker, job)
            ckt = J.build_circuit(job.spec)
            guard = self._make_guard(job, worker)
            try:
                proof = prove(random.Random(job.spec.seed), ckt, res.pk,
                              backend, tracer=tracer, checkpoint=guard)
            except ValueError as e:
                if "different circuit" in str(e):
                    # a stale snapshot from some earlier run squats on our
                    # path: drop it so the retry restarts fresh instead of
                    # failing identically until retries are exhausted
                    guard.clear()
                raise
            self._finish_proved(job, res, ckt, proof, tracer,
                                backend=backend)
        finally:
            worker.deadline = None

    def _store_trace(self, job, tracer):
        """Merge + persist the job's timeline: always retained on the Job
        (STATUS reports trace_spans; /trace serves it), and — with a
        store — written as the content-addressed `trace:<job_id>`
        artifact (STORE_FETCHable, like the proof it explains).
        Observability is best-effort: failure to persist never fails a
        finished prove."""
        from ..trace import merge_traces
        merged = merge_traces([tracer.dump()])
        # trace-correlated structured log events (obs/log.py) ride the
        # stored timeline too: every shed/retry/self-verify verdict for
        # this trace id, queryable next to the spans it explains (the
        # chrome export renders them as instant events)
        merged["logs"] = olog.fetch(trace_id=job.trace_id)["events"]
        job.trace_dump = merged
        self.metrics.inc("trace_spans_recorded", len(merged["events"]))
        if self.store is None:
            return
        from ..store import keycache as KC
        try:
            KC.store_trace(self.store, job.id, merged)
            self.metrics.inc("traces_stored")
        except Exception:  # pragma: no cover - environmental (disk)
            self.metrics.inc("store_write_errors")

    def _journal_done(self, job, proof_bytes, pub):
        """Finished-proof durability, BEFORE the client-visible state
        flips to done: the proof becomes a content-addressed store
        artifact (STORE_FETCHable cross-host; a restart serves it
        instead of re-proving) and the journal DONE record carries its
        digest, or, storeless, the raw bytes inline (944B per proof:
        small enough that the journal stays the single durable surface).
        A crash anywhere before the DONE append re-proves from the
        round-4 snapshot and lands on the identical bytes."""
        if self.journal is None:
            return
        fields = {"pub": [hex(x) for x in pub], "retries": job.retries}
        if self.store is not None:
            from ..store import keycache as KC
            try:
                fields["digest"] = KC.store_proof(
                    self.store, job.id, proof_bytes, pub,
                    spec_wire=job.spec.to_wire(), retries=job.retries)
                fields["store_key"] = KC.proof_store_key(job.id)
            except Exception:  # pragma: no cover - environmental (disk)
                self.metrics.inc("store_write_errors")
                fields["proof_hex"] = proof_bytes.hex()
        else:
            fields["proof_hex"] = proof_bytes.hex()
        self.journal.append(JN.DONE, job.id, **fields)
