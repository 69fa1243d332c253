"""TCP frontend: SUBMIT/STATUS/RESULT/METRICS/WARMUP on the runtime wire plane
(a copy of the JAX package's service/server.py, proving on the card).

Reuses runtime/native.py's framed transport and runtime/protocol.py's tag
space (the same plane the kernel workers speak), one thread per
connection like runtime/worker.py, so a deployment speaks ONE protocol
whether a frame carries an MSM or a proof job. Control payloads are JSON;
the RESULT reply carries the 944-byte proof_io layout after a JSON header.
The tags and payloads are the JAX package's: either package's client
drives either package's service.

`ProofService` is also directly embeddable (the tests and chip_smoke.py
drive it in-process through `submit_local` and the client): the TCP
listener is just one more producer into the queue.

Devices: `ProofService(device=None)` proves on the card and raises
without one; `device="cpu"` runs every kernel's plain version (the
tests). Bucket keys build on that device, the pool's workers prove on
TorchBackend there, and mesh-class jobs shard over leased slots of
`devices` (default: every card).

Durability: with `journal_dir`, every job transition is journaled
write-ahead (service/journal.py): a crashed/restarted frontend replays
the journal, resumes in-flight jobs from their store checkpoints, serves
finished jobs from content-addressed proof artifacts, dedups resubmitted
job_keys, sheds expired TTLs with a queryable verdict, and drains
gracefully on SIGTERM (the service entry point, __main__.py). `crash()`
is the in-process SIGKILL analog the restart tests use.

Elastic fleets: `attach_membership` registers a dispatcher membership's
store-serving members as bucket-cache peers, and `attach_autoscaler`
arms the closed-loop autoscaler (service/autoscale.py) over a
WorkerSupervisor.

Observability and calibration: `attach_fleet` scrapes a worker fleet's
metrics on an interval (obs/fleet.py) for ObsServer's /metrics and
/fleet; `profile_fleet_worker` stores one worker's on-demand capture as
a profile:<id> artifact (/profile/<id>); the pool folds every finished
prove's kernel events into the kernel_*_gflops / mfu_*_pct gauges. With
a store, `start()` first adopts the store's kernel plan for this card
(store/calibration.py, `autotune="off"|"load"|"run"`) and reports it in
`autotune`.

Kernel build (store/kernels.py): on the card, `start()` gives the process
its kernel libraries before anything loads them: the build directory,
the store's `kbuild:` artifact, then the `store_peers`, else nvcc on a
thread. A service with a store publishes its build there once the
kernels are loaded (the counterpart of the JAX serve.py's compile cache
under the store). METRICS reports where they came from under `build`.
"""

import os
import threading
import time

from ..backend import _build
from ..backend.field_torch import resolve_device
from ..obs import log as olog
from ..runtime import native, protocol
from ..store import ArtifactStore, aot_warmup, remote
from . import jobs as J
from . import journal as JN
from .jobs import Job, JobSpec
from .metrics import Metrics
from .placement import PlacementScheduler
from .pool import WorkerPool
from .queue import JobQueue, Rejected
from .scheduler import BucketCache


class ProofService:
    def __init__(self, host="127.0.0.1", port=0, prover_workers=2,
                 queue_depth=64, max_batch=8, max_retries=2,
                 job_timeout_s=None, ckpt_dir=None, chaos=False,
                 backend_factory=None, verify_on_complete=False,
                 finished_retention=4096, allow_remote_shutdown=False,
                 store_dir=None, store_byte_budget=None, bucket_cap=64,
                 store_peers=None, faults=None, journal_dir=None,
                 devices=None, mesh_backend_factory=None,
                 self_verify=None, device=None, autotune="load"):
        # the service's device: None is the card (raises without one)
        self.device = resolve_device(device, "ProofService")
        self.host = host
        self.port = port
        self.chaos = chaos
        self.allow_remote_shutdown = allow_remote_shutdown
        self.metrics = Metrics()
        self.queue = JobQueue(max_depth=queue_depth)
        self.store = None
        if store_dir is not None:
            self.store = ArtifactStore(store_dir,
                                       byte_budget=store_byte_budget,
                                       metrics=self.metrics.scoped("store"))
        # faults: runtime.faults.FaultInjector (chaos mode only): the
        # pool runs its checkpoint-plane rules at round boundaries and
        # the journal its journal-plane rules after each append. An
        # injector built without a metrics registry adopts ours, so its
        # faults_injected_*/faults_ckpt_corrupted counters show up in the
        # same METRICS snapshot as the recovery counters they provoke.
        self.faults = faults if chaos else None
        if self.faults is not None and self.faults.metrics is None:
            self.faults.metrics = self.metrics
        # journal: the crash-safety spine (service/journal.py). Replays
        # on open; `start()` then recovers every journaled job — queued
        # and in-flight ones resume from their checkpoints, finished ones
        # serve from their proof artifacts. Without a journal_dir the
        # service keeps the PR-1 in-memory-only behavior.
        self.journal = None
        if journal_dir is not None:
            self.journal = JN.JobJournal(journal_dir, metrics=self.metrics,
                                         retain_terminal=finished_retention,
                                         chaos=self.faults)
        self.pool = WorkerPool(
            self.metrics, prover_workers=prover_workers,
            max_retries=max_retries, job_timeout_s=job_timeout_s,
            ckpt_dir=ckpt_dir, backend_factory=backend_factory,
            verify_on_complete=verify_on_complete, store=self.store,
            faults=self.faults, journal=self.journal,
            requeue=self.queue, self_verify=self_verify,
            device=self.device)
        # store_peers: [(host, port)] of peers speaking STORE_FETCH: a
        # bucket miss tries a network copy from a warm peer before paying
        # for a full key build (elastic scale-out: a fresh host serves
        # warm after one fetch)
        self.buckets = BucketCache(self.metrics, device=self.device,
                                   store=self.store,
                                   max_entries=bucket_cap,
                                   peers=store_peers)
        # placement-aware scheduling (service/placement.py): small shape
        # buckets prove data-parallel (cross-job batched kernel launches,
        # byte-identical to sequential), large ones shard over a leased
        # submesh, mid sizes keep the per-job pool path. devices (the
        # slots to lease: every card of this host by default, or an
        # explicit list such as four slots of "cuda:0") and
        # mesh_backend_factory are injection points.
        self.scheduler = PlacementScheduler(
            self.queue, self.pool, self.metrics, buckets=self.buckets,
            max_batch=max_batch, devices=devices,
            mesh_backend_factory=mesh_backend_factory, device=self.device)
        # kernel-calibration pickup report (store/calibration.py), filled
        # by start(): {"source": off|none|store|fresh|error, ...}. Without
        # a store (or with autotune="off") no plan is loaded and every
        # kernel path keeps its built-in constants.
        self.autotune = {"source": "off"}
        self._autotune_mode = autotune
        # fleet observability (obs/fleet.py): attach_fleet() arms the
        # interval scraper behind /fleet and the dpt_fleet_* series;
        # profile captures land under profile:<id> (or, without a store,
        # in a small table)
        self.fleet = None
        self._profiles = {}
        # built aggregate artifacts: storeless fallback table
        # agg_id -> JSON blob bytes, restored from the journal's AGG
        # records at recovery; store-backed services serve from
        # aggregate:<agg_id> instead. Bounded like the journal's memory
        # of terminal jobs — refolding N DONE jobs is always possible.
        self._aggregates = {}
        self._aggregates_cap = max(64, finished_retention // 4)
        # shape_key -> vk cache for aggregate self-verification (usually
        # satisfied straight from the bucket cache, see aggregate_jobs)
        self._agg_vk_cache = {}
        # structured logs (obs/log.py) publish their counters into this
        # registry (per-process buffer; last-constructed service wins,
        # which is the daemon case that matters)
        olog.set_metrics(self.metrics)
        self._warm_backend = None
        self._warm_backend_lock = threading.Lock()
        self.jobs = {}
        self._job_keys = {}   # idempotency: job_key -> job_id (journaled)
        self.finished_retention = finished_retention
        self._jobs_lock = threading.Lock()
        # serializes the whole admission sequence (dedup check -> journal
        # SUBMIT -> queue insert), so a concurrent duplicate can never
        # dedup onto a job that is still mid-admission (and might yet be
        # rejected and rolled back, or not yet journaled — its positive
        # ack must imply the write-ahead record exists). Distinct from
        # _jobs_lock so STATUS lookups never wait behind an fsync.
        self._submit_lock = threading.Lock()
        self._listener = None
        self._stopped = threading.Event()
        # the dispatcher whose fleet a membership registry describes
        # (attach_membership): the autoscaler's fleet sensor reads its
        # liveness tracker
        self.fleet_dispatcher = None
        # closed-loop autoscaler (service/autoscale.py): attach_autoscaler
        # sets it; None is off
        self.autoscaler = None

    def attach_membership(self, registry):
        """Discover the fleet's store-serving members as bucket-cache peers
        (runtime/membership.py): every current store member is registered
        now, every later JOIN that advertises a store as it lands, and a
        LEAVEd member is dropped."""
        def _on_change(ev):
            if ev.get("event") == "join" and ev.get("store"):
                self.buckets.add_peer(ev["host"], ev["port"])
            elif ev.get("event") == "leave" and "host" in ev:
                self.buckets.remove_peer(ev["host"], ev["port"])
        registry.subscribe(_on_change)
        for host, port in registry.store_peers():
            self.buckets.add_peer(host, port)
        self.fleet_dispatcher = registry.d
        return self

    def attach_fleet(self, dispatcher, interval_s=5.0, start=True):
        """Arm the fleet observability plane (obs/fleet.py) for a service
        whose backend proves on a worker fleet: an interval scraper pulls
        every roster member's METRICS_FETCH snapshot, folds fleet
        aggregates into this registry, and keeps the latest per-worker
        snapshots for ObsServer's /metrics (labelled dpt_fleet_* series)
        and /fleet; profile_fleet_worker becomes available. The scraper
        walks the dispatcher's current worker list each cycle, so joins
        and leaves show at the next scrape."""
        from ..obs.fleet import FleetScraper
        self.fleet_dispatcher = dispatcher
        self.fleet = FleetScraper(dispatcher, self.metrics,
                                  interval_s=interval_s)
        if start:
            self.fleet.start()
        return self

    def attach_autoscaler(self, supervisor=None, mode="0", **kw):
        """Arm the closed-loop autoscaler (service/autoscale.py): mode "0"
        (the default) attaches nothing and returns None; "dry" runs the
        control loop and records decisions without one actuator call;
        "1" actuates (supervisor add_slot / retire_slot, submesh lease
        resize, pressure sheds). Pass the WorkerSupervisor that owns the
        fleet's worker processes to enable worker scaling; without one
        the controller still resizes leases and sheds."""
        from . import autoscale as AS
        return AS.attach(self, supervisor=supervisor, mode=mode, **kw)

    def profile_fleet_worker(self, worker=0, duration_ms=None,
                             kind="auto"):
        """On-demand profile of one fleet worker (PROFILE wire tag): the
        capture lands as a content-addressed profile:<id> artifact
        (store-backed when the service has one, else a small in-memory
        table) served at /profile/<id>. Returns the capture's meta with
        its "profile_id" (None for an empty capture, counted as
        profile_errors). Raises RuntimeError without an attached fleet."""
        if self.fleet_dispatcher is None:
            raise RuntimeError("no fleet attached (attach_fleet)")
        from ..obs import profiling
        meta, blob = self.fleet_dispatcher.profile_worker(
            worker, duration_ms=duration_ms, kind=kind)
        if not blob:
            self.metrics.inc("profile_errors")
            return dict(meta, profile_id=None)
        pid = profiling.profile_id(blob)
        meta = dict(meta, profile_id=pid)
        if self.store is not None:
            from ..store import keycache as KC
            KC.store_profile(self.store, pid, blob, meta)
        else:
            self._profiles[pid] = (meta, blob)
            while len(self._profiles) > 8:  # bounded fallback table
                self._profiles.pop(next(iter(self._profiles)))
        self.metrics.inc("profiles_stored")
        olog.emit("obs", "profile_stored", worker=worker,
                  profile_id=pid, format=meta.get("format"))
        return meta

    def load_profile(self, profile_id):
        """(meta, blob) for one stored capture, or None."""
        if self.store is not None:
            from ..store import keycache as KC
            hit = KC.load_profile(self.store, profile_id)
            if hit is not None:
                return hit
        return self._profiles.get(profile_id)

    # -- batch-KZG proof aggregation (aggregate.py) ----------------------------

    def aggregate_jobs(self, job_ids):
        """Fold N DONE jobs' proofs into one batch-KZG aggregate artifact
        (the AGGREGATE wire tag's local implementation).

        All-or-nothing by design: any unknown or non-DONE member raises
        (LookupError / ValueError with the offending job id) — a partial
        aggregate would silently weaken the client's "everything in this
        batch verified" claim. The built artifact is self-verified (ONE
        2-pair pairing check, vks served from the bucket cache the
        members were just proved with), journaled as an AGG record, and
        persisted as aggregate:<agg_id> (store) or in the in-memory
        fallback table. Returns the AGGREGATE reply dict.
        """
        from .. import aggregate as AGG
        if not isinstance(job_ids, list) or not job_ids \
                or not all(isinstance(j, str) for j in job_ids):
            raise ValueError("job_ids must be a non-empty list of ids")
        members, kinds = [], []
        for jid in job_ids:
            job = self.get_job(jid)
            if job is None:
                raise LookupError(f"unknown job {jid!r}")
            if job.state != J.DONE or job.proof_bytes is None:
                raise ValueError(
                    f"job {jid} not aggregatable (state={job.state})")
            members.append({"job_id": job.id, "spec": job.spec.to_wire(),
                            "pub": job.public_input,
                            "proof": job.proof_bytes})
            kinds.append(job.spec.kind)
        t0 = time.monotonic()
        agg = AGG.build(members)
        blob = AGG.to_bytes(agg)
        agg_id = agg["agg_id"]
        # self-verify before anything durable: the pool already verified
        # every member, so this pins the FOLD itself (and the vk cache is
        # warm — the bucket cache just proved these shapes)
        for jid in job_ids:
            job = self.get_job(jid)
            key = job.shape_key
            if key not in self._agg_vk_cache:
                self._agg_vk_cache[key] = self.buckets.get(job.spec).vk
        t_v = time.monotonic()
        if not AGG.verify(agg, self._agg_vk_cache):
            self.metrics.inc("aggregate_verify_failures")
            raise ValueError("aggregate self-verification failed")
        self.metrics.observe("aggregate_verify_s", time.monotonic() - t_v)
        rec = {"members": list(job_ids), "ts": time.time()}
        digest = None
        if self.store is not None:
            from ..store import keycache as KC
            digest = KC.store_aggregate(self.store, agg_id, blob,
                                        job_ids, kinds=kinds)
            rec["store_key"] = KC.aggregate_store_key(agg_id)
            rec["digest"] = digest
        else:
            rec["agg_hex"] = blob.hex()
        self._stash_aggregate(agg_id, blob)
        # journal writers serialize on _submit_lock (same discipline as
        # the SUBMIT write-ahead append)
        if self.journal is not None:
            with self._submit_lock:
                self.journal.append(JN.AGG, agg_id, **rec)
        build_s = time.monotonic() - t0
        self.metrics.inc("aggregates_built")
        self.metrics.inc("aggregate_members", len(members))
        olog.emit("aggregate", "built", agg_id=agg_id,
                  members=len(members), kinds=sorted(set(kinds)),
                  build_s=round(build_s, 6))
        return {"agg_id": agg_id, "members": list(job_ids),
                "kinds": sorted(set(kinds)), "digest": digest,
                "build_s": round(build_s, 6)}

    def _stash_aggregate(self, agg_id, blob):
        self._aggregates[agg_id] = blob
        while len(self._aggregates) > self._aggregates_cap:
            self._aggregates.pop(next(iter(self._aggregates)))

    def load_aggregate_blob(self, agg_id):
        """Canonical JSON blob of one built aggregate, or None."""
        if self.store is not None:
            from ..store import keycache as KC
            hit = KC.load_aggregate(self.store, agg_id)
            if hit is not None:
                return hit[0]
        return self._aggregates.get(agg_id)

    # -- local (in-process) API ----------------------------------------------

    def submit_local(self, spec_obj):
        """Validate + admit one job; returns the Job. Raises ValueError
        (bad spec) or Rejected (admission control)."""
        return self.submit_ex(spec_obj)[0]

    def submit_ex(self, spec_obj):
        """(job, deduped): like submit_local, but reports whether the
        spec's job_key matched an existing job (idempotent submission —
        the duplicate gets the ORIGINAL job, which may already be done
        and served from its finished-proof artifact, even across a
        service restart)."""
        spec = JobSpec.from_wire(spec_obj)
        job = Job(spec)
        # distributed tracing: adopt the client's trace context when the
        # SUBMIT payload carries one (trace_ctx rides beside the spec
        # fields; it changes nothing about the circuit), else the fresh
        # id Job() stamped stands — either way every job has exactly one
        # trace id from admission to the last worker kernel
        ctx = spec_obj.get("trace_ctx") if isinstance(spec_obj, dict) \
            else None
        if isinstance(ctx, dict):
            tid = ctx.get("trace_id")
            if isinstance(tid, str) and tid:
                job.trace_id = tid
            parent = ctx.get("parent_id")
            if isinstance(parent, str) and parent:
                job.trace_parent = parent
        with self._submit_lock:
            with self._jobs_lock:
                if spec.job_key is not None:
                    existing = self.jobs.get(
                        self._job_keys.get(spec.job_key))
                    if existing is not None:
                        self.metrics.inc("dedup_hits")
                        return existing, True
                    self._job_keys[spec.job_key] = job.id
                self._register_locked(job)
            self.metrics.inc("jobs_submitted")
            # write-ahead: journal the admission BEFORE the in-memory
            # queue sees it — a crash on the next line recovers the job;
            # the reverse order would ack a job a restart has never
            # heard of
            if self.journal is not None:
                self.journal.append(JN.SUBMIT, job.id, spec=spec.to_wire(),
                                    key=spec.job_key,
                                    deadline=job.deadline_ts,
                                    trace=job.trace_id,
                                    trace_parent=job.trace_parent,
                                    ts=time.time())
            try:
                self.queue.submit(job)
            except Rejected as e:
                # shed-lowest-class-first admission: a FULL queue refusing
                # a higher-SLO-class job first tries to evict the worst
                # queued job of a strictly lower class (journaled SHED)
                # and admit the newcomer in its place. An all-standard
                # stream can never preempt (no lower rank exists), so the
                # classless path keeps the historical plain rejection.
                if e.reason == "queue_full":
                    victim = self.queue.steal_lowest(job.slo_rank)
                    if victim is not None:
                        self.metrics.inc("slo_preempt_sheds")
                        self.pool.shed(
                            victim,
                            f"preempted by {job.slo}-class admission")
                        # force: we hold _submit_lock, and the victim's
                        # slot was freed this instant — bouncing on a
                        # racing scheduler pop would lose the preemption
                        self.queue.submit(job, force=True)
                        self.metrics.inc("jobs_accepted")
                        self.metrics.gauge("queue_depth",
                                           self.queue.depth())
                        return job, False
                self.metrics.inc("jobs_rejected")
                if self.journal is not None:
                    # terminal verdict so replay never resurrects a job
                    # the client was told was refused
                    self.journal.append(JN.SHED, job.id,
                                        reason=JN.REJECTED_PREFIX + e.reason)
                with self._jobs_lock:
                    self.jobs.pop(job.id, None)
                    if spec.job_key is not None \
                            and self._job_keys.get(spec.job_key) == job.id:
                        del self._job_keys[spec.job_key]
                raise
        self.metrics.inc("jobs_accepted")
        self.metrics.gauge("queue_depth", self.queue.depth())
        return job, False

    def _register_locked(self, job):
        """Insert into the job table (caller holds _jobs_lock) and bound
        it: evict the oldest FINISHED jobs (dict preserves insertion
        order) once past the retention cap — live jobs are never evicted,
        and admission control already bounds how many can be live."""
        self.jobs[job.id] = job
        excess = len(self.jobs) - self.finished_retention
        if excess > 0:
            # oldest-first (dict insertion order), stop as soon as the
            # excess is covered — finished jobs cluster at the front,
            # so this stays O(excess + live prefix), not O(table)
            evict = []
            for jid, j in self.jobs.items():
                if len(evict) >= excess:
                    break
                if j.state in J.TERMINAL:
                    evict.append(jid)
            for jid in evict:
                j = self.jobs.pop(jid)
                if j.job_key is not None \
                        and self._job_keys.get(j.job_key) == jid:
                    del self._job_keys[j.job_key]
            if evict:
                self.metrics.inc("jobs_evicted", len(evict))

    def get_job(self, job_id):
        with self._jobs_lock:
            return self.jobs.get(job_id)

    def warmup_local(self, spec_obj, aot=False):
        """Pre-resolve one shape bucket through the cache tiers (memory ->
        store -> build; a build lands in the store) and, with aot=True,
        build its prover stages (kernels, NTT plans, the shifted commit
        key) on a pool-equivalent backend. Returns
        the summary the WARMUP tag replies with. Raises ValueError on a
        bad spec."""
        spec = JobSpec.from_wire(spec_obj)
        self.metrics.inc("warmups")
        t0 = time.monotonic()
        res, source = self.buckets.get_with_source(spec)
        out = {
            "shape_key": [str(p) for p in res.shape_key],
            "source": source,
            "domain_size": res.domain_size,
            "build_s": round(res.build_s, 6),
            "warm_s": round(time.monotonic() - t0, 6),
        }
        if aot:
            # same factory the pool workers use, so what we build is what
            # they run; one shared instance: the kernels and NTT plans
            # are process-wide, the shifted key is this backend's
            with self._warm_backend_lock:
                if self._warm_backend is None:
                    self._warm_backend = self.pool.backend_factory()
                backend = self._warm_backend
            out["aot"] = aot_warmup(backend, res.domain_size, ck=res.pk.ck)
        return out

    # -- restart recovery -----------------------------------------------------

    def _recover(self):
        """Rebuild queue + job table from the replayed journal (runs in
        start(), before the scheduler/listener). Non-terminal jobs are
        re-enqueued under their ORIGINAL ids — their `ckpt:<id>` round
        snapshots still match, so the prove resumes at the last journaled
        round boundary with zero recompute. DONE jobs are restored from
        their finished-proof artifacts (no re-prove; a lost artifact
        degrades to a re-prove of the same deterministic bytes). SHED and
        FAILED verdicts stay queryable."""
        if self.journal is None:
            return
        recovered = finished = aggregates = 0
        for jid, st in list(self.journal.state.items()):
            if st.get("phase") == "aggregate":
                # AGG records carry no job spec: restore the artifact's
                # serving path (store or fallback table) and move on
                if self._restore_aggregate(jid, st):
                    aggregates += 1
                continue
            try:
                spec = JobSpec.from_wire(st.get("spec"))
            except (ValueError, TypeError):
                # unparseable SUBMIT payload (foreign/ancient journal):
                # skip the record, never refuse to start
                continue
            job = Job(spec, job_id=jid)
            # the deadline is the ORIGINAL submission's, not re-derived
            # from recovery time — a restart must not extend any TTL
            job.deadline_ts = st.get("deadline")
            # ...and so is the trace identity: the SUBMIT reply already
            # told the client this id; re-stamping would orphan the
            # client's spans from the recovered job's timeline
            if st.get("trace"):
                job.trace_id = st["trace"]
                job.trace_parent = st.get("trace_parent")
            phase = st["phase"]
            if phase == "done" and self._restore_done(job, st):
                finished += 1
            elif phase == "shed":
                job.finish_shed(st.get("reason") or "shed")
            elif phase == "failed":
                job.finish_err(st.get("reason") or "failed")
            elif job.expired():
                # deadline lapsed during the outage: verdict, not work.
                # (JobJournal serializes internally; _recover runs before
                # the scheduler/listener threads exist, so the submit
                # lock is not needed here)
                # analysis: ok(journal locks itself; recovery is single-threaded)
                self.journal.append(JN.SHED, job.id,
                                    reason="ttl expired during restart")
                self.metrics.inc("jobs_shed")
                job.finish_shed("ttl expired during restart")
            else:
                # queued or mid-prove at crash time (a DONE job whose
                # artifact was lost also lands here): back in the queue,
                # bypassing the depth cap — the PREVIOUS process already
                # admitted it
                self.queue.submit(job, force=True)
                recovered += 1
            # rejected submissions keep their queryable verdict but do
            # NOT reclaim the job_key: the live path frees the key on
            # rejection so a retry is a fresh admission attempt, and a
            # restart must not change that (review finding)
            rejected = (phase == "shed" and (st.get("reason") or "")
                        .startswith(JN.REJECTED_PREFIX))
            with self._jobs_lock:
                if job.job_key is not None and not rejected:
                    self._job_keys[job.job_key] = job.id
                self._register_locked(job)
        if recovered:
            self.metrics.inc("jobs_recovered", recovered)
        if finished:
            self.metrics.inc("jobs_recovered_finished", finished)
        if aggregates:
            self.metrics.inc("aggregates_recovered", aggregates)
        self.metrics.gauge("queue_depth", self.queue.depth())
        # replay + recovery is the natural compaction point: the rewritten
        # log starts this process's epoch at its minimal size
        self.journal.compact()

    def _restore_aggregate(self, agg_id, st):
        """Re-arm serving one journaled aggregate after a restart: the
        inline blob goes back into the fallback table; a store-backed
        record just needs the artifact to still be present. False means
        the artifact is gone (evicted/corrupt) — clients refold from the
        member proofs, nothing crashes."""
        rec = st.get("done") or {}
        if rec.get("agg_hex"):
            try:
                self._stash_aggregate(agg_id, bytes.fromhex(rec["agg_hex"]))
            except ValueError:
                self.metrics.inc("aggregate_artifacts_lost")
                return False
            return True
        if self.store is not None and rec.get("store_key"):
            from ..store import keycache as KC
            hit = KC.load_aggregate(self.store, agg_id)
            if hit is not None:
                self._stash_aggregate(agg_id, hit[0])
                return True
        self.metrics.inc("aggregate_artifacts_lost")
        return False

    def _restore_done(self, job, st):
        """Restore a finished job from its DONE record: proof bytes come
        from the store artifact (or the record's inline fallback). False
        means the artifact is gone (evicted/corrupt) — caller re-proves."""
        rec = st.get("done") or {}
        proof_bytes = pub = None
        if rec.get("proof_hex"):
            proof_bytes = bytes.fromhex(rec["proof_hex"])
            pub = [int(x, 16) for x in rec.get("pub") or []]
        elif self.store is not None and rec.get("store_key"):
            from ..store import keycache as KC
            hit = KC.load_proof(self.store, job.id)
            if hit is not None:
                proof_bytes, pub, _meta = hit
                if not pub:
                    pub = [int(x, 16) for x in rec.get("pub") or []]
        if proof_bytes is None:
            self.metrics.inc("proof_artifacts_lost")
            return False
        job.retries = int(rec.get("retries") or 0)
        job.finish_ok(proof_bytes, pub, {})
        return True

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        """Start scheduler + listener threads; returns self. With port=0
        an ephemeral port is chosen and published as `self.port`.

        The kernel-plan pickup runs first (store/calibration.py), before
        the pool's threads start: a calibrated store's plan is adopted
        before any job launches a kernel, and a second start against it
        measures nothing. A failed pickup leaves the built-in constants
        in force and says so in `autotune` ({"source": "error", ...}).
        On the card the kernel build is provisioned before both
        (store/kernels.ensure_build; see the module docstring)."""
        if self.device.type == "cuda":
            from ..store import kernels
            olog.emit("service", "kernel_build", **kernels.ensure_build(
                self.store, list(self.buckets.peers), device=self.device,
                metrics=self.metrics))
        if self.store is not None:
            from ..store import calibration
            try:
                self.autotune = calibration.load_or_run(
                    self.store, mode=self._autotune_mode,
                    metrics=self.metrics, device=self.device)
            except Exception as e:  # noqa: BLE001 - see the docstring
                self.autotune = {"source": "error", "error": repr(e)}
                olog.emit("service", "calibration_failed", level="warn",
                          error=repr(e)[:300])
        self._recover()
        self.scheduler.start()
        self._listener = native.Listener(self.host, self.port)
        if self.port == 0:
            import socket
            s = socket.socket(fileno=os.dup(self._listener.fd))
            try:
                self.port = s.getsockname()[1]
            finally:
                s.close()
        threading.Thread(target=self._accept_loop, name="proof-accept",
                         daemon=True).start()
        return self

    def _accept_loop(self):
        while True:
            conn = self._listener.accept()
            if conn.fd < 0:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def serve_forever(self, poll_s=0.5):
        # bounded waits so the MAIN thread regularly re-enters the
        # interpreter: POSIX signal handlers (the entry point's SIGTERM
        # graceful drain) only run between bytecodes, and an
        # unbounded Event.wait can starve them on some platforms
        while not self._stopped.wait(poll_s):
            pass

    def shutdown(self):
        if self.autoscaler is not None:
            self.autoscaler.close()
        if self.fleet is not None:
            self.fleet.close()
        self.scheduler.stop()
        self.pool.shutdown()
        if self._listener is not None:
            self._listener.close()
        if self.journal is not None:
            self.journal.close()
        self._stopped.set()

    def drain(self, timeout_s=30.0):
        """Graceful drain (the entry point's SIGTERM path): stop
        admission immediately, let in-flight jobs finish until the
        deadline, then force the stragglers to stop at their next round
        boundary (snapshot durable, journal consistent), flush + close
        the journal, and release serve_forever. Returns True iff nothing
        needed the forced stop. Queued-but-unstarted jobs stay journaled
        and resume on the next start — a drain defers work, it never
        loses it."""
        self.metrics.inc("drain_started")
        deadline = time.monotonic() + timeout_s
        self.queue.close()       # admission now rejects with "draining"
        self.scheduler.stop()
        clean = self.pool.drain(deadline)
        self.metrics.inc("drain_clean" if clean else "drain_forced")
        olog.emit("service", "drain", clean=bool(clean))
        if self.fleet is not None:
            self.fleet.close()
        if self._listener is not None:
            self._listener.close()
        if self.journal is not None:
            self.journal.close()
        self._stopped.set()
        return clean

    def crash(self):
        """In-process analog of SIGKILL (tests, chip_smoke.py):
        seal the journal (nothing more reaches disk — exactly what a
        dead process writes), stop admission, and abandon the worker
        threads at their next round boundary WITHOUT any of shutdown's
        bookkeeping (no checkpoint clears, no terminal records, no journal
        flush). What the journal + store hold at this instant is what a
        restarted service gets."""
        if self.journal is not None:
            self.journal.seal()
        self.queue.close()
        self.scheduler.crash()
        self.pool.crash()
        if self.fleet is not None:
            self.fleet.close()
        if self._listener is not None:
            self._listener.close()
        self._stopped.set()

    # -- wire handling --------------------------------------------------------

    def _serve_conn(self, conn):
        try:
            while True:
                try:
                    tag, payload = conn.recv()
                except ConnectionError:
                    return
                try:
                    cont = self._dispatch(conn, tag, payload)
                except Exception as e:
                    try:
                        conn.send(protocol.ERR,
                                  protocol.encode_json({"reason": repr(e)}))
                    except ConnectionError:
                        return
                    continue
                if cont is False:
                    self.shutdown()
                    return
        finally:
            conn.close()

    def _dispatch(self, conn, tag, payload):
        if tag == protocol.PING:
            conn.send(protocol.OK)
        elif tag == protocol.SUBMIT:
            try:
                job, deduped = self.submit_ex(protocol.decode_json(payload))
            except ValueError as e:
                conn.send(protocol.ERR, protocol.encode_json(
                    {"reason": f"bad_spec: {e}"}))
                return None
            except Rejected as e:
                conn.send(protocol.ERR, protocol.encode_json(
                    {"reason": e.reason,
                     "queue_depth": self.queue.depth(),
                     "max_depth": self.queue.max_depth}))
                return None
            conn.send(protocol.OK, protocol.encode_json(
                {"job_id": job.id,
                 "shape_key": [str(p) for p in job.shape_key],
                 # idempotency: a duplicate job_key lands on the ORIGINAL
                 # job (possibly already done — across restarts too);
                 # "state" lets the client skip straight to RESULT
                 "dedup": deduped,
                 "state": job.state,
                 "trace_id": job.trace_id,
                 "queue_depth": self.queue.depth()}))
        elif tag == protocol.STATUS:
            job = self._lookup(conn, payload)
            if job is not None:
                conn.send(protocol.OK, protocol.encode_json(job.status()))
        elif tag == protocol.RESULT:
            job = self._lookup(conn, payload)
            if job is None:
                return None
            if job.proof_bytes is None:
                conn.send(protocol.ERR, protocol.encode_json(
                    {"reason": "not_ready", "state": job.state,
                     "error": job.error}))
                return None
            header = {"job_id": job.id,
                      "public_input": [hex(x) for x in job.public_input],
                      "spec": job.spec.to_wire(),
                      "trace_id": job.trace_id,
                      "retries": job.retries}
            conn.send(protocol.OK,
                      protocol.encode_result(header, job.proof_bytes))
        elif tag == protocol.WARMUP:
            req = protocol.decode_json(payload)
            aot = bool(req.pop("aot", False))
            try:
                out = self.warmup_local(req, aot=aot)
            except ValueError as e:
                conn.send(protocol.ERR, protocol.encode_json(
                    {"reason": f"bad_spec: {e}"}))
                return None
            conn.send(protocol.OK, protocol.encode_json(out))
        elif tag == protocol.AGGREGATE:
            req = protocol.decode_json(payload)
            try:
                out = self.aggregate_jobs(req.get("job_ids"))
            except (ValueError, LookupError) as e:
                conn.send(protocol.ERR,
                          protocol.encode_json({"reason": str(e)}))
                return None
            conn.send(protocol.OK, protocol.encode_json(out))
        elif tag == protocol.AGG_FETCH:
            agg_id = protocol.decode_json(payload).get("agg_id")
            blob = self.load_aggregate_blob(agg_id) \
                if isinstance(agg_id, str) else None
            if blob is None:
                conn.send(protocol.ERR, protocol.encode_json(
                    {"reason": f"no aggregate {agg_id!r}"}))
                return None
            conn.send(protocol.OK, protocol.encode_result(
                {"agg_id": agg_id, "bytes": len(blob)}, blob))
        elif tag == protocol.STORE_FETCH:
            # serve one artifact blob to a peer/replacement host: bucket
            # keys, prover checkpoints, anything under the store —
            # cross-host warm start and resume become a digest-verified
            # network copy (store/remote.py holds both wire sides)
            remote.serve_fetch(
                self.store, payload, conn, metrics=self.metrics,
                no_store_reason="no store on this server (--store-dir)")
        elif tag == protocol.STORE_LIST:
            # enumerate what STORE_FETCH can serve (the manifest keys)
            remote.serve_list(
                self.store, payload, conn, metrics=self.metrics,
                no_store_reason="no store on this server (--store-dir)")
        elif tag == protocol.METRICS:
            snap = self.metrics.snapshot()
            snap["gauges"]["queue_depth"] = self.queue.depth()
            snap["gauges"]["queue_high_water"] = self.queue.high_water
            snap["build"] = _build.report()
            # this process's kernel launch counters (backend/_build.py),
            # which a caller reads before and after a job
            snap["launches"] = dict(_build.LAUNCHES)
            conn.send(protocol.OK, protocol.encode_json(snap))
        elif tag == protocol.KILL_WORKER:
            if not self.chaos:
                conn.send(protocol.ERR, protocol.encode_json(
                    {"reason": "fault injection disabled (--chaos)"}))
                return None
            req = protocol.decode_json(payload)
            try:
                victim = self.pool.kill_worker(
                    worker=req.get("worker"), job_id=req.get("job_id"),
                    at_round=req.get("at_round"))
            except LookupError as e:
                conn.send(protocol.ERR,
                          protocol.encode_json({"reason": str(e)}))
                return None
            conn.send(protocol.OK, protocol.encode_json({"worker": victim}))
        elif tag == protocol.SHUTDOWN:
            # a multi-client daemon must not die to any one client's frame;
            # opt in (self-hosted loadgen, tests) or stop it from the host
            if not self.allow_remote_shutdown:
                conn.send(protocol.ERR, protocol.encode_json(
                    {"reason": "remote shutdown disabled "
                               "(--allow-remote-shutdown)"}))
                return None
            conn.send(protocol.OK)
            return False
        else:
            conn.send(protocol.ERR,
                      protocol.encode_json({"reason": "unknown tag"}))
        return None

    def _lookup(self, conn, payload):
        job_id = protocol.decode_json(payload).get("job_id")
        job = self.get_job(job_id)
        if job is None:
            conn.send(protocol.ERR, protocol.encode_json(
                {"reason": f"unknown job {job_id!r}"}))
        return job

    # -- observability plane (--obs-port) --------------------------------------

    def merge_fleet_trace(self, job_id):
        """Splice the attached fleet's timeline into one job's trace
        artifact: the job's merged dump (pool spans and service log
        events) plus Dispatcher.collect_trace() (dispatcher and worker
        spans, dispatcher/membership/supervisor/worker log events,
        offset-corrected) become ONE trace:<job_id> artifact, the one
        artifact of an incident; the fleet's `lost_workers` rides along.
        Worker span buffers are fetch-and-forget and scoped to the
        dispatcher's tracer, so call this right after the job of interest
        finishes. Returns the merged dump (None without an attached
        fleet)."""
        if self.fleet_dispatcher is None:
            return None
        from ..trace import merge_traces
        job = self.get_job(job_id)
        base = job.trace_dump if job is not None else None
        fleet = self.fleet_dispatcher.collect_trace()
        dumps = [d for d in (base, fleet) if d]
        if not dumps:
            return None
        merged = merge_traces(dumps)
        if fleet and "lost_workers" in fleet:
            merged["lost_workers"] = fleet["lost_workers"]
        merged["logs"] = sorted(
            ((base or {}).get("logs") or [])
            + ((fleet or {}).get("logs") or []),
            key=lambda e: e.get("ts", 0))
        if job is not None and job.trace_id:
            merged["trace_id"] = job.trace_id
            # the fleet-side events were recorded under the dispatcher
            # tracer's id (one dispatcher serves many jobs); splicing them
            # into this job's artifact is the attribution, so they take
            # the job's trace id: grep one id, get the incident
            merged["logs"] = [dict(e, trace_id=job.trace_id)
                              for e in merged["logs"]]
            job.trace_dump = merged
        if self.store is not None:
            from ..store import keycache as KC
            try:
                KC.store_trace(self.store, job_id, merged)
            except Exception:  # best-effort, like the pool's _store_trace
                self.metrics.inc("store_write_errors")
        return merged

    def load_trace_merged(self, job_id):
        """The merged timeline for one job: the store artifact
        (trace:<job_id>) when present, else the finished Job's in-memory
        copy. None when the job is unknown or its trace is gone."""
        if self.store is not None:
            from ..store import keycache as KC
            merged = KC.load_trace(self.store, job_id)
            if merged is not None:
                return merged
        job = self.get_job(job_id)
        return job.trace_dump if job is not None else None


class ObsServer:
    """Pull-based observability endpoint over stdlib HTTP (one thread per
    request, read-only):

        /metrics         Prometheus text exposition (Metrics.to_prometheus:
                         counters, gauges, per-round latency summaries)
        /healthz         JSON readiness: queue depth, busy workers,
                         draining, jobs by circuit kind and state
        /logs            this process's structured-log ring (obs/log.py);
                         ?trace_id=&since_seq=&limit= filter/tail
        /trace/<job_id>  the job's merged timeline as Chrome trace-event
                         JSON (load in chrome://tracing / Perfetto);
                         ?raw=1 returns the lossless merged dump instead
        /autoscale       the attached autoscaler's state() (404 when off)
        /fleet           JSON snapshot of an attached fleet: roster with
                         per-member breaker/suspect state and each
                         member's metrics snapshot (404 without a fleet)
        /profile/<id>    one stored on-demand capture (profile:<id>:
                         a gzipped Chrome trace or pystacks JSON)
        /profile/capture?worker=N&ms=M  arm a capture on fleet worker N
                         and store it; answers its meta with "profile_id"

    With an attached fleet, /metrics also carries the labelled
    per-worker dpt_fleet_* series of the latest scrape. A separate
    listener from the proof-service wire plane: scrapers and dashboards
    must not compete with SUBMIT/RESULT frames, and plain HTTP means
    curl/Prometheus need no custom codec. Read-only except
    /profile/capture."""

    def __init__(self, service, host="127.0.0.1", port=0):
        import http.server
        svc = service

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet: metrics are the log
                pass

            def do_GET(self):
                try:
                    code, ctype, body = _obs_route(svc, self.path)
                except Exception as e:  # pragma: no cover - defensive
                    code, ctype = 500, "application/json"
                    body = protocol.encode_json({"error": repr(e)})
                svc.metrics.inc("obs_http_requests")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="obs-http", daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _query_params(query):
    import urllib.parse
    return {k: v[-1] for k, v in
            urllib.parse.parse_qs(query, keep_blank_values=True).items()}


def _obs_route(svc, path):
    """(status, content_type, body bytes) for one observability GET."""
    from ..trace import to_chrome_trace
    path, _, query = path.partition("?")
    if path == "/metrics":
        text = svc.metrics.to_prometheus(extra_gauges={
            "queue_depth": svc.queue.depth(),
            "queue_high_water": svc.queue.high_water,
        })
        if svc.fleet is not None:
            # the labelled per-worker series of the latest fleet scrape
            text += svc.fleet.render()
        return 200, "text/plain; version=0.0.4; charset=utf-8", \
            text.encode()
    if path == "/healthz":
        # per-circuit-kind job counts: what the zoo's heterogeneous
        # traffic looks like inside the service, by kind -> {state: count}
        by_kind = {}
        with svc._jobs_lock:
            for j in svc.jobs.values():
                per = by_kind.setdefault(j.spec.kind, {})
                per[j.state] = per.get(j.state, 0) + 1
        body = {
            "ok": True,
            "uptime_s": round(time.monotonic() - svc.metrics.started_at, 3),
            "queue_depth": svc.queue.depth(),
            "busy_workers": len(svc.pool.busy()),
            "draining": svc.queue.closed(),
            "jobs_by_kind": by_kind,
            "aggregates": len(svc._aggregates),
            "device": str(svc.device),
        }
        return 200, "application/json", protocol.encode_json(body)
    if path == "/autoscale":
        asc = svc.autoscaler
        if asc is None:
            return 404, "application/json", protocol.encode_json(
                {"error": "autoscaler off (ProofService.attach_autoscaler "
                          "with mode dry or 1)"})
        return 200, "application/json", protocol.encode_json(asc.state())
    if path == "/fleet":
        if svc.fleet is None:
            return 404, "application/json", protocol.encode_json(
                {"error": "no fleet attached (ProofService.attach_fleet)"})
        out = svc.fleet.fleet_json(extra={
            "queue_depth": svc.queue.depth(),
            "draining": svc.queue.closed(),
        })
        return 200, "application/json", protocol.encode_json(out)
    if path == "/profile/capture":
        q = _query_params(query)
        try:
            meta = svc.profile_fleet_worker(
                worker=int(q.get("worker") or 0),
                duration_ms=int(q["ms"]) if q.get("ms") else None,
                kind=q.get("kind") or "auto")
        except (RuntimeError, ValueError, ConnectionError, OSError) as e:
            return 400, "application/json", protocol.encode_json(
                {"error": repr(e)})
        return 200, "application/json", protocol.encode_json(meta)
    if path.startswith("/profile/"):
        pid = path[len("/profile/"):]
        hit = svc.load_profile(pid)
        if hit is None:
            return 404, "application/json", protocol.encode_json(
                {"error": f"no profile {pid!r}"})
        meta, blob = hit
        ctype = "application/gzip" \
            if meta.get("format") == "torch-trace-gz" else "application/json"
        return 200, ctype, blob
    if path == "/logs":
        q = _query_params(query)
        out = olog.fetch(trace_id=q.get("trace_id") or None,
                         since_seq=int(q.get("since_seq") or 0),
                         limit=int(q["limit"]) if q.get("limit") else None)
        return 200, "application/json", protocol.encode_json(out)
    if path.startswith("/trace/"):
        job_id = path[len("/trace/"):]
        merged = svc.load_trace_merged(job_id)
        if merged is None:
            return 404, "application/json", protocol.encode_json(
                {"error": f"no trace for job {job_id!r}"})
        if "raw=1" in query:
            return 200, "application/json", protocol.encode_json(merged)
        return 200, "application/json", \
            protocol.encode_json(to_chrome_trace(merged))
    return 404, "application/json", protocol.encode_json(
        {"error": f"unknown path {path!r}",
         "endpoints": ["/metrics", "/healthz", "/fleet", "/autoscale",
                       "/logs", "/trace/<job_id>", "/profile/<id>",
                       "/profile/capture"]})
