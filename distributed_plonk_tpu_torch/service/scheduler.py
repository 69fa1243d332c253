"""Batching scheduler: shape buckets with shared keys, pool dispatch (a
copy of the JAX package's service/scheduler.py; keys build on the
service's device).

Jobs whose specs have the same shape key (jobs.shape_key) are structurally
identical circuits — same domain, same selectors, same wiring — so they
can share one SRS + proving/verifying key. The scheduler exploits that two
ways:

1. BucketCache resolves (srs, pk, vk) ONCE per shape, on first demand,
   through three tiers — bounded in-memory LRU, on-disk artifact store
   (persists across restarts), full build — and every later job in the
   bucket skips key setup entirely (at small domains key setup costs more
   than the prove itself — the cache is the difference between O(jobs)
   and O(shapes) setups, and the disk tier makes that hold across
   process lifetimes).
2. JobQueue.pop_batch hands the scheduler the best job plus every queued
   compatible job, and the whole batch is dispatched against one
   resources object — so a burst of same-shape traffic touches the cache
   lock once and lands on the pool back-to-back (maximum key/stage reuse
   in the workers).

The scheduler is one thread: admission (queue) and execution (pool) are
concurrent around it, and pool dispatch blocking is the backpressure that
keeps scheduling from racing ahead of proving capacity.
"""

import itertools
import threading
import time
from collections import OrderedDict

from . import jobs as J
from ..store import keycache as KC

_batch_seq = itertools.count(1)


class BucketResources:
    """Everything a worker needs to prove any job of one shape."""

    def __init__(self, shape_key, srs, pk, vk, domain_size, build_s):
        self.shape_key = shape_key
        self.srs = srs
        self.pk = pk
        self.vk = vk
        self.domain_size = domain_size
        self.build_s = build_s


class _KeyLatch:
    """One shape's in-flight load/build: later callers of the same shape
    wait on `done` instead of re-running the setup; callers of OTHER
    shapes never see it at all (the cache lock is held only for map
    bookkeeping, never across the load/fetch/build work)."""

    def __init__(self):
        self.done = threading.Event()
        self.res = None
        self.source = None
        self.error = None


class BucketCache:
    """Three-tier shape-bucket key cache: memory -> disk -> build.

    Tier 1 is a BOUNDED in-memory LRU (`max_entries`: at 2^18-domain
    shapes one resident bucket is hundreds of MB of SRS+pk, so a
    long-lived daemon serving many shapes needs the cap). Tier 2 is the
    on-disk ArtifactStore (`store`), where keys persist across process
    restarts and are shared with warmup jobs; integrity failures there
    self-heal (the corrupt entry is deleted and the build tier
    repopulates it). Tier 3 is `jobs.build_bucket_keys` on `device` (None:
    the card).

    Concurrency: the load/peer-fetch/build tiers run OUTSIDE the cache
    lock behind a per-key latch. Concurrent first-touch of one shape
    still does exactly one setup (waiters block on that shape's latch),
    and a cold miss against an unreachable peer never stalls other
    shapes' lookups for PEER_TIMEOUT_MS per peer.

    Metrics: bucket_hits (memory), bucket_disk_hits, bucket_misses
    (full build), bucket_latch_waits (blocked on another caller's
    in-flight setup of the same shape), bucket_mem_evictions, plus the
    store's own store_* counters/gauges.
    """

    def __init__(self, metrics, device=None, store=None, max_entries=None,
                 peers=None):
        self.metrics = metrics
        self.device = device
        self.store = store
        # peers: [(host, port)] speaking STORE_FETCH: tier 2.5, between
        # local disk and full build: a fresh host pulls a warm peer's key
        # blob (digest-verified network copy) instead of re-running
        # trusted setup + preprocess (cold start for a scaled-out replica
        # is one fetch)
        self.peers = list(peers or [])
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._buckets = OrderedDict()
        self._latches = {}

    def add_peer(self, host, port):
        """Register one STORE_FETCH peer at runtime (idempotent): the
        membership plane's discovery path, a worker that JOINs the fleet
        advertising a store becomes a key-fetch tier at once
        (ProofService.attach_membership wires this up)."""
        pair = (host, int(port))
        with self._lock:
            if pair in self.peers:
                return False
            self.peers.append(pair)
        self.metrics.inc("bucket_peers_added")
        return True

    def remove_peer(self, host, port):
        """Drop one STORE_FETCH peer (a member LEAVEd the fleet): a later
        cold miss would otherwise spend the peer timeout dialing the
        decommissioned address before the build tier."""
        pair = (host, int(port))
        with self._lock:
            if pair not in self.peers:
                return False
            self.peers.remove(pair)
        self.metrics.inc("bucket_peers_removed")
        return True

    def get(self, spec):
        """Resources for the spec's shape, loading/building on first use."""
        return self.get_with_source(spec)[0]

    def get_with_source(self, spec):
        """(resources, tier) where tier is memory|disk|built — the WARMUP
        handler reports it so operators can see what a warmup did."""
        key = J.shape_key(spec)
        with self._lock:
            res = self._buckets.get(key)
            if res is not None:
                self._buckets.move_to_end(key)
                self.metrics.inc("bucket_hits")
                return res, "memory"
            latch = self._latches.get(key)
            owner = latch is None
            if owner:
                latch = self._latches[key] = _KeyLatch()
        if not owner:
            # same shape already loading on another thread: wait on ITS
            # latch (off-lock — other shapes proceed), then share the
            # outcome. A builder failure propagates: the latch is gone,
            # so a later retry re-attempts the build fresh.
            self.metrics.inc("bucket_latch_waits")
            latch.done.wait()
            if latch.error is not None:
                raise latch.error
            return latch.res, latch.source
        try:
            res, source = self._load_or_build(spec, key)
        except BaseException as e:
            with self._lock:
                self._latches.pop(key, None)
            latch.error = e
            latch.done.set()
            raise
        with self._lock:
            self._buckets[key] = res
            self._latches.pop(key, None)
            if self.max_entries is not None \
                    and len(self._buckets) > self.max_entries:
                self._buckets.popitem(last=False)  # LRU out
                self.metrics.inc("bucket_mem_evictions")
            self.metrics.gauge("buckets_resident", len(self._buckets))
        latch.res, latch.source = res, source
        latch.done.set()
        return res, source

    def _load_or_build(self, spec, key):
        if self.store is not None:
            t0 = time.monotonic()
            hit = KC.load_bucket(self.store, key)
            if hit is None and self.peers:
                hit = self._fetch_from_peers(key)
            if hit is not None:
                srs, pk, vk, meta = hit
                self.metrics.inc("bucket_disk_hits")
                self.metrics.observe("bucket_disk_load",
                                     time.monotonic() - t0)
                return BucketResources(key, srs, pk, vk, vk.domain_size,
                                       meta.get("build_s") or 0.0), "disk"
        self.metrics.inc("bucket_misses")
        t0 = time.monotonic()
        srs, pk, vk = J.build_bucket_keys(spec, device=self.device)
        build_s = time.monotonic() - t0
        self.metrics.observe("bucket_build", build_s)
        res = BucketResources(key, srs, pk, vk, vk.domain_size, build_s)
        if self.store is not None:
            # persistence is best-effort: a full disk or unwritable store
            # must degrade to cold starts, never fail the build's jobs
            try:
                KC.store_bucket(self.store, key, srs, pk, vk,
                                build_s=build_s)
            except Exception:  # pragma: no cover - environmental
                self.metrics.inc("store_write_errors")
        return res, "built"

    # per-peer dial+transfer budget for the fetch tier (the JAX package's
    # DPT_PEER_FETCH_TIMEOUT_MS default). Peer fetch runs off-lock behind
    # the shape's own latch (so an unreachable peer only delays THAT
    # shape's first-touch callers), but the budget still bounds how long
    # a cold miss can hang on one dead peer before the build tier takes
    # over: far below fetch_into's 30 s default.
    PEER_TIMEOUT_MS = 5000

    def _fetch_from_peers(self, key):
        """Try each peer's STORE_FETCH for this bucket's key blob; a hit
        lands in the local store (so the fetch pays once) and parses
        through the normal disk-tier loader. Any per-peer failure falls
        through — the build tier is always below us."""
        from ..store import remote as RS
        store_key = KC.bucket_store_key(key)
        with self._lock:
            peers = list(self.peers)
        for host, port in peers:
            blob = RS.fetch_into(self.store, host, port, store_key,
                                 timeout_ms=self.PEER_TIMEOUT_MS)
            if blob is None:
                continue
            hit = KC.load_bucket(self.store, key)
            if hit is not None:
                self.metrics.inc("bucket_peer_hits")
                return hit
        return None


class Scheduler:
    def __init__(self, queue, pool, metrics, buckets=None, max_batch=8):
        self.queue = queue
        self.pool = pool
        self.metrics = metrics
        self.buckets = buckets or BucketCache(metrics)
        self.max_batch = max_batch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="proof-scheduler", daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self.queue.close()
        self._thread.join(timeout=10)

    def crash(self):
        """Crash simulation: stop scheduling without the join/close
        bookkeeping (the 'process' is gone, not exiting)."""
        self._stop.set()

    def _loop(self):
        while not self._stop.is_set():
            batch = self.queue.pop_batch(self.max_batch, timeout=0.25)
            self.metrics.gauge("queue_depth", self.queue.depth())
            if not batch:
                continue
            # TTL load shedding happens HERE, before the (possibly
            # expensive) key build: a job whose deadline lapsed in the
            # queue gets a journaled SHED verdict, not a worker
            live = []
            for job in batch:
                if job.expired():
                    self.pool.shed(job, "ttl expired in queue")
                else:
                    live.append(job)
            batch = live
            if not batch:
                continue
            # the scheduler is ONE thread: an unguarded exception here
            # (key build OOM on an extreme-but-valid spec, backend error)
            # would kill scheduling forever while SUBMIT keeps accepting —
            # fail the batch loudly and keep serving instead
            try:
                res = self.buckets.get(batch[0].spec)
            except Exception as e:
                self.metrics.inc("bucket_build_errors")
                for job in batch:
                    job.finish_err(f"bucket key build failed: {e!r}")
                continue
            batch_id = "batch-%05d" % next(_batch_seq)
            self.metrics.inc("batches_dispatched")
            self.metrics.observe("batch_size", len(batch))
            for job in batch:
                job.scheduled_at = time.monotonic()
                job.batch_id = batch_id
                job.batch_size = len(batch)
            try:
                self._place(batch, res)
            except Exception as e:  # pragma: no cover - defensive
                # a job whose placement was never stamped was never
                # handed to execution: fail it loudly instead of letting
                # it hang queued forever (stamped jobs are owned by
                # their dispatch unit — never double-finished here)
                self.metrics.inc("dispatch_errors")
                for job in batch:
                    if job.placement is None:
                        job.finish_err(f"dispatch failed: {e!r}")

    def _place(self, batch, res):
        """Hand one popped shape batch to execution. The base scheduler
        dispatches every job individually onto the pool (the pre-
        placement behavior); PlacementScheduler (service/placement.py)
        overrides this with the classify/lease/batch logic. The
        contract: `job.placement` is stamped exactly when the job is
        handed to an execution unit."""
        for job in batch:
            job.placement = "pool"  # stamped before dispatch: the worker
            # thread may read it for the trace attrs the moment it pops
            try:
                self.pool.dispatch(job, res)
            except Exception as e:  # pragma: no cover - defensive
                self.metrics.inc("dispatch_errors")
                job.finish_err(f"dispatch failed: {e!r}")
