"""Placement-aware scheduling: one resource pool from one card to many (a
copy of the JAX package's service/placement.py over torch devices).

The pool's single-device prover workers and `parallel/`'s sharded prove
compose here: the shape-bucket scheduler's popped batches flow through a
placement decision instead of straight onto the pool:

  classify(domain_size)
      "batch"  small jobs (domain <= SMALL_MAX, 2^14):
               N same-shape jobs prove TOGETHER, data-parallel — one
               worker runs prover.prove_many, whose round-1/3/5 commit
               MSMs and round-4 evaluations launch as single batched
               kernels across jobs (the O(1)-trace fused MSM was built
               for exactly this). Per-job transcripts/blinding stay
               independent: proof bytes are identical to N sequential
               proves.
      "mesh"   large jobs (domain >= LARGE_MIN, 2^18):
               the prove SHARDS over a leased submesh via
               parallel.MeshBackend — latency scales in shards while the
               rest of the pool keeps serving.
      "pool"   everything between: per-job worker dispatch. The pool
               layer ROUND-PIPELINES the single jobs that land on it: a
               worker that pops one coalesces the single jobs queued
               behind it up to PIPELINE_DEPTH and proves them staggered
               through prover.prove_pipelined, with the same
               byte-identity contract (pool.py _run_pipeline). A batch
               group stays one prove_many call (the port's choice: on
               the card a prove_many group of four outruns a pipeline of
               four, PERF.md).

  SubmeshLeaser
      partitions one device enumeration into disjoint leased submeshes.
      A big sharded prove leases k contiguous slots and releases them on
      completion; small batches take a 1-slot lease OPPORTUNISTICALLY
      (non-blocking: on a fully-leased host they run on the pool's own
      device rather than queueing behind the big prove). That is what
      lets concurrent small batches and one big sharded prove coexist on
      one host. Slots are POSITIONS in the enumeration, so a list that
      repeats a device (four slots of cuda:0, the port's one-card mesh)
      leases as that many slots.

The devices: every visible card (torch.cuda) by default, or the service's
own device when that is the CPU; or an explicit list (four slots of
"cuda:0" or of "cpu"). Settings (module constants at the JAX package's
defaults, read per call):
  SMALL_MAX     data-parallel ceiling (domain size, 2^14)
  LARGE_MIN     sharded-prove floor (domain size, 2^18)
A big-job submesh leases the largest power of two of slots <= half the
pool, so one flagship prove can never starve the rest.

Placement decisions land as counters (placement_batch/mesh/pool,
batch_jobs_per_launch, submesh_leases) and as span attrs on each job's
trace timeline (the pool stamps placement/batch size on the prove span).
"""

import threading
import time

import torch

from .scheduler import Scheduler

# resolved per call (module attrs), so a test lowers them without
# re-importing
SMALL_MAX = 1 << 14
LARGE_MIN = 1 << 18


def classify(domain_size):
    """Placement class for one shape bucket's evaluation-domain size."""
    if domain_size >= LARGE_MIN:
        return "mesh"
    if domain_size <= SMALL_MAX:
        return "batch"
    return "pool"


class SubmeshLease:
    """A granted, disjoint slice of the device pool: `slots` are positions
    in the leaser's enumeration, `devices` the devices at them. Release
    exactly once (the leaser tolerates double release defensively)."""

    __slots__ = ("devices", "slots", "_released")

    def __init__(self, devices, slots):
        self.devices = tuple(devices)
        self.slots = tuple(slots)
        self._released = False

    def __len__(self):
        return len(self.devices)


class SubmeshLeaser:
    """Partition one device enumeration into disjoint leased runs.

    Devices are any tokens (torch devices in production, plain ints or
    strings in tests: the leaser never touches device APIs). The leaser
    books SLOTS, positions in the enumeration, never device identity, so
    a list that repeats one device leases each repeat as its own slot.
    Contiguity: leases are CONTIGUOUS runs of the enumeration order,
    because a sharded submesh wants neighboring devices; the free list
    keeps that order so releases restore contiguity.

    Capacity (the autoscaler's batch-versus-flagship actuator): slots past
    the capacity are held in a reserve instead of the free list.
    Shrinking never revokes a granted lease, it only withholds free
    slots; a release past capacity parks its slots in the reserve until
    capacity grows again.
    """

    def __init__(self, devices):
        self._all = list(devices)
        self._free = list(range(len(self._all)))   # free slot positions
        self._capacity = len(self._all)
        self._reserved = []
        self._cond = threading.Condition()

    def total(self):
        return len(self._all)

    def capacity(self):
        with self._cond:
            return self._capacity

    def free_count(self):
        with self._cond:
            return len(self._free)

    def set_capacity(self, n):
        """Resize the leasable pool to n slots (clamped to [1, total]).
        Growing returns reserved slots to the free list at once; shrinking
        withholds FREE slots only (highest position first, so low-position
        contiguous runs survive). Returns the applied capacity."""
        with self._cond:
            self._capacity = max(1, min(int(n), len(self._all)))
            self._rebalance_locked()
            self._cond.notify_all()
            return self._capacity

    def _rebalance_locked(self):
        """Move slots between the free list and the reserve to honour the
        capacity: leased slots count against it, so free may hold up to
        capacity - leased."""
        leased = len(self._all) - len(self._free) - len(self._reserved)
        allowed_free = max(0, self._capacity - leased)
        if len(self._free) > allowed_free:
            self._free.sort()
            while len(self._free) > allowed_free:
                self._reserved.append(self._free.pop())
        elif len(self._free) < allowed_free and self._reserved:
            self._reserved.sort()
            while len(self._free) < allowed_free and self._reserved:
                self._free.append(self._reserved.pop(0))

    def _grab_locked(self, k):
        """Best contiguous run of k free slots; falls back to any k free
        slots when fragmentation leaves no contiguous run (correctness
        never depends on contiguity)."""
        order = sorted(self._free)
        for s in range(len(order) - k + 1):
            run = order[s:s + k]
            if run[-1] - run[0] == k - 1:
                break
        else:
            run = order[:k]
        for i in run:
            self._free.remove(i)
        return SubmeshLease([self._all[i] for i in run], run)

    def lease(self, k, timeout_s=None):
        """Lease k devices. timeout_s=None blocks until available;
        timeout_s=0 is the opportunistic probe (None when the pool
        cannot satisfy it right now). k is clamped to the pool size."""
        deadline = None
        with self._cond:
            k = max(1, min(k, self._capacity))
            while len(self._free) < k:
                if timeout_s is not None and timeout_s <= 0:
                    return None
                if timeout_s is not None:
                    if deadline is None:
                        deadline = time.monotonic() + timeout_s
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        if len(self._free) < k:
                            return None
                else:
                    self._cond.wait()
            return self._grab_locked(k)

    def release(self, lease):
        if lease is None:
            return
        with self._cond:
            if lease._released:
                return
            lease._released = True
            self._free.extend(lease.slots)
            self._rebalance_locked()
            self._cond.notify_all()


def _default_devices(device):
    """The device enumeration for a service on `device`: every visible
    card for a card, the one device otherwise (a CPU service)."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _default_mesh_backend_factory(devices):
    """Leased devices -> a MeshBackend sharding over exactly them."""
    from ..parallel.mesh import make_submesh
    from ..parallel.mesh_backend import MeshBackend
    return MeshBackend(make_submesh(devices))


class PlacementScheduler(Scheduler):
    """The placement layer: Scheduler whose `_place` routes each popped
    shape batch by size class instead of per-job pool dispatch.

    devices / mesh_backend_factory are injection points (tests lease
    fake device tokens and prove "mesh" jobs on a stub backend); by
    default devices enumerate from `device` (every card, or the CPU) on
    the first placement that needs a lease, and mesh backends shard over
    parallel.make_submesh of the leased devices. Mesh backends are
    cached per leased slot tuple, so a repeat lease of the same slice
    reuses its plans and keys."""

    def __init__(self, queue, pool, metrics, buckets=None, max_batch=8,
                 devices=None, mesh_backend_factory=None, device="cuda"):
        super().__init__(queue, pool, metrics, buckets=buckets,
                         max_batch=max_batch)
        self._devices = devices
        self._device = device
        self._mesh_backend_factory = (mesh_backend_factory
                                      or _default_mesh_backend_factory)
        self._leaser = None
        self._leaser_lock = threading.Lock()
        self._mesh_backends = {}

    # -- resources -----------------------------------------------------------

    def leaser(self):
        with self._leaser_lock:
            if self._leaser is None:
                devs = self._devices
                if devs is None:
                    devs = _default_devices(self._device)
                self._leaser = SubmeshLeaser(devs)
            return self._leaser

    def _leaser_if_ready(self):
        """The leaser WITHOUT triggering device enumeration: batch
        placements only participate in lease bookkeeping once devices
        are known (injected, or a mesh placement enumerated them)."""
        with self._leaser_lock:
            if self._leaser is None and self._devices is not None:
                self._leaser = SubmeshLeaser(self._devices)
            return self._leaser

    def _mesh_lease_size(self):
        total = self.leaser().total()
        if total <= 1:
            return 1
        # largest power of two <= half the pool — one flagship
        # prove shards wide but can never starve the small-job classes
        return 1 << max(0, (total // 2).bit_length() - 1)

    # bound the per-slot-subset backend cache: the leaser's
    # fragmentation fallback can mint many distinct subsets over a long
    # run, and each MeshBackend pins plans + device key contexts: an
    # uncapped map is a device-memory leak (TorchBackend._CACHE_CAP's
    # rationale)
    _MESH_BACKEND_CAP = 4

    def _mesh_backend(self, lease):
        key = tuple(sorted(lease.slots))
        backend = self._mesh_backends.get(key)
        if backend is None:
            if len(self._mesh_backends) >= self._MESH_BACKEND_CAP:
                self._mesh_backends.pop(next(iter(self._mesh_backends)))
            backend = self._mesh_backends[key] = \
                self._mesh_backend_factory(list(lease.devices))
        return backend

    def _release_fn(self, leaser):
        """Release callback that keeps the submesh_devices_free gauge
        honest on BOTH edges (a grant-only gauge reads the low-water
        mark forever on an idle host)."""
        def release(lease):
            leaser.release(lease)
            self.metrics.gauge("submesh_devices_free", leaser.free_count())
        return release

    # -- the placement decision ----------------------------------------------

    def _place(self, batch, res):
        placement = classify(res.domain_size)
        if placement == "batch" and len(batch) < 2:
            placement = "pool"  # nothing to batch
        self.metrics.inc(f"placement_{placement}")

        if placement == "mesh":
            # one sharded prove per job, each on its own leased submesh.
            # The lease blocks like pool dispatch does (backpressure):
            # devices free up when an earlier sharded prove finishes.
            leaser = self.leaser()
            for job in batch:
                lease = leaser.lease(self._mesh_lease_size())
                self.metrics.inc("submesh_leases")
                self.metrics.gauge("submesh_devices_free",
                                   leaser.free_count())
                job.placement = "mesh"
                try:
                    self.pool.dispatch_group(
                        [job], res, backend=self._mesh_backend(lease),
                        lease=lease, release=self._release_fn(leaser))
                except Exception as e:  # mesh-backend build/dispatch
                    leaser.release(lease)
                    self.metrics.inc("dispatch_errors")
                    job.finish_err(f"mesh dispatch failed: {e!r}")
            return

        if placement == "batch":
            # data-parallel cross-job prove on one worker. The slot
            # lease is opportunistic: hold a slot when one is free (so
            # the leaser's book shows batches and big proves dividing
            # the host), but never queue small jobs behind a flagship
            # prove: a fully-leased host runs the batch on the pool's
            # own device anyway. A leaser only exists once devices are
            # known (injected or mesh-enumerated).
            leaser = self._leaser_if_ready()
            lease = leaser.lease(1, timeout_s=0) if leaser else None
            if lease is not None:
                self.metrics.inc("submesh_leases")
                self.metrics.gauge("submesh_devices_free",
                                   leaser.free_count())
            for job in batch:
                job.placement = "batch"
            try:
                self.pool.dispatch_group(
                    batch, res, lease=lease,
                    release=self._release_fn(leaser) if leaser else None)
            except Exception as e:  # stamped jobs are OURS to terminate:
                # the scheduler's outer handler skips stamped jobs, so an
                # orphaned batch would hang queued forever
                if leaser is not None:
                    leaser.release(lease)
                self.metrics.inc("dispatch_errors")
                for job in batch:
                    job.finish_err(f"batch dispatch failed: {e!r}")
            return

        for job in batch:
            job.placement = "pool"
            self.pool.dispatch(job, res)
