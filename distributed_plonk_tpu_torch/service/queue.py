"""Priority job queue with admission control and bounded backpressure (a
copy of the JAX package's service/queue.py).

Admission is decided AT SUBMIT TIME, synchronously, so a client always
learns immediately whether its job is queued or why not (`Rejected.reason`)
— the queue never grows past `max_depth` and never silently drops work.
Ordering is (SLO class, priority, FIFO): flagship pops before standard
before batch (jobs.SLO_RANK), higher numeric `priority` wins within a
class, and stable sequence numbers keep FIFO among equals (no
starvation). Jobs without a class rank as `standard`, so an all-standard
stream — every pre-class caller — sorts exactly as the old
(priority, seq) key did.

`pop_batch` is the scheduler's accessor: it returns the best job AND every
other queued job sharing its shape key (up to `max_batch`), so one bucket's
SRS/proving key build is amortized over the whole compatible batch.

`steal_lowest` is the pressure valve: admission (a full queue refusing a
higher-class job) evicts the WORST queued job of a strictly lower class
through it (shed-lowest-class-first); per-class TTL defaults
(jobs.CLASS_TTL_S, resolved by jobs.Job at submit) do the slow-path
equivalent for jobs nobody pops in time.
"""

import threading


class Rejected(Exception):
    """Admission control said no. `reason` is client-presentable."""

    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


class JobQueue:
    def __init__(self, max_depth=64):
        self.max_depth = max_depth
        self._items = []            # [(sort_key, job)], kept sorted on pop
        self._seq = 0
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False
        self.high_water = 0

    def depth(self):
        with self._lock:
            return len(self._items)

    def depth_by_class(self):
        """{slo_class: queued count}: the autoscaler's class-mix sensor.
        Classless jobs count as standard."""
        with self._lock:
            out = {}
            for _key, job in self._items:
                cls = getattr(job, "slo", "standard")
                out[cls] = out.get(cls, 0) + 1
            return out

    def submit(self, job, force=False):
        """Enqueue or raise Rejected (queue_full | draining). force=True
        bypasses the depth cap — journal recovery re-enqueues every job
        the previous process had already admitted; bouncing them against
        this process's depth limit would turn a restart into data loss."""
        with self._lock:
            if self._closed:
                raise Rejected("draining")
            if not force and len(self._items) >= self.max_depth:
                raise Rejected("queue_full")
            self._seq += 1
            # higher SLO class first, then higher priority, then FIFO;
            # classless jobs rank standard, which keeps an all-standard
            # stream's order identical to the historical (priority, seq)
            self._items.append(((-getattr(job, "slo_rank", 1),
                                 -job.priority, self._seq), job))
            self.high_water = max(self.high_water, len(self._items))
            self._nonempty.notify()

    def pop_batch(self, max_batch=1, timeout=None):
        """Remove and return up to `max_batch` jobs sharing the shape key
        of the current best (highest-priority, oldest) job. Returns [] on
        timeout or when closed and empty."""
        with self._lock:
            while not self._items:
                if self._closed or not self._nonempty.wait(timeout):
                    return []
            self._items.sort(key=lambda kv: kv[0])
            head_key = self._items[0][1].shape_key
            batch, rest = [], []
            for kv in self._items:
                if len(batch) < max_batch and kv[1].shape_key == head_key:
                    batch.append(kv[1])
                else:
                    rest.append(kv)
            self._items = rest
            return batch

    def steal_lowest(self, below_rank):
        """Remove and return the WORST queued job of SLO rank strictly
        below `below_rank` (lowest class, then lowest priority, then
        newest), or None when nothing qualifies. Shed-lowest-class-first:
        the caller owns the returned job's terminal SHED verdict
        (pool.shed journals it) — the queue only picks the victim. With
        `below_rank` <= the lowest queued rank this is a no-op, so a
        classless deployment can never preempt anything."""
        with self._lock:
            worst = None
            for i, (key, job) in enumerate(self._items):
                if getattr(job, "slo_rank", 1) >= below_rank:
                    continue
                # sort keys order best-first, so the largest key is the
                # worst victim candidate
                if worst is None or key > self._items[worst][0]:
                    worst = i
            if worst is None:
                return None
            return self._items.pop(worst)[1]

    def closed(self):
        """True once close() ran (draining) — /healthz reports it."""
        with self._lock:
            return self._closed

    def close(self):
        """Stop admitting; wake any blocked pop."""
        with self._lock:
            self._closed = True
            self._nonempty.notify_all()
