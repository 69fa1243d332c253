"""Structured logging: JSON events, trace-correlated, ring-buffered (a copy
of the JAX package's obs/log.py).

Every noteworthy serving-plane decision (a shed verdict, a retry, a
self-verify block, a drain) is recorded as ONE structured event

    {"ts": <wall s>, "seq": n, "level": "warn", "subsystem": "service",
     "event": "retry", "proc": "...", "pid": ...,
     "trace_id": ..., "job_id": ..., <fields>}

into a bounded per-process ring buffer. The service pool merges a job's
trace-filtered events into its `trace:<job_id>` timeline artifact, and
ObsServer serves the ring at /logs. A process that owns its own lifetime
can tee every event to a JSONL file sink (`configure(log_dir=...)`).

Subsystems the port emits (the static verifier's LOG01 lint holds every
`emit("subsystem", ...)` literal to this list; the name column ends at the
first run of two or more spaces):

    dispatcher   fleet client decisions: quarantines, MSM range
                 adoptions, FFT replans and degradations, re-admissions
    membership   roster changes: joins, rejoins, leaves, challenge
                 verdicts, roster pushes that failed
    supervisor   worker-process lifecycle: respawns, wedge kills,
                 flap-cap giveups
    integrity    result-integrity verdicts: failed phase checks,
                 duplicate-execution mismatches, challenge outcomes
    autoscale    closed-loop controller decisions: scale verdicts, lease
                 resizes, sensor and actuator errors
    store        artifact-store events: kernel builds published, pulled
                 or refused
    service      serving-plane verdicts: shed/rejected jobs, retries,
                 self-verify blocks, drain outcomes
    aggregate    batch-KZG aggregation verdicts: aggregates built
                 (members, kinds, build_s)
    worker       fleet-worker events: joins, warm rejoins, injected
                 silent data corruption, profiles captured, calibration
                 pickups
    obs          the observability plane itself: profiles stored

Levels: debug < info < warn < error (no filtering on record: the ring is
small and the consumer filters; the file sink takes a minimum level).
"""

import json
import os
import threading
import time
from collections import deque

_LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3}

# ring capacity per process (events, not bytes)
CAP = 512


class LogBuffer:
    """Bounded ring of structured events + optional JSONL file sink.

    Thread-safe; `seq` is a monotonically increasing per-process event
    number (fetchers use it for tail-f semantics and to detect drops:
    `seq - len(events)` events have scrolled out of the ring)."""

    def __init__(self, cap=None, proc=None):
        self.cap = cap or CAP
        self.proc = proc or "main"
        self._lock = threading.Lock()
        self._ring = deque(maxlen=self.cap)
        self.seq = 0
        self._file = None
        self._file_level = _LEVELS["debug"]
        self.metrics = None  # duck-typed Metrics; set via set_metrics

    # -- configuration --------------------------------------------------------

    def set_metrics(self, metrics):
        """Publish log_events/log_dropped counters into a registry."""
        with self._lock:
            self.metrics = metrics

    def open_sink(self, log_dir, proc=None, level="debug"):
        """Tee every event (at or above `level`) to
        <log_dir>/<proc>-<pid>.jsonl: line-buffered append, one JSON
        object per line. Never raises: a broken sink only loses the file
        copy, the ring keeps serving."""
        if proc:
            self.proc = proc
        try:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir,
                                f"{self.proc.replace('/', '_')}-"
                                f"{os.getpid()}.jsonl")
            f = open(path, "a", buffering=1)
        except OSError:
            return None
        with self._lock:
            self._file = f
            self._file_level = _LEVELS.get(level, 0)
        return path

    # -- record / read --------------------------------------------------------

    def emit(self, subsystem, event, level="info", trace_id=None,
             job_id=None, worker=None, **fields):
        """Record one structured event; returns its seq number."""
        ev = {"ts": round(time.time(), 6), "level": level,
              "subsystem": subsystem, "event": event, "proc": self.proc,
              "pid": os.getpid()}
        if trace_id is not None:
            ev["trace_id"] = trace_id
        if job_id is not None:
            ev["job_id"] = job_id
        if worker is not None:
            ev["worker"] = worker
        for k, v in fields.items():
            if v is not None:
                ev[k] = v
        with self._lock:
            self.seq += 1
            ev["seq"] = self.seq
            if len(self._ring) == self.cap and self.metrics is not None:
                self.metrics.inc("log_dropped")
            self._ring.append(ev)
            f = self._file if _LEVELS.get(level, 0) >= self._file_level \
                else None
            if f is not None:
                try:
                    f.write(json.dumps(ev, separators=(",", ":")) + "\n")
                except (OSError, ValueError):
                    self._file = None  # dead sink: ring keeps serving
        if self.metrics is not None:
            self.metrics.inc("log_events")
        return ev["seq"]

    def fetch(self, trace_id=None, since_seq=0, limit=None):
        """{"events": [...], "seq": latest}: the ring's current contents
        (oldest first), optionally filtered to one trace id and/or to
        events after `since_seq`. Reads never clear the ring."""
        with self._lock:
            events = list(self._ring)
            seq = self.seq
        if since_seq:
            events = [e for e in events if e["seq"] > since_seq]
        if trace_id is not None:
            events = [e for e in events if e.get("trace_id") == trace_id]
        if limit is not None:
            events = events[-int(limit):]
        return {"events": events, "seq": seq}


# -- per-process default buffer ------------------------------------------------
# One ring per process: the service and everything it embeds log into it.

_BUFFER = LogBuffer()


def emit(subsystem, event, **kw):
    """Module-level shorthand: obs.log.emit("service", "retry",
    level="warn", job_id=..., reason=...)."""
    return _BUFFER.emit(subsystem, event, **kw)


def buffer():
    """This process's ring (its `seq` counts the events recorded)."""
    return _BUFFER


def fetch(trace_id=None, since_seq=0, limit=None):
    return _BUFFER.fetch(trace_id=trace_id, since_seq=since_seq,
                         limit=limit)


def set_metrics(metrics):
    _BUFFER.set_metrics(metrics)


def configure(log_dir=None, proc=None, metrics=None, level="debug"):
    """Process-level setup (the service entry point): name the process,
    open the file sink, attach a metrics registry. Returns the sink path
    (or None)."""
    if proc:
        _BUFFER.proc = proc
    if metrics is not None:
        _BUFFER.set_metrics(metrics)
    if log_dir:
        return _BUFFER.open_sink(log_dir, proc=proc, level=level)
    return None
