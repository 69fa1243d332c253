"""Fleet liveness tracking: per-worker circuit breaker + probe backoff.

The dispatcher-side health model the reference never had (every worker RPC
there is an `.unwrap()`, reference src/worker.rs:303 — one crash
panics the prove). Here each worker carries a tiny state machine:

    CLOSED   healthy: requests route to it normally.
    OPEN     dead: `BREAKER_K` CONSECUTIVE call failures opened the
             breaker; requests fast-fail (`usable()` is False) so callers
             adopt its ranges instead of burning reconnect timeouts.
    half-open (implicit): once `next_probe` passes, exactly ONE caller per
             window gets `probe_due()` True and sends a cheap HEALTH
             probe on a fresh connection; success re-admits (CLOSED),
             failure pushes `next_probe` out exponentially (with jitter).
    SUSPECT  quarantined (runtime/integrity.py attributed a WRONG answer
             to it): breaker open AND sticky — a suspect worker answers
             probes perfectly well (it is alive; its answers are wrong),
             so `record_ok` does NOT re-admit it. The only way back is a
             fresh JOIN that passes the known-answer challenge
             (runtime/membership.py, `clear_suspect`).

The table grows with the fleet (`add_worker`: a membership JOIN appends a
worker; indices are stable, so growth is append-only).

All mutable state lives in per-worker dicts guarded by `self._lock`. The
tracker never talks to the network itself: callers report outcomes via
`record_ok`/`record_failure` and run the probes it schedules.
"""

import random
import threading
import time

# consecutive failures that open the breaker; first re-admission probe
# delay and its backoff ceiling (seconds)
BREAKER_K = 3
PROBE_BASE_S = 0.2
PROBE_MAX_S = 5.0


class NullMetrics:
    """No-op stand-in for a duck-typed metrics registry (inc, gauge,
    observe) — the one shared null object for every layer that takes an
    optional registry (tracker, dispatcher, integrity plane)."""

    def inc(self, name, by=1):
        pass

    def gauge(self, name, value):
        pass

    def observe(self, name, seconds):
        pass


class LivenessTracker:
    """Per-worker consecutive-failure circuit breaker with probe backoff."""

    def __init__(self, n_workers, metrics=None, breaker_k=BREAKER_K,
                 probe_base_s=PROBE_BASE_S, probe_max_s=PROBE_MAX_S):
        """breaker_k consecutive failures open a worker's breaker; its
        re-admission probes back off from probe_base_s, doubling up to
        probe_max_s (the JAX package's DPT_BREAKER_K / DPT_PROBE_*_MS
        defaults)."""
        self.breaker_k = breaker_k
        self.probe_base_s = probe_base_s
        self.probe_max_s = probe_max_s
        self.metrics = metrics or NullMetrics()
        self._rng = random.Random()
        self._lock = threading.Lock()
        self._state = [self._fresh() for _ in range(n_workers)]

    @staticmethod
    def _fresh():
        return {"open": False, "failures": 0, "next_probe": 0.0,
                "probe_backoff": 0.0, "suspect": False}

    def add_worker(self):
        """Grow the table by one (a membership JOIN); returns the new
        worker's index."""
        with self._lock:
            self._state.append(self._fresh())
            return len(self._state) - 1

    def _jitter(self, base):
        """base + up to 50% random jitter: fleet-wide probes/retries must
        not synchronize into thundering herds."""
        return base * (1.0 + 0.5 * self._rng.random())

    # -- outcome reporting ----------------------------------------------------

    def record_ok(self, i):
        """A successful call: reset failures; re-admit if OPEN (the call
        doubled as a successful probe). A SUSPECT worker is NOT
        re-admitted: it is alive and answering — its answers are wrong
        (the whole point of quarantine)."""
        with self._lock:
            s = self._state[i]
            if s["suspect"]:
                return False
            readmitted = s["open"]
            s["open"] = False
            s["failures"] = 0
            s["probe_backoff"] = 0.0
        if readmitted:
            self.metrics.inc("fleet_readmissions")
        return readmitted

    def _open_locked(self, s, now):
        """Open s's breaker now (self._lock held); True when it was
        closed."""
        opened = not s["open"]
        s["open"] = True
        s["failures"] = max(s["failures"], self.breaker_k)
        if opened:
            s["probe_backoff"] = self.probe_base_s
            s["next_probe"] = now + self._jitter(s["probe_backoff"])
        return opened

    def mark_suspect(self, i):
        """Quarantine verdict from the integrity plane: breaker opened
        and made STICKY. Returns True when this call flipped it."""
        now = time.monotonic()
        with self._lock:
            s = self._state[i]
            flipped = not s["suspect"]
            s["suspect"] = True
            self._open_locked(s, now)
        if flipped:
            self.metrics.inc("workers_quarantined")
        return flipped

    def clear_suspect(self, i):
        """Absolution (a fresh JOIN passed the known-answer challenge):
        drop the sticky flag and close the breaker."""
        with self._lock:
            s = self._state[i]
            s["suspect"] = False
            s["open"] = False
            s["failures"] = 0
            s["probe_backoff"] = 0.0

    def is_suspect(self, i):
        with self._lock:
            return self._state[i]["suspect"]

    def record_failure(self, i):
        """A failed call (reconnect retries exhausted). Returns True when
        this failure OPENED the breaker."""
        now = time.monotonic()
        with self._lock:
            s = self._state[i]
            s["failures"] += 1
            opened = not s["open"] and s["failures"] >= self.breaker_k
            if opened:
                s["open"] = True
            if s["open"]:
                # failure while open (probe failed): back off the next probe
                s["probe_backoff"] = min(
                    self.probe_max_s, (s["probe_backoff"] * 2) or self.probe_base_s)
                s["next_probe"] = now + self._jitter(s["probe_backoff"])
        if opened:
            self.metrics.inc("fleet_breaker_opens")
        return opened

    def mark_dead(self, i):
        """Authoritative death report (a direct probe just failed): open
        the breaker immediately, regardless of the consecutive count."""
        with self._lock:
            opened = self._open_locked(self._state[i], time.monotonic())
        if opened:
            self.metrics.inc("fleet_breaker_opens")
        return opened

    # -- routing decisions ----------------------------------------------------

    def usable(self, i):
        with self._lock:
            return not self._state[i]["open"]

    def usable_set(self):
        with self._lock:
            return [i for i, s in enumerate(self._state) if not s["open"]]

    def probe_due(self, i):
        """True at most once per probe window: the caller that gets True
        owns the half-open probe; the window is immediately pushed out —
        by the CURRENT backoff, since record_failure owns the exponential
        advance — so concurrent callers don't dogpile a maybe-recovering
        worker."""
        now = time.monotonic()
        with self._lock:
            s = self._state[i]
            # suspects never get half-open probes: they answer probes
            # fine (alive, wrong), so probing can only waste a window
            if not s["open"] or s["suspect"] or now < s["next_probe"]:
                return False
            s["next_probe"] = now + self._jitter(
                s["probe_backoff"] or self.probe_base_s)
            return True

    def due_probes(self):
        return [i for i in range(len(self._state)) if self.probe_due(i)]

    def force_probe(self, i=None):
        """Make the next probe_due() True immediately (tests, an operator
        'I restarted it, re-admit now' path)."""
        with self._lock:
            for s in (self._state if i is None else [self._state[i]]):
                s["next_probe"] = 0.0

    def snapshot(self):
        with self._lock:
            return [dict(s) for s in self._state]
