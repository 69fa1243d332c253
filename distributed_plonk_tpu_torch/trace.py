"""Minimal span tracer for the prover: wall-clock seconds per named span.

The prover opens one span per round (`round1` .. `round5`) and one per
kernel batch inside it. `NULL_TRACER` records nothing; a `Tracer` keeps
the durations, which chip_smoke.py prints as the per-round times. Spans
that cover device work should end in a synchronize to mean device time;
the rounds do, because each one hands its commitments to the host.

One tracer may serve a pipelined prove, whose launch halves run on a
worker thread: the nesting depth is kept per thread. `add_event` records
a span of a duration measured elsewhere (a dispatched kernel batch forced
later, a batched round shared by several members).
"""

import threading
import time
from contextlib import contextmanager


class Tracer:
    def __init__(self):
        self.spans = []          # (name, depth, seconds), in closing order
        self._tls = threading.local()
        self._lock = threading.Lock()

    def _depth(self):
        return getattr(self._tls, "depth", 0)

    @contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        depth = self._depth()
        self._tls.depth = depth + 1
        try:
            yield
        finally:
            self._tls.depth = depth
            with self._lock:
                self.spans.append((name, depth, time.perf_counter() - t0))

    def add_event(self, name, dur_s):
        """A span of dur_s seconds at the calling thread's current
        depth."""
        with self._lock:
            self.spans.append((name, self._depth(), dur_s))

    def totals(self, depth=0):
        """name -> summed seconds over the spans at `depth`."""
        out = {}
        with self._lock:
            spans = list(self.spans)
        for name, d, s in spans:
            if d == depth:
                out[name] = out.get(name, 0.0) + s
        return out


class _NullTracer:
    @contextmanager
    def span(self, name):
        yield

    def add_event(self, name, dur_s):
        return None


NULL_TRACER = _NullTracer()
