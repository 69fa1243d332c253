"""Minimal span tracer for the prover: wall-clock seconds per named span.

The prover opens one span per round (`round1` .. `round5`) and one per
kernel batch inside it. `NULL_TRACER` records nothing; a `Tracer` keeps
the durations, which chip_smoke.py prints as the per-round times. Spans
that cover device work should end in a synchronize to mean device time;
the rounds do, because each one hands its commitments to the host.
"""

import time
from contextlib import contextmanager


class Tracer:
    def __init__(self):
        self.spans = []          # (name, depth, seconds), in closing order
        self._depth = 0

    @contextmanager
    def span(self, name, **attrs):
        t0 = time.perf_counter()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self.spans.append((name, self._depth,
                               time.perf_counter() - t0))

    def totals(self, depth=0):
        """name -> summed seconds over the spans at `depth`."""
        out = {}
        for name, d, s in self.spans:
            if d == depth:
                out[name] = out.get(name, 0.0) + s
        return out


class _NullTracer:
    @contextmanager
    def span(self, name, **attrs):
        yield


NULL_TRACER = _NullTracer()
