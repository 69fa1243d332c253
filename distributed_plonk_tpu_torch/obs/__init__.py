"""Observability (a copy of the JAX package's obs/, its structured log
only).

    obs/log.py   structured JSONL events, trace-correlated, in a bounded
                 per-process ring; the service stores each job's events
                 beside its merged trace, and ObsServer serves the ring at
                 /logs.

Not ported: obs/fleet.py (fleet metrics over METRICS_FETCH) and
obs/profiling.py (on-demand captures over PROFILE); the ring is not
served over LOG_FETCH either.
"""

from . import log  # noqa: F401

__all__ = ["log"]
