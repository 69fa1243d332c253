"""Fleet observability plane (a copy of the JAX package's obs/):

    obs/log.py        structured JSONL events, trace-correlated, in a
                      bounded per-process ring; the service stores each
                      job's events beside its merged trace, ObsServer
                      serves the ring at /logs, a worker over LOG_FETCH.
    obs/fleet.py      fleet metrics: scrape every worker's Metrics
                      snapshot over METRICS_FETCH (breaker- and
                      suspect-aware), render dpt_fleet_* Prometheus series
                      with per-worker labels, and build the /fleet JSON.
    obs/profiling.py  on-demand captures behind the PROFILE wire tag:
                      torch.profiler on a card (a gzipped Chrome trace),
                      an all-thread Python stack sampler otherwise; the
                      service stores them as profile:<id> artifacts served
                      at /profile/<id>.

The wire tags are the JAX package's: either package's dispatcher scrapes
either package's workers, and a worker that predates a tag answers ERR,
which the caller degrades to an empty result.
"""

from . import fleet, log, profiling  # noqa: F401

__all__ = ["log", "fleet", "profiling"]
