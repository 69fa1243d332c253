"""Multi-client proving service in front of the prover and its backends (a
copy of the JAX package's service/, proving on the card):

    client --SUBMIT/STATUS/RESULT/METRICS/WARMUP--> server.ProofService
        -> queue.JobQueue          (priority, admission control, backpressure)
        -> placement.PlacementScheduler
                                   (shape buckets: shared SRS/pk per bucket,
                                    BucketCache tiers memory -> disk -> build
                                    over the ../store artifact store, keys
                                    built on the card; then the PLACEMENT
                                    decision: small jobs prove data-parallel
                                    through prove_many, big jobs shard over
                                    a leased submesh (MeshBackend), mid
                                    sizes take the per-job pool)
        -> pool.WorkerPool         (TorchBackend workers; per-job timeout,
                                    bounded retry, resume-from-checkpoint on
                                    worker death, verify-before-serve)
        -> journal.JobJournal      (write-ahead job journal: restart recovery)
        -> metrics.Metrics         (counters + latency histograms, JSON)
        -> autoscale.Autoscaler    (closed loop: queue and fleet sensors
                                    drive a WorkerSupervisor, the lease
                                    capacity and pressure sheds)

The wire control plane rides runtime/protocol.py's framed transport, with
the JAX package's tags and payloads. Entry point: `python -m
distributed_plonk_tpu_torch.service` (the counterpart of the JAX package's
scripts/serve.py).
"""

from .jobs import Job, JobSpec, build_circuit, build_bucket_keys, shape_key
from .journal import JobJournal
from .queue import JobQueue, Rejected
from .metrics import Metrics
from .placement import PlacementScheduler, SubmeshLeaser
from .pool import WorkerPool, WorkerKilled, JobTimeout, WorkerDrained
from .scheduler import BucketCache, Scheduler
from .server import ObsServer, ProofService
from .client import ServiceClient

__all__ = [
    "Job", "JobSpec", "build_circuit", "build_bucket_keys", "shape_key",
    "JobJournal", "JobQueue", "Rejected", "Metrics", "WorkerPool",
    "WorkerKilled", "JobTimeout", "WorkerDrained", "BucketCache",
    "Scheduler", "PlacementScheduler", "SubmeshLeaser", "ProofService",
    "ObsServer", "ServiceClient",
]
