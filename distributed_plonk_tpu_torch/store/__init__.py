"""Artifact store + warm start: the persistence layer under the service (a
copy of the JAX package's store/, with the same blob formats):

    artifacts.py    content-addressed on-disk store: SHA-256 integrity,
                    atomic writes, versioned manifest, LRU byte budget
    keycache.py     SRS/proving-key/verifying-key <-> blob serialization
                    (the JAX package's bytes), plus finished-proof, trace,
                    aggregate and profile artifacts
    remote.py       STORE_FETCH / STORE_LIST: pull blobs from a peer
                    (digest-verified) and serve them; warm_sync of the
                    `bucket:` and `autotune:` artifacts; sync_kernel_build
    warmstart.py    shape warmup: keys through the tiers, prover stages
                    through TorchBackend.warm_stages, the kernel build
                    published with --aot
    calibration.py  kernel plans (backend/autotune.py) per card under
                    `autotune:<fingerprint>`; load_or_run at start-up
    kernels.py      the kernels' nvcc build as `kbuild:<hash>:sm_<cc>`
                    (the counterpart of the JAX compile cache under the
                    store): publish, install_from_store, ensure_build

Consumers: service.scheduler.BucketCache (memory -> disk -> build tiers),
the WARMUP and STORE_FETCH wire tags (service/server.py), the port's
fleet worker with --store (runtime/worker.py), checkpoint.StoreCheckpoint.
"""

from .artifacts import ArtifactStore
from .keycache import (bucket_store_key, serialize_bucket,
                       deserialize_bucket, store_bucket, load_bucket,
                       proof_store_key, store_proof, load_proof,
                       trace_store_key, store_trace, load_trace,
                       aggregate_store_key, store_aggregate, load_aggregate)
from .warmstart import aot_warmup, warm_spec
from .remote import FetchError, fetch_blob, fetch_into, list_keys

__all__ = [
    "ArtifactStore", "bucket_store_key", "serialize_bucket",
    "deserialize_bucket", "store_bucket", "load_bucket", "proof_store_key",
    "store_proof", "load_proof", "trace_store_key", "store_trace",
    "load_trace", "aggregate_store_key", "store_aggregate",
    "load_aggregate", "aot_warmup", "warm_spec", "FetchError",
    "fetch_blob", "fetch_into", "list_keys",
]
