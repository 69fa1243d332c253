"""Cross-host artifact fetch: pull store blobs from a serving peer (a copy
of the JAX package's store/remote.py; its JAX compile-cache sync becomes
`sync_kernel_build`, the pull of the kernels' packed nvcc build).

The client side of the STORE_FETCH wire tag (runtime/protocol.py): a fresh
or replacement host asks a peer that already holds an artifact (bucket
keys, a mid-prove checkpoint, a finished proof) for its bytes instead of
rebuilding them. Cold start and cross-host resume become one network copy.

Trust model: the peer is inside the deployment but the network is not
infallible: every fetched blob is re-hashed locally and compared to the
digest the peer advertised BEFORE it is written into the local store, so
a truncated or garbled transfer is a loud error, never a poisoned cache
(the local store then re-verifies on every read, as always).

Servers: the proof service answers STORE_FETCH and STORE_LIST when started
with a store (service/server.py); runtime workers answer them when
launched with --store (runtime/worker.py). The wire format is the JAX
package's, so either package's client fetches from either's server.

Warm rejoin (`warm_sync`): a worker that JOINs the fleet with a store
pulls every missing `WARM_SYNC_PREFIXES` artifact from the roster's
store-serving peers, so a replacement finds its bucket keys without a
rebuild. The kernel build (`kbuild:`, store/kernels.py) is not among
them: a worker pulls it first, on its own, through `sync_kernel_build`
(only this card's key), and its warm stats report that pull. A JAX
worker's warm_sync skips `kbuild:` keys and this one skips the JAX
package's `jaxcache:` keys: the prefixes tell them apart on the same
wire.
"""

import hashlib
import time

from ..runtime import native, protocol
from ..runtime.health import NullMetrics


class FetchError(RuntimeError):
    pass


def serve_fetch(store, payload, conn, metrics=None,
                no_store_reason="no store on this server"):
    """Answer one STORE_FETCH request on `conn`: the server side of
    `fetch_blob`, shared by the proof service frontend and runtime workers
    launched with --store so the two servers cannot skew. Advertises the
    digest the store just verified the blob against (`get_entry`) instead
    of re-hashing a possibly multi-MB blob per fetch."""
    metrics = metrics or NullMetrics()
    if store is None:
        conn.send(protocol.ERR, protocol.encode_json(
            {"reason": no_store_reason}))
        return
    key = protocol.decode_json(payload).get("key")
    hit = store.get_entry(key) if key else None
    if hit is None:
        metrics.inc("store_fetch_misses")
        conn.send(protocol.ERR, protocol.encode_json(
            {"reason": f"unknown key {key!r}"}))
        return
    blob, digest, meta = hit
    metrics.inc("store_fetch_served")
    metrics.inc("store_fetch_bytes", len(blob))
    header = {"key": key, "digest": digest, "meta": meta}
    conn.send(protocol.OK, protocol.encode_result(header, blob))


def serve_list(store, payload, conn, metrics=None,
               no_store_reason="no store on this server"):
    """Answer one STORE_LIST request: the manifest keys, filtered by the
    requested prefix (what STORE_FETCH can serve)."""
    metrics = metrics or NullMetrics()
    if store is None:
        conn.send(protocol.ERR, protocol.encode_json(
            {"reason": no_store_reason}))
        return
    prefix = protocol.decode_json(payload).get("prefix", "") or ""
    keys = [k for k in store.keys() if k.startswith(prefix)]
    metrics.inc("store_list_served")
    conn.send(protocol.OK, protocol.encode_json({"keys": sorted(keys)}))


def fetch_blob(host, port, key, timeout_ms=30000):
    """-> (meta dict, blob bytes) from the peer, digest-verified.

    Raises FetchError when the peer lacks the key or the transfer fails
    integrity (callers treat either as a miss and fall back to a build).
    """
    # bound the dial too: a partitioned (SYN-dropped) peer must cost a
    # bounded wait, not the OS connect default of minutes
    conn = native.connect(host, port, timeout_ms=timeout_ms)
    try:
        if timeout_ms:
            conn.set_timeout(timeout_ms)
        conn.send(protocol.STORE_FETCH, protocol.encode_json({"key": key}))
        rtag, rpayload = conn.recv()
    finally:
        conn.close()
    if rtag != protocol.OK:
        raise FetchError(
            f"peer {host}:{port} has no {key!r}: "
            f"{protocol.decode_json(rpayload).get('reason')}")
    header, blob = protocol.decode_result(rpayload)
    digest = hashlib.sha256(blob).hexdigest()
    if digest != header.get("digest"):
        raise FetchError(
            f"digest mismatch fetching {key!r} from {host}:{port} "
            f"({digest[:12]} != {str(header.get('digest'))[:12]})")
    return header.get("meta") or {}, blob


def fetch_into(store, host, port, key, timeout_ms=30000):
    """Fetch `key` from the peer into the local store. Returns the blob,
    or None when the peer lacks it / the transfer failed verification
    (peer fetch is an optimization tier, the build tier still exists
    below it)."""
    try:
        meta, blob = fetch_blob(host, port, key, timeout_ms=timeout_ms)
    except (FetchError, ConnectionError, OSError):
        return None
    store.put(key, blob, meta=meta)
    return blob


def list_keys(host, port, prefix="", timeout_ms=10000):
    """Peer's STORE_LIST for one prefix -> [key]. Raises FetchError when
    the peer serves no store."""
    conn = native.connect(host, port, timeout_ms=timeout_ms)
    try:
        if timeout_ms:
            conn.set_timeout(timeout_ms)
        conn.send(protocol.STORE_LIST,
                  protocol.encode_json({"prefix": prefix}))
        rtag, rpayload = conn.recv()
    finally:
        conn.close()
    if rtag != protocol.OK:
        raise FetchError(
            f"peer {host}:{port} cannot list: "
            f"{protocol.decode_json(rpayload).get('reason')}")
    return protocol.decode_json(rpayload).get("keys", [])


# artifact-key prefixes a joining worker pulls from roster peers: bucket
# keys carry the SRS and the proving/verifying keys (keycache.py layout),
# the expensive state to rebuild, and autotune plans the measured kernel
# parameters per card (store/calibration.py). Checkpoints and proofs stay
# fetch-on-demand (they are job-scoped, not shape-scoped).
WARM_SYNC_PREFIXES = ("bucket:", "autotune:")


def sync_kernel_build(store, peers, cap, timeout_ms=30000, metrics=None):
    """Pull this card's packed kernel build (store/kernels.artifact_key)
    from the first peer that lists it, through fetch_into (the blob
    re-hashed against the peer's digest before it lands in `store`), and
    install it from `store` (re-verified there). Returns whether a build
    installed (backend/_build.build_report then says `peer`, its bytes
    and install seconds); each failed fetch or refused install is
    counted as kernel_build_pull_errors."""
    from . import kernels
    metrics = metrics or NullMetrics()
    key = kernels.artifact_key(cap)
    for host, port in peers:
        try:
            listed = list_keys(host, port, prefix=key, timeout_ms=timeout_ms)
        except (FetchError, ConnectionError, OSError):
            continue
        if key not in listed:
            continue
        if fetch_into(store, host, port, key, timeout_ms=timeout_ms) is None:
            metrics.inc("kernel_build_pull_errors")
            continue
        if kernels.install_from_store(store, cap, metrics=metrics,
                                      source="peer") is not None:
            return True
    return False


def warm_sync(store, peers, prefixes=WARM_SYNC_PREFIXES, timeout_ms=10000):
    """Warm-rejoin sync: pull every missing `prefixes` artifact from each
    peer in order. Per-peer and per-key failures are skipped: the sync
    speeds a rejoin up, it never gates it. Returns the stats dict
    ({warm_rejoin_s, artifacts, peers, errors}) of the JOIN phase=ready
    report."""
    t0 = time.monotonic()
    prefixes = tuple(prefixes)
    stats = {"artifacts": 0, "peers": 0, "errors": 0}
    have = set(store.keys())
    for host, port in peers:
        try:
            keys = list_keys(host, port, timeout_ms=timeout_ms)
        except (FetchError, ConnectionError, OSError):
            stats["errors"] += 1
            continue
        stats["peers"] += 1
        for key in keys:
            if key in have or not key.startswith(prefixes):
                continue
            if fetch_into(store, host, port, key,
                          timeout_ms=timeout_ms) is not None:
                have.add(key)
                stats["artifacts"] += 1
    stats["warm_rejoin_s"] = round(time.monotonic() - t0, 6)
    return stats
