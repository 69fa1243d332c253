"""The kernels' nvcc build as a store artifact (the port's counterpart of
the JAX package's compile cache under the store: its `jax_cache_*`
methods, `configure_jax_cache` and `sync_jax_cache`).

A worker or service that starts on a host without this tree's built
kernels would run nvcc for minutes before its first launch. Instead it
takes the first of these that works (`ensure_build`):

    1. its build directory already holds this tree's libraries (local);
    2. its own store holds the packed build for this card (store);
    3. a store-serving peer does: fetched into its own store
       (store/remote.sync_kernel_build) and installed from there (peer);
    4. nvcc.

Once loaded, the build is published into its own store when the store
lacks it, so every store-serving worker or service can hand it on. The
outcome goes into backend/_build.build_report (`source`, `seconds`),
which HEALTH and METRICS serve.

The artifact is an ordinary manifest entry under
`kbuild:<source hash>:sm_<major><minor>` (backend/_build.pack_build's
blob and meta), so it counts against the store's byte budget and is
evicted LRU like any artifact. It is installed only after
`ArtifactStore.get` re-verified its SHA-256, and only when its meta names
this tree's sources, flags and this card's capability
(backend/_build.install_build): loading a library runs its code. A
digest failure or a foreign artifact is a miss, counted as
`kernel_build_pull_errors` and logged, never installed.
"""

import threading
import time

from ..backend import _build
from ..obs import log as olog
from ..runtime.health import NullMetrics

PREFIX = "kbuild:"


def capability(device=None):
    """This card's compute capability as "sm_<major><minor>" (device None:
    the current card)."""
    import torch
    major, minor = torch.cuda.get_device_capability(device)
    return "sm_%d%d" % (major, minor)


def artifact_key(cap):
    """The store key of this tree's build for a card of capability `cap`
    ("sm_90"): the build hash and the architecture."""
    return "%s%s:%s" % (PREFIX, _build.source_hash(), cap)


def publish(store, cap):
    """Pack this tree's built directory into `store` under its
    artifact_key. Returns {key, bytes, publish_s}."""
    t0 = time.perf_counter()
    blob, meta = _build.pack_build(cap)
    key = artifact_key(cap)
    store.put(key, blob, meta=meta)
    out = {"key": key, "bytes": len(blob),
           "publish_s": round(time.perf_counter() - t0, 6)}
    olog.emit("store", "kernel_build_published", **out)
    return out


def _pull_error(metrics, key, why):
    metrics.inc("kernel_build_pull_errors")
    olog.emit("store", "kernel_build_pull_error", level="warn", key=key,
              error=why[:300])


def publish_if_missing(store, cap):
    """publish() unless `store` already holds this card's build. Returns
    {key, bytes, publish_s}; publish_s None when the entry was there."""
    key = artifact_key(cap)
    meta = store.meta(key)
    if meta is None:
        return publish(store, cap)
    return {"key": key, "bytes": meta.get("bytes"), "publish_s": None}


def install_from_store(store, cap, metrics=None, source="store"):
    """Install this card's packed build from `store` (the blob re-verified
    by ArtifactStore.get first). Returns build_report after the install,
    or None on a miss: no entry, a digest failure, or an artifact
    install_build refuses (the last two counted as
    kernel_build_pull_errors and logged, and the entry dropped, so the
    store neither offers it to peers nor keeps a good build from being
    published in its place)."""
    metrics = metrics or NullMetrics()
    key = artifact_key(cap)
    if store.meta(key) is None:
        return None
    blob = store.get(key)       # a digest failure drops the entry
    meta = store.meta(key)
    if blob is None or meta is None:
        _pull_error(metrics, key, "digest check failed")
        return None
    try:
        return _build.install_build(blob, meta, cap, source=source)
    except _build.BuildRejected as e:
        store.delete(key)
        _pull_error(metrics, key, str(e))
        return None


def ensure_build(store=None, peers=(), device=None, metrics=None):
    """Give this process its kernel libraries before their first load:
    the build directory, else `store`, else the store-serving `peers`
    ([(host, port)]; needs a store to fetch into), else nvcc. A hit is
    loaded at once and published into a `store` that lacks it, so every
    store-serving process can hand the build on. nvcc runs on a daemon
    thread (a caller's first load() waits on it) and publishes into
    `store` when done; this returns at once. The outcome and seconds go
    into backend/_build.build_report, whose copy this returns."""
    metrics = metrics or NullMetrics()
    t0 = time.monotonic()
    cap = capability(device)
    hit = _build.is_built()
    if hit:     # an earlier nvcc run or install of this process stays
        _build.build_report["source"] = _build.build_report["source"] or \
            "local"
    if not hit and store is not None:
        hit = install_from_store(store, cap, metrics) is not None
    if not hit and store is not None and peers:
        from . import remote
        hit = remote.sync_kernel_build(store, peers, cap, metrics=metrics)

    def load_and_publish():
        _build.load()
        if store is not None:
            publish_if_missing(store, cap)

    if hit:
        load_and_publish()
    else:
        def build():
            try:
                load_and_publish()
            except Exception as e:  # noqa: BLE001 - logged; load() raises
                olog.emit("store", "kernel_build_failed", level="error",
                          error=repr(e)[:300])
        _build.build_report["source"] = "nvcc"
        threading.Thread(target=build, name="kernel-build",
                         daemon=True).start()
    _build.build_report["seconds"] = round(time.monotonic() - t0, 6)
    return _build.report()
