"""Content-addressed on-disk artifact store with integrity + LRU eviction
(a copy of the JAX package's store/artifacts.py, minus its JAX
compile-cache sweep: the port keeps no compile cache under the store).

The persistence layer under the proof service's warm-start path
(store/keycache.py serializes bucket keys into it; scheduler.BucketCache
is its main consumer). Inference-stack shape: a model-weights /
compiled-program cache, specialized to proving artifacts.

Layout under `root`:

    manifest.json            versioned index: key -> {digest, bytes, seq, meta}
    objects/ab/abcdef...bin  blobs, named by their SHA-256 (content-addressed)

Contracts:
- Every write is atomic (tmp file + os.replace), manifest included, so a
  crash mid-write can never leave a referenced-but-truncated entry: either
  the old manifest (no reference) or the new one (fully written blob).
- `get` re-verifies SHA-256 over the full blob on every read. An integrity
  failure (truncation, bit rot, a partial copy) logs, DELETES the entry,
  and returns None — callers fall through to a fresh build instead of
  crashing.
- LRU byte-budget eviction: each hit bumps a sequence number (in memory;
  persisted with the next put/delete); a put that pushes the store past
  `byte_budget` evicts lowest-seq entries first (never the entry just
  written). Object files are refcounted by digest, so two keys sharing
  identical bytes share one blob; blobs orphaned by a manifest reset or
  writer race are swept at the next open.
- Cross-process: readers reload the manifest from disk on a miss, so a
  store populated by another process (warmup job, previous server run) is
  visible without restart, and a plain hit never writes the manifest, so
  readers cannot clobber a writer. Concurrent WRITERS are safe too:
  every manifest read-modify-write (put/delete) runs under an fcntl
  lockfile (`manifest.lock`) and starts by MERGING the on-disk manifest
  into memory — disk is the source of truth for the entry set (a key we
  hold that disk lacks was deleted by another writer), while in-memory
  LRU recency survives as max(seq). Two warmup/serve writers on one
  store cannot drop each other's entries; on platforms without fcntl the
  lock degrades to atomic replace only.

Metrics (duck-typed `inc`/`gauge`, e.g. service.metrics.Metrics or its
`scoped("store")` view): hits, misses, corrupt, evictions, put_bytes,
and gauges bytes / entries.
"""

import hashlib
import json
import logging
import os
import threading
import time

from ..runtime.health import NullMetrics

try:
    import fcntl
except ImportError:  # pragma: no cover - non-posix fallback
    fcntl = None

log = logging.getLogger("dpt.store")

MANIFEST_VERSION = 1


class _FileLock:
    """Advisory exclusive lock on a sidecar file (blocking). Serializes
    manifest read-modify-write across PROCESSES; the in-process
    threading lock still serializes threads within one store object.
    No-ops when fcntl is unavailable."""

    def __init__(self, path):
        self.path = path
        self._f = None

    def __enter__(self):
        if fcntl is not None:
            self._f = open(self.path, "a+")
            fcntl.flock(self._f.fileno(), fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        if self._f is not None:
            fcntl.flock(self._f.fileno(), fcntl.LOCK_UN)
            self._f.close()
            self._f = None
        return False


class ArtifactStore:
    def __init__(self, root, byte_budget=None, metrics=None):
        self.root = root
        self.byte_budget = byte_budget
        self.metrics = metrics or NullMetrics()
        self._lock = threading.Lock()
        os.makedirs(os.path.join(root, "objects"), exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.json")
        self._file_lock = _FileLock(os.path.join(root, "manifest.lock"))
        # load + orphan sweep under the file lock: a lock-free sweep
        # could delete an old blob a concurrent put() just revived via
        # its exists()-skip path (entry published, backing blob gone)
        with self._file_lock:
            self._manifest = self._load_manifest()
            self._sweep_orphans()
        self._publish_gauges()

    # -- manifest -------------------------------------------------------------

    def _load_manifest(self):
        try:
            with open(self._manifest_path) as f:
                m = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {"version": MANIFEST_VERSION, "seq": 0, "entries": {}}
        if m.get("version") != MANIFEST_VERSION:
            # future/foreign manifest: start fresh rather than misparse.
            # Blobs are content-addressed so orphans are harmless; the
            # next open's _sweep_orphans reclaims the disk.
            log.warning("store %s: manifest version %r != %d, resetting",
                        self.root, m.get("version"), MANIFEST_VERSION)
            return {"version": MANIFEST_VERSION, "seq": 0, "entries": {}}
        return m

    def _sweep_orphans(self):
        """Delete object files no manifest entry references (left by a
        manifest reset or a lost writer race) — they are invisible to the
        byte budget, so without this they would grow the disk unbounded."""
        live = {e["digest"] for e in self._manifest["entries"].values()}
        objroot = os.path.join(self.root, "objects")
        for sub in os.listdir(objroot):
            subdir = os.path.join(objroot, sub)
            if not os.path.isdir(subdir):
                continue
            for fname in os.listdir(subdir):
                digest = fname[:-4] if fname.endswith(".bin") else None
                if digest in live:
                    continue
                path = os.path.join(subdir, fname)
                try:  # stray tmp files from a crashed writer also land
                    # here; an age floor keeps the sweep from racing a
                    # concurrent put whose manifest write is in flight
                    if time.time() - os.path.getmtime(path) > 300:
                        os.remove(path)
                except OSError:  # pragma: no cover - concurrent cleanup
                    pass

    def _save_manifest(self):
        tmp = self._manifest_path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp, self._manifest_path)

    def _merge_from_disk(self):
        """Merge the on-disk manifest into memory (writers call this
        with the file lock held; get()'s miss path calls it lock-free,
        which is safe because _save_manifest publishes atomically).

        Disk is authoritative for the ENTRY SET: every write by any
        process saves before releasing the file lock, so an entry we
        hold that disk lacks was deleted by another writer (eviction),
        and a disk entry we lack was added by one. What memory
        contributes is recency — LRU touches are in-memory-only until
        the next write — so per-key seq merges as max(), and the global
        counter as max() too, keeping seq monotonic across writers."""
        disk = self._load_manifest()
        mem = self._manifest["entries"]
        for key, e in disk["entries"].items():
            m = mem.get(key)
            if m is not None and m["digest"] == e["digest"]:
                e["seq"] = max(e["seq"], m["seq"])
        disk["seq"] = max(disk["seq"], self._manifest["seq"])
        self._manifest = disk

    def _publish_gauges(self):
        ents = self._manifest["entries"]
        self.metrics.gauge("bytes",
                           sum(e["bytes"] for e in ents.values()))
        self.metrics.gauge("entries", len(ents))

    def _obj_path(self, digest):
        return os.path.join(self.root, "objects", digest[:2], digest + ".bin")

    def _next_seq(self):
        self._manifest["seq"] += 1
        return self._manifest["seq"]

    # -- public API -----------------------------------------------------------

    def keys(self):
        """Every key on disk now: another process's writes (an offline
        warmup provisioning a store a worker already serves) included."""
        with self._lock:
            self._merge_from_disk()
            return sorted(self._manifest["entries"])

    def stats(self):
        with self._lock:
            ents = self._manifest["entries"]
            return {"entries": len(ents),
                    "bytes": sum(e["bytes"] for e in ents.values()),
                    "byte_budget": self.byte_budget}

    def meta(self, key):
        with self._lock:
            e = self._manifest["entries"].get(key)
            return dict(e["meta"]) if e else None

    def put(self, key, blob, meta=None):
        """Store `blob` under `key` (replacing any prior entry), atomically.
        Returns the content digest."""
        digest = hashlib.sha256(blob).hexdigest()
        path = self._obj_path(digest)
        def _write_blob():
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp.%d" % os.getpid()
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)

        with self._lock:
            # bulk blob I/O OUTSIDE the cross-process flock (multi-MB
            # key blobs must not serialize concurrent warmup writers);
            # content-addressed atomic rename makes it idempotent. The
            # existence is RE-CHECKED under the flock: a concurrent
            # writer's eviction between our write and our manifest
            # insert would otherwise publish an entry with no backing
            # blob
            if not os.path.exists(path):
                _write_blob()
            with self._file_lock:
                if not os.path.exists(path):  # evicted in the window
                    _write_blob()
                self._merge_from_disk()
                old = self._manifest["entries"].get(key)
                self._manifest["entries"][key] = {
                    "digest": digest, "bytes": len(blob),
                    "seq": self._next_seq(), "created": time.time(),
                    "meta": dict(meta or {}),
                }
                if old is not None and old["digest"] != digest:
                    self._drop_blob_if_unreferenced(old["digest"])
                self.metrics.inc("put_bytes", len(blob))
                self._evict_over_budget(protect=key)
                self._save_manifest()
            self._publish_gauges()
        return digest

    def get(self, key):
        """Blob for `key`, or None (miss, or integrity failure — in which
        case the corrupt entry is deleted so the caller's rebuild can
        repopulate it)."""
        hit = self.get_entry(key)
        return hit[0] if hit is not None else None

    def get_entry(self, key):
        """-> (blob, digest, meta) for a verified hit, or None. The digest
        is the one the read was just verified against, so STORE_FETCH
        servers (store/remote.serve_fetch) can advertise it without
        hashing the blob a second time."""
        with self._lock:
            e = self._manifest["entries"].get(key)
            if e is None:
                # another process may have populated the store since we
                # loaded the manifest (warmup job, previous server run);
                # merge rather than overwrite so in-memory LRU touches
                # (persisted only on the next write) keep their recency
                self._merge_from_disk()
                e = self._manifest["entries"].get(key)
            if e is None:
                self.metrics.inc("misses")
                return None
            blob = self._read_verified(key, e)
            if blob is None:
                # before declaring corruption, resync: another writer
                # may have re-put the key (old blob legitimately gone)
                # or deleted it — neither is an integrity failure
                with self._file_lock:
                    self._merge_from_disk()
                    cur = self._manifest["entries"].get(key)
                    if cur is None:
                        self.metrics.inc("misses")
                        return None
                    # re-read unconditionally: even a SAME-digest entry
                    # may have been evicted and re-put by another writer
                    # (deterministic key blobs), making the blob valid
                    # again on disk
                    blob = self._read_verified(key, cur)
                    e = cur
                    if blob is None:
                        self.metrics.inc("corrupt")
                        self._delete_locked(key)
                        self._save_manifest()
                if blob is None:
                    self._publish_gauges()
                    return None
            self.metrics.inc("hits")
            # LRU touch, in memory only: a hit must NOT rewrite the
            # manifest — a reader that writes would clobber entries a
            # concurrent warmup/serve writer just added (last-write-wins
            # manifest). Recency is persisted by the next real write
            # (put/delete), which is also when eviction reads it.
            e["seq"] = self._next_seq()
            return blob, e["digest"], dict(e["meta"])

    def object_path(self, key):
        """Path of the object file behind `key`, or None (the chaos
        plane's checkpoint corruption writes beneath the integrity
        layer on purpose)."""
        with self._lock:
            e = self._manifest["entries"].get(key)
            return self._obj_path(e["digest"]) if e else None

    def delete(self, key):
        with self._lock:
            with self._file_lock:
                self._merge_from_disk()
                found = key in self._manifest["entries"]
                if found:
                    self._delete_locked(key)
                    self._save_manifest()
            self._publish_gauges()
            return found

    # -- internals (lock held) ------------------------------------------------

    def _read_verified(self, key, e):
        try:
            with open(self._obj_path(e["digest"]), "rb") as f:
                blob = f.read()
        except OSError as err:
            log.warning("store %s: %s unreadable (%s); dropping entry",
                        self.root, key, err)
            return None
        if len(blob) != e["bytes"]:
            log.warning("store %s: %s failed integrity check "
                        "(%d bytes on disk, %d expected); dropping entry",
                        self.root, key, len(blob), e["bytes"])
            return None
        digest = hashlib.sha256(blob).hexdigest()
        if digest != e["digest"]:
            log.warning("store %s: %s failed integrity check "
                        "(digest %s.. != %s..); dropping entry",
                        self.root, key, digest[:12], e["digest"][:12])
            return None
        return blob

    def _delete_locked(self, key):
        e = self._manifest["entries"].pop(key)
        self._drop_blob_if_unreferenced(e["digest"])

    def _drop_blob_if_unreferenced(self, digest):
        if any(e["digest"] == digest
               for e in self._manifest["entries"].values()):
            return
        try:
            os.remove(self._obj_path(digest))
        except OSError:
            pass

    def _evict_over_budget(self, protect=None):
        if self.byte_budget is None:
            return
        ents = self._manifest["entries"]
        total = sum(e["bytes"] for e in ents.values())
        # oldest-use first; the just-written entry survives even when it is
        # alone over budget (an empty store that can't hold its one artifact
        # would defeat the cache entirely)
        for key in sorted(ents, key=lambda k: ents[k]["seq"]):
            if total <= self.byte_budget:
                break
            if key == protect:
                continue
            total -= ents[key]["bytes"]
            self._delete_locked(key)
            self.metrics.inc("evictions")
