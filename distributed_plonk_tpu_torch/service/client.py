"""Client for the proof service wire plane (a copy of the JAX package's
service/client.py: the wire format is shared, so it drives either
package's service).

One framed TCP connection, strict request/reply, thread-safe (a lock
serializes frames, so concurrent submitters may share one client or open
one each). Raises ServiceError with the server's JSON reason on ERR."""

import threading
import time

from ..runtime import native, protocol


class ServiceError(Exception):
    def __init__(self, info):
        super().__init__(info.get("reason", "service error"))
        self.info = info


class ServiceClient:
    def __init__(self, host, port, timeout_ms=None):
        self.conn = native.connect(host, port)
        if timeout_ms is not None:
            self.conn.set_timeout(timeout_ms)
        self._lock = threading.Lock()

    def close(self):
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call(self, tag, payload=b""):
        with self._lock:
            self.conn.send(tag, payload)
            rtag, rpayload = self.conn.recv()
        if rtag != protocol.OK:
            raise ServiceError(protocol.decode_json(rpayload))
        return rpayload

    def ping(self):
        self._call(protocol.PING)

    def submit(self, spec, trace_ctx=None):
        """spec: JSON-able job dict -> SUBMIT reply dict ({job_id, ...,
        trace_id}). trace_ctx (a trace.Tracer.context() dict) makes the
        server ADOPT the client's trace id instead of stamping a fresh
        one, so the job's merged timeline links back to the caller's
        span — one trace from the client through the last worker
        kernel."""
        if trace_ctx:
            spec = dict(spec, trace_ctx=trace_ctx)
        return protocol.decode_json(
            self._call(protocol.SUBMIT, protocol.encode_json(spec)))

    def status(self, job_id):
        return protocol.decode_json(
            self._call(protocol.STATUS,
                       protocol.encode_json({"job_id": job_id})))

    def result(self, job_id):
        """-> (header dict, proof bytes). Raises ServiceError (reason
        not_ready / failure) until the job is DONE."""
        return protocol.decode_result(
            self._call(protocol.RESULT,
                       protocol.encode_json({"job_id": job_id})))

    def warmup(self, spec, aot=False):
        """Pre-warm one shape bucket on the server (keys through the store
        tiers; aot=True also precompiles prover stages). Returns the
        server's summary dict ({source: memory|disk|built, ...})."""
        req = dict(spec)
        if aot:
            req["aot"] = True
        return protocol.decode_json(
            self._call(protocol.WARMUP, protocol.encode_json(req)))

    def metrics(self):
        return protocol.decode_json(self._call(protocol.METRICS))

    def store_fetch(self, key):
        """-> (header dict {key, digest, meta}, blob bytes) for one
        artifact-store entry on the server. Raises ServiceError on a
        miss. store.remote.fetch_into is the digest-verifying consumer;
        this raw accessor is for tooling/tests."""
        return protocol.decode_result(
            self._call(protocol.STORE_FETCH,
                       protocol.encode_json({"key": key})))

    def trace(self, job_id):
        """The job's merged distributed timeline (the trace:<job_id>
        store artifact) as a dict. Raises ServiceError when the server
        is storeless or the trace is gone; ObsServer's /trace/<job_id>
        serves the same timeline over HTTP."""
        import json
        _hdr, blob = self.store_fetch(f"trace:{job_id}")
        return json.loads(blob.decode())

    def aggregate(self, job_ids):
        """Fold N DONE jobs into one batch-KZG aggregate on the server.
        Returns the AGGREGATE reply dict ({agg_id, members, kinds,
        digest, build_s}); raises ServiceError when any member is
        unknown or not DONE (the fold is all-or-nothing)."""
        return protocol.decode_json(
            self._call(protocol.AGGREGATE,
                       protocol.encode_json({"job_ids": list(job_ids)})))

    def fetch_aggregate(self, agg_id):
        """The built aggregate's canonical JSON artifact as a dict —
        exactly what aggregate.verify() consumes (one 2-pair pairing
        check for the whole batch). Raises ServiceError on a miss."""
        from .. import aggregate as AGG
        _hdr, blob = protocol.decode_result(
            self._call(protocol.AGG_FETCH,
                       protocol.encode_json({"agg_id": agg_id})))
        return AGG.from_bytes(blob)

    def kill_worker(self, worker=None, job_id=None, at_round=None):
        req = {}
        if worker is not None:
            req["worker"] = worker
        if job_id is not None:
            req["job_id"] = job_id
        if at_round is not None:
            req["at_round"] = at_round
        return protocol.decode_json(
            self._call(protocol.KILL_WORKER,
                       protocol.encode_json(req)))["worker"]

    def shutdown_server(self):
        self._call(protocol.SHUTDOWN)

    def wait(self, job_id, timeout_s=120, poll_s=0.05):
        """Poll STATUS until the job reaches a terminal state (done,
        failed, or a shed TTL verdict); returns the final status dict.
        Raises TimeoutError."""
        deadline = time.monotonic() + timeout_s
        while True:
            st = self.status(job_id)
            if st["state"] in ("done", "failed", "shed"):
                return st
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job_id} still {st['state']}")
            time.sleep(poll_s)
