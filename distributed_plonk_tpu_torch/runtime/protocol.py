"""Wire protocol: frame tags + payload codecs.

The explicit replacement for the reference's capnp schema
(reference src/hello_world.capnp): the implemented subset maps to the
reference's live RPCs (init/varMsm/fft*); the 12 methods the reference
declared but never implemented (hello_world.capnp:26-44) are deliberately
absent — device-resident rounds make them unnecessary.

All integers little-endian. Field elements are 32-byte LE; G1 affine points
are x(48B LE) || y(48B LE) || inf(u8).

The port's copy is wire-identical to the JAX package's runtime/protocol.py:
the same tag numbers and the same codecs, so a dispatcher of either
package drives the workers of either. Tags of planes the port has not
ported yet (service, store, membership, metrics, logs, profiles,
aggregation) keep their numbers; the port's worker answers them ERR.
"""

import struct

import numpy as np

from ..backend.limbs import ints_to_limbs16, limbs16_to_ints
from ..constants import R_MOD
from . import native

# tags
PING = 1
INIT_BASES = 2     # u64 set_id, u64 n, then n * 97B points -> reply OK
                   # (workers hold MULTIPLE base sets keyed by id, so a
                   # healthy worker can adopt a dead worker's range)
MSM = 3            # u64 set_id, u64 count, count * 32B scalars
                   #                                   -> reply 97B point
NTT = 4            # u8 flags (1=inverse, 2=coset), u64 n, n * 32B elements
                   #                                   -> reply n * 32B
SHUTDOWN = 5
# --- cross-worker sharded 4-step FFT (the reference's distributed-FFT
# protocol, src/hello_world.capnp:19-23,48 / src/worker.rs:187-438, carried
# over the host fleet's TCP plane) ---
FFT_INIT = 6       # u64 id, u8 flags, u64 n/r/c, u64 rs/re/cs/ce -> OK
FFT1 = 7           # u64 id, u64 first_row, u64 count, count*r*32B -> OK
FFT2_PREPARE = 8   # u64 id -> OK once all peer exchanges are acknowledged
FFT_EXCHANGE = 9   # worker->worker: u64 id, u64 col_start, u64 col_count,
                   # u64 row_start, u64 row_count, then a contiguous
                   # (row_count x col_count) panel of 32B scalars -> OK
FFT2 = 10          # u64 id -> reply (ce-cs)*c_len*32B stage-2 rows + task GC
STATS = 11         # -> reply JSON {tag: count} served-request counters
HEALTH = 12        # -> reply JSON {uptime_s, served, fft_tasks, base_sets}:
                   # the liveness/re-admission probe (runtime/health.py) —
                   # cheaper than STATS to interpret, richer than PING
# --- proof service control plane (service/server.py) -------------------------
# Rides the exact same framed transport; payloads are JSON (control plane is
# cold — the hot data plane above keeps its binary codecs).
SUBMIT = 20        # JSON job spec -> OK + JSON {job_id, ...} | ERR + JSON
                   # {reason} (admission control rejects loudly, never queues
                   # past the configured depth)
STATUS = 21        # JSON {job_id} -> OK + JSON job status snapshot
RESULT = 22        # JSON {job_id} -> OK + [u32 hdr_len][hdr JSON][proof
                   # bytes] once DONE; ERR + JSON {reason, state} otherwise
METRICS = 23       # -> OK + JSON metrics snapshot (queue depth, wait/run
                   # histograms, per-round latency, throughput)
KILL_WORKER = 24   # fault injection (serve --chaos only): JSON {job_id |
                   # worker, at_round?} -> OK + JSON {worker}
WARMUP = 25        # JSON job spec (+ optional "aot": true) -> OK + JSON
                   # {shape_key, source: memory|disk|built, domain_size,
                   # warm_s, aot?}: pre-resolve a shape bucket's keys
                   # through the store tiers and (aot) precompile its
                   # prover stages, so later SUBMITs of the shape are warm
STORE_FETCH = 26   # JSON {key} -> OK + [u32 hdr][hdr JSON {key, digest,
                   # meta}][blob]: serve one artifact-store blob (bucket
                   # keys, prover checkpoint, SRS) to a peer/replacement
                   # host — cross-host warm start and resume become a
                   # network copy instead of a rebuild (store/remote.py
                   # re-verifies the digest client-side). Served by the
                   # proof service and by runtime workers given --store.
TRACE_DUMP = 27    # JSON {trace_id} -> OK + JSON tracer dump ({} when
                   # the worker holds no spans for that id): fetch-and-
                   # forget one trace's worker-side spans so the
                   # dispatcher can stitch them into the merged per-job
                   # timeline (trace.merge_traces, offset-corrected
                   # against the HEALTH clock sample)
# --- dynamic membership plane (runtime/membership.py) ------------------------
# Served by the dispatcher's MembershipServer (JOIN/LEAVE/ROSTER as
# queries) and by workers (ROSTER as a push). Control plane: JSON payloads.
JOIN = 28          # JSON {host, port, store?, phase?, stats?} -> OK + JSON
                   # {index, epoch, workers: ["h:p"...], stores: ["h:p"...]}
                   # — a starting worker announces itself and receives its
                   # fleet index + the epoch-numbered roster. A known
                   # (host, port) re-JOINs IN PLACE (same index: the
                   # supervisor-respawn path, re-admitted through the
                   # breaker machinery). phase="ready" is an idempotent
                   # update carrying warm-rejoin stats — no epoch bump.
LEAVE = 29         # JSON {index | host+port} -> OK + JSON {epoch}: declare
                   # a member permanently gone (supervisor flap cap, an
                   # operator decommission) — breaker opened, epoch bumped
ROSTER = 30        # to the membership server, empty payload: -> OK + JSON
                   # {epoch, workers, stores} (query);
                   # to a worker, JSON {epoch, workers}: adopt the pushed
                   # table iff epoch is newer -> OK + JSON {epoch} — how
                   # FFT2_PREPARE peer routing follows membership changes
STORE_LIST = 31    # JSON {prefix?} -> OK + JSON {keys}: enumerate store
                   # keys (manifest artifacts plus jaxcache:<relpath>
                   # pseudo-keys for persistent-compile-cache files) so a
                   # joining worker knows what to STORE_FETCH for its warm
                   # rejoin
# --- result-integrity plane (runtime/integrity.py) ---------------------------
EVAL = 32          # 32B point, u64 count, count * 32B coeffs -> reply 32B
                   # partial Horner evaluation sum_i c_i * point^i — the
                   # distributed round-4 evaluation chunk (the dispatcher
                   # scales by point^start and folds; duplicate-executed
                   # chunks cross-check workers against each other)
# --- fleet observability plane (obs/) ----------------------------------------
# Flag-safe, back-compatible like TRACE_DUMP: an old worker answers any of
# these with ERR "unknown tag" and the connection stays usable — scrapers
# degrade to an empty result, a prove is never harmed.
METRICS_FETCH = 33  # empty payload -> OK + JSON: the worker's FULL
                    # service.metrics.Metrics snapshot (counters/gauges/
                    # histograms incl. per-kernel gflops/MFU gauges) plus
                    # identity fields (index, epoch, backend, uptime_s,
                    # sdc_injected) — what the dispatcher/service fleet
                    # scraper aggregates into dpt_fleet_* series
LOG_FETCH = 34      # JSON {trace_id?, since_seq?, limit?} -> OK + JSON
                    # {events: [...], seq}: the worker's structured-log
                    # ring buffer (obs/log.py), optionally filtered to one
                    # trace id — how quarantines/replans/respawns become
                    # queryable events on the merged per-job timeline.
                    # Reads do NOT clear the ring (idempotent; the cap
                    # bounds memory), so since_seq gives tail -f semantics.
PROFILE = 35        # JSON {duration_ms?, kind?} -> OK + [u32 hdr][hdr JSON
                    # {format, ...}][blob]: arm an on-demand device/host
                    # profile capture on the worker for the window — the
                    # jax.profiler xplane capture (format "xplane-targz")
                    # on jax backends, an all-thread Python stack sampler
                    # (format "pystacks-json") otherwise. The caller stores
                    # the blob as a content-addressed profile:<id> artifact
                    # served at /profile/<id>.
# --- proof aggregation plane (aggregate.py) ----------------------------------
AGGREGATE = 36      # JSON {job_ids: [...]} -> OK + JSON {agg_id, members,
                    # kinds, store_key?, digest?, build_s}: fold N DONE
                    # jobs' proofs into one batch-KZG aggregate artifact
                    # (aggregate:<agg_id>, journaled like DONE) whose
                    # verification is ONE 2-pair pairing check regardless
                    # of N. ERR + JSON {reason, job_id?} when any named
                    # job is unknown or not DONE — an aggregate over a
                    # partial batch would silently weaken the client's
                    # "everything I submitted verified" claim.
AGG_FETCH = 37      # JSON {agg_id} -> OK + [u32 hdr][hdr JSON {agg_id,
                    # members, digest}][aggregate JSON blob]: serve a
                    # built aggregate artifact (from the store when the
                    # service has one, from the in-memory table
                    # otherwise; journal recovery restores both paths)
OK = 100
ERR = 101

# TRACED is a tag FLAG, not a tag: a sender that wants its trace context
# to ride a frame ORs it into the tag and prefixes the payload with
# [u16 ctx_len][ctx JSON {trace_id, parent_id?}] (wrap_traced). Receivers
# call strip_context() first, which passes flag-less frames through
# untouched — an old client's frames parse exactly as before, and a
# traced frame to an old receiver fails loudly (unknown tag), never
# silently misparses. Kept clear of the bit the JAX package's chaos
# injector XORs into a tag to corrupt it (0x40000000).
TRACED = 0x10000

FR_BYTES = 32
FQ_BYTES = 48
POINT_BYTES = 2 * FQ_BYTES + 1

# tag value -> name, for span labels and diagnostics (flag bits and
# non-tag constants excluded: tags live in [1, 101])
TAG_NAMES = {value: name for name, value in list(globals().items())
             if name.isupper() and isinstance(value, int)
             and 0 < value <= ERR
             and name not in ("FR_BYTES", "FQ_BYTES", "POINT_BYTES")}


def tag_name(tag):
    return TAG_NAMES.get(tag & ~TRACED, str(tag))


# --- trace-context framing ---------------------------------------------------

def wrap_traced(tag, payload, ctx):
    """(tag | TRACED, context-prefixed payload) — attach a trace context
    (trace.Tracer.context() dict) to one frame. No-op when ctx is None."""
    if not ctx:
        return tag, payload
    raw = encode_json(ctx)
    return tag | TRACED, struct.pack("<H", len(raw)) + raw + payload


def strip_context(tag, payload):
    """(base_tag, ctx | None, payload) — inverse of wrap_traced. Frames
    without the TRACED flag (every pre-trace client) pass through
    untouched, so the framing stays back-compatible."""
    if not tag & TRACED:
        return tag, None, payload
    (clen,) = struct.unpack_from("<H", payload, 0)
    return tag & ~TRACED, decode_json(payload[2:2 + clen]), payload[2 + clen:]


def encode_scalars(scalars):
    return b"".join(int(s % R_MOD).to_bytes(FR_BYTES, "little") for s in scalars)


def decode_scalars(raw):
    n = len(raw) // FR_BYTES
    return [int.from_bytes(raw[i * FR_BYTES:(i + 1) * FR_BYTES], "little")
            for i in range(n)]


# --- bulk limb-matrix codecs (hot data plane) --------------------------------
# Same wire bytes as encode_scalars/decode_scalars (concatenated 32B LE
# elements), but host-side data stays a (16, n) uint32 limb matrix converted
# by the native C++ codec in ONE call — no per-int Python serialization
# (a pure-Python plane is the bottleneck at 2^18; the reference's analog
# is its zero-copy transmute, src/utils.rs:27-43).

def encode_scalar_matrix(limbs):
    """(16, n) uint32 16-bit-limb matrix -> wire bytes."""
    return native.limbs_to_bytes(np.ascontiguousarray(limbs))


def decode_scalar_matrix(raw):
    """Wire bytes -> (16, n) uint32 limb matrix."""
    n = len(raw) // FR_BYTES
    return native.bytes_to_limbs(raw, n, FR_BYTES)


def ints_to_matrix(scalars):
    """Host int list -> (16, n) limb matrix."""
    return ints_to_limbs16([s % R_MOD for s in scalars])


def matrix_to_ints(limbs):
    """(16, n) limb matrix -> host int list."""
    return limbs16_to_ints(limbs)


def encode_point(p):
    if p is None:
        return bytes(POINT_BYTES - 1) + b"\x01"
    return (p[0].to_bytes(FQ_BYTES, "little")
            + p[1].to_bytes(FQ_BYTES, "little") + b"\x00")


def decode_point(raw):
    assert len(raw) == POINT_BYTES
    if raw[-1]:
        return None
    return (int.from_bytes(raw[:FQ_BYTES], "little"),
            int.from_bytes(raw[FQ_BYTES:2 * FQ_BYTES], "little"))


def encode_points(points):
    return struct.pack("<Q", len(points)) + b"".join(
        encode_point(p) for p in points)


def decode_points(raw, off=0):
    (n,) = struct.unpack_from("<Q", raw, off)
    out = []
    off += 8
    for _ in range(n):
        out.append(decode_point(raw[off:off + POINT_BYTES]))
        off += POINT_BYTES
    return out


def encode_init_bases(set_id, points):
    return struct.pack("<Q", set_id) + encode_points(points)


def decode_init_bases(raw):
    (set_id,) = struct.unpack_from("<Q", raw, 0)
    return set_id, decode_points(raw, off=8)


def encode_msm_request(set_id, scalars):
    return struct.pack("<QQ", set_id, len(scalars)) + encode_scalars(scalars)


def decode_msm_request(raw):
    set_id, n = struct.unpack_from("<QQ", raw, 0)
    return set_id, decode_scalars(raw[16:16 + n * FR_BYTES])


def encode_fft_init(task_id, inverse, coset, n, r, c, rs, re, col_ranges,
                    epoch=0, integrity=False):
    """col_ranges: every worker's stage-2 row range [(cs, ce)] — each worker
    needs the full table to route its peer exchange. `epoch` is the
    sender's membership-roster version (0 = no membership plane): a worker
    whose roster moved past it rejects the frame as stale, forcing the
    dispatcher to replan on the CURRENT fleet width. `integrity` announces
    that the dispatcher's integrity plane is armed: the worker then
    retains its raw FFT1 input panels so the FFT2 check point can get an
    input-side partial (a plane-off dispatcher keeps the legacy zero
    extra memory)."""
    flags = (1 if inverse else 0) | (2 if coset else 0)
    head = struct.pack("<QBQQQQQQ", task_id, flags, n, r, c, rs, re,
                       len(col_ranges))
    body = b"".join(struct.pack("<QQ", cs, ce) for cs, ce in col_ranges)
    return head + body + struct.pack("<QB", epoch, 1 if integrity else 0)


def decode_fft_init(raw):
    task_id, flags, n, r, c, rs, re, k = struct.unpack_from("<QBQQQQQQ", raw, 0)
    off = struct.calcsize("<QBQQQQQQ")
    col_ranges = [struct.unpack_from("<QQ", raw, off + 16 * i) for i in range(k)]
    off += 16 * k
    # trailing epoch + integrity flag are optional on the wire: frames
    # from older senders decode as epoch 0 / integrity off
    epoch = struct.unpack_from("<Q", raw, off)[0] if len(raw) >= off + 8 else 0
    integrity = raw[off + 8] != 0 if len(raw) >= off + 9 else False
    return (task_id, bool(flags & 1), bool(flags & 2), n, r, c, rs, re,
            col_ranges, epoch, integrity)


def encode_fft1_matrix(task_id, first_row, panel):
    """panel: (16, count, row_len) limb array; wire format: u64 id, u64
    first_row, u64 count, then count rows of row_len 32B LE scalars."""
    count = panel.shape[1]
    return (struct.pack("<QQQ", task_id, first_row, count)
            + encode_scalar_matrix(panel.reshape(16, count * panel.shape[2])))


def decode_fft1_matrix(raw):
    """-> (task_id, first_row, (16, count, row_len) limbs)"""
    task_id, first_row, count = struct.unpack_from("<QQQ", raw, 0)
    m = decode_scalar_matrix(raw[24:])
    row_len = m.shape[1] // count if count else 0
    return task_id, first_row, m.reshape(16, count, row_len)


def encode_fft_exchange(task_id, col_start, col_count, row_start, panel):
    """panel: (16, row_count, col_count) uint32 limb array — the sender's
    CONTIGUOUS stage-1 row block sliced to one peer's column range, shipped
    as one limb-matrix codec call (the per-row int-list format of round 2
    was the fleet's serialization bottleneck)."""
    row_count = panel.shape[1]
    head = struct.pack("<QQQQQ", task_id, col_start, col_count, row_start,
                       row_count)
    return head + encode_scalar_matrix(panel.reshape(16, row_count * col_count))


def decode_fft_exchange(raw):
    """-> (task_id, col_start, col_count, row_start, (16, rows, cols) limbs)"""
    task_id, col_start, col_count, row_start, row_count = \
        struct.unpack_from("<QQQQQ", raw, 0)
    m = decode_scalar_matrix(raw[40:])
    return (task_id, col_start, col_count, row_start,
            m.reshape(16, row_count, col_count))


# --- result-integrity codecs (runtime/integrity.py) --------------------------

def encode_eval_request(point, values):
    """EVAL: evaluate sum_i values[i] * point^i on the worker."""
    return (int(point % R_MOD).to_bytes(FR_BYTES, "little")
            + struct.pack("<Q", len(values)) + encode_scalars(values))


def decode_eval_request(raw):
    point = int.from_bytes(raw[:FR_BYTES], "little")
    (n,) = struct.unpack_from("<Q", raw, FR_BYTES)
    off = FR_BYTES + 8
    return point, decode_scalars(raw[off:off + n * FR_BYTES])


def encode_scalar(v):
    return int(v % R_MOD).to_bytes(FR_BYTES, "little")


def decode_scalar(raw):
    return int.from_bytes(raw[:FR_BYTES], "little")


def encode_fft2_request(task_id, point=None):
    """FFT2 fetch, optionally carrying the integrity check point: when
    `point` rides the frame the worker piggybacks its (input-side,
    output-side) partial power sums at that point on the reply. Workers
    that predate the integrity plane ignore the trailing bytes (the
    decoder unpacks only the leading u64), so the request stays
    back-compatible."""
    head = struct.pack("<Q", task_id)
    if point is None:
        return head
    return head + encode_scalar(point)


def decode_fft2_request(raw):
    (task_id,) = struct.unpack_from("<Q", raw, 0)
    point = None
    if len(raw) >= 8 + FR_BYTES:
        point = decode_scalar(raw[8:8 + FR_BYTES])
    return task_id, point


_FFT2_PARTIAL_FLAG = b"\x01"


def encode_fft2_partials(a, b, panel_bytes):
    """Reply = flag byte + 32B input-side partial + 32B output-side
    partial + the panel. The panel alone is a multiple of 32 bytes, so
    receivers distinguish the two layouts by `len % 32 == 1` — a reply
    from an integrity-unaware worker (panel only) still parses."""
    return _FFT2_PARTIAL_FLAG + encode_scalar(a) + encode_scalar(b) \
        + panel_bytes


def split_fft2_reply(raw):
    """((input_partial, output_partial) | None, panel_bytes)."""
    if len(raw) % FR_BYTES == 1 and raw[:1] == _FFT2_PARTIAL_FLAG:
        a = decode_scalar(raw[1:1 + FR_BYTES])
        b = decode_scalar(raw[1 + FR_BYTES:1 + 2 * FR_BYTES])
        return (a, b), raw[1 + 2 * FR_BYTES:]
    return None, raw


# --- proof service codecs ----------------------------------------------------

def encode_json(obj):
    import json
    return json.dumps(obj, separators=(",", ":")).encode()


def decode_json(raw):
    import json
    return json.loads(raw.decode()) if raw else {}


def encode_result(header, blob):
    """RESULT reply: [u32 header_len][header JSON][opaque proof bytes]."""
    h = encode_json(header)
    return struct.pack("<I", len(h)) + h + blob


def decode_result(raw):
    (hlen,) = struct.unpack_from("<I", raw, 0)
    return decode_json(raw[4:4 + hlen]), raw[4 + hlen:]


def encode_ntt_request(values, inverse, coset):
    flags = (1 if inverse else 0) | (2 if coset else 0)
    return (struct.pack("<BQ", flags, len(values))
            + encode_scalars(values))


def decode_ntt_request(raw):
    flags, n = struct.unpack_from("<BQ", raw, 0)
    values = decode_scalars(raw[9:9 + n * FR_BYTES])
    return values, bool(flags & 1), bool(flags & 2)
