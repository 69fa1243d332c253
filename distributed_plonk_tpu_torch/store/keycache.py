"""Bucket key (SRS + proving/verifying key) <-> bytes, for the ArtifactStore
(a copy of the JAX package's store/keycache.py: the same blob bytes, so a
store written by either package serves the other).

The serialization layer between `service.jobs.build_bucket_keys` output and
`store.artifacts.ArtifactStore` blobs: everything a restarted server needs
to serve a previously seen circuit shape without re-running trusted setup
or preprocess. Proofs made with a deserialized proving key are
byte-identical to ones made with the freshly built key, so checkpoint
fingerprints and golden fixtures keep working across a restart. The
port's keys come off the card (a `DeviceSrs`, a proving key whose
coefficient lists are lazy): serialize_bucket downloads them once; a
deserialized key is host lists, which each prover backend lifts to its
own device on first use.

Layout (versioned; all offsets fixed once the JSON header is read):

    magic "DPTK" | u16 version | u32 header_len | header JSON | body

header: domain_size, num_inputs, k (hex), n_powers, n_selectors, n_sigmas
body, in order:
    n_powers x 96B   SRS G1 powers, zcash uncompressed (encoding.py)
    18       x 96B   selector (13) + sigma (5) commitments, same format
    2        x 96B   g2, tau_g2, zcash compressed (full validation)
    13 x n   x 32B   selector polynomial coefficients, canonical LE Fr
    5  x n   x 32B   sigma polynomial coefficients, canonical LE Fr

Point loading uses a fast path: parse the uncompressed encoding and check
curve membership, but SKIP the per-point r-order subgroup check that
`encoding.g1_from_zcash` performs (~255 host Jacobian steps per point:
minutes for a 2^13-power SRS). The store is a local trust boundary whose
blobs we wrote ourselves and whose integrity SHA-256 already covers;
wire-facing paths (proof_io, encoding) keep the full zcash validation.
"""

import json
import struct

from ..constants import R_MOD, Q_MOD
from .. import curve as C
from .. import encoding as E
from .. import kzg
from ..poly import Domain
from ..circuit import NUM_WIRE_TYPES, NUM_SELECTORS

MAGIC = b"DPTK"
VERSION = 1

_PT = 96   # uncompressed G1
_FR = 32


def bucket_store_key(shape_key):
    """jobs.shape_key tuple -> stable manifest key string."""
    return "bucket:" + json.dumps(shape_key, separators=(",", ":"))


# -- finished-proof artifacts -------------------------------------------------
# Completed proofs join the same content-addressed surface as keys and
# checkpoints: the service journal's DONE record
# carries the digest returned by store_proof, a restarted service serves
# the result without re-proving, and any peer can STORE_FETCH it
# cross-host. The blob is the raw proof_io layout (already a canonical
# fixed-size wire format — no extra framing needed).

def proof_store_key(job_id):
    """Service job id -> finished-proof manifest key."""
    return f"proof:{job_id}"


def store_proof(store, job_id, proof_bytes, public_input, spec_wire=None,
                retries=0):
    """Persist one finished proof; returns its content digest (journaled
    in the DONE record)."""
    meta = {"kind": "proof",
            "public_input": [hex(x) for x in public_input],
            "retries": retries}
    if spec_wire is not None:
        meta["spec"] = spec_wire
    return store.put(proof_store_key(job_id), proof_bytes, meta=meta)


def load_proof(store, job_id):
    """-> (proof_bytes, public_input ints, meta) or None (evicted /
    integrity failure — recovery degrades to a re-prove, never crashes)."""
    hit = store.get_entry(proof_store_key(job_id))
    if hit is None:
        return None
    blob, _digest, meta = hit
    pub = [int(x, 16) for x in meta.get("public_input", [])]
    return blob, pub, meta


# -- merged-trace artifacts ---------------------------------------------------
# One per-job distributed timeline (trace.merge_traces output) joins the
# content-addressed surface next to the proof it explains: the service
# stores it at job completion, and ObsServer's /trace/<job_id> and
# STORE_FETCH serve it. The blob is the
# merged dump as canonical compact JSON — to_chrome_trace() re-derives
# the viewer format on demand, so the stored artifact stays the richer,
# lossless representation.

def trace_store_key(job_id):
    """Service job id -> merged-trace manifest key."""
    return f"trace:{job_id}"


def store_trace(store, job_id, merged):
    """Persist one merged timeline; returns its content digest."""
    blob = json.dumps(merged, separators=(",", ":"),
                      sort_keys=True).encode()
    meta = {"kind": "trace", "trace_id": merged.get("trace_id"),
            "spans": len(merged.get("events") or []),
            "processes": len(merged.get("processes") or [])}
    return store.put(trace_store_key(job_id), blob, meta=meta)


def load_trace(store, job_id):
    """-> merged timeline dict, or None (evicted / integrity failure /
    undecodable — observability never crashes the serving path)."""
    hit = store.get_entry(trace_store_key(job_id))
    if hit is None:
        return None
    blob, _digest, _meta = hit
    try:
        return json.loads(blob.decode())
    except (ValueError, UnicodeDecodeError):
        return None


# -- batch-aggregate artifacts (aggregate.py) ----------------------------------
# One built aggregate (the canonical JSON blob aggregate.to_bytes emits)
# joins the content-addressed surface next to the proofs it folds:
# aggregate:<agg_id>, where <agg_id> is already the content address of
# the member list. The journal's AGG record carries the digest returned
# here, so a restarted service re-serves the artifact without refolding.

def aggregate_store_key(agg_id):
    return f"aggregate:{agg_id}"


def store_aggregate(store, agg_id, blob, members, kinds=None):
    """Persist one aggregate artifact; returns its content digest
    (journaled in the AGG record)."""
    meta = {"kind": "aggregate", "agg_id": agg_id,
            "members": list(members)}
    if kinds:
        meta["circuit_kinds"] = sorted(set(kinds))
    return store.put(aggregate_store_key(agg_id), blob, meta=meta)


def load_aggregate(store, agg_id):
    """-> (blob, meta) or None (evicted / integrity failure — clients
    can always refold from the member proofs, never crash)."""
    hit = store.get_entry(aggregate_store_key(agg_id))
    if hit is None:
        return None
    blob, _digest, meta = hit
    return blob, meta


# -- on-demand profile artifacts (obs/profiling.py) ---------------------------
# One PROFILE capture (a torch-trace-gz Chrome trace, or the pystacks JSON
# of the sampler) joins the content-addressed surface: profile:<id> where
# <id> is the blob's own digest prefix, served at /profile/<id>.

def profile_store_key(profile_id):
    return f"profile:{profile_id}"


def store_profile(store, profile_id, blob, meta=None):
    """Persist one capture blob; returns its content digest."""
    m = {"kind": "profile", "profile_id": profile_id}
    m.update({k: v for k, v in (meta or {}).items()
              if isinstance(v, (int, float, str, bool))})
    return store.put(profile_store_key(profile_id), blob, meta=m)


def load_profile(store, profile_id):
    """-> (meta, blob), or None (evicted / integrity failure)."""
    hit = store.get_entry(profile_store_key(profile_id))
    if hit is None:
        return None
    blob, _digest, meta = hit
    return meta, blob


def _fr_vector_bytes(poly):
    """Canonical LE Fr coefficients, 32 bytes each (one join over the
    vector: the v2 key holds 18 x 2^18 of them)."""
    if not all(0 <= x < R_MOD for x in poly):
        raise ValueError("scalar out of canonical range")
    return b"".join(int(x).to_bytes(_FR, "little") for x in poly)


def _g1_load_fast(b, off):
    """Uncompressed zcash G1 -> affine point/None; on-curve check only
    (subgroup check skipped — see module docstring)."""
    raw = b[off:off + _PT]
    if len(raw) != _PT:
        raise ValueError("truncated point")
    if raw[0] & 0x40:  # infinity
        if any(raw[1:]) or (raw[0] & 0xBF):
            raise ValueError("malformed infinity encoding")
        return None
    x = int.from_bytes(bytes([raw[0] & 0x1F]) + raw[1:48], "big")
    y = int.from_bytes(raw[48:], "big")
    if x >= Q_MOD or y >= Q_MOD:
        raise ValueError("coordinate out of range")
    if (y * y - (pow(x, 3, Q_MOD) + 4)) % Q_MOD != 0:
        raise ValueError("point not on curve")
    return (x, y)


def _srs_powers(srs):
    """Host affine power list for either SRS flavor."""
    if isinstance(srs, kzg.DeviceSrs):
        return srs.powers_affine()
    return srs.powers_of_g1


def serialize_bucket(srs, pk, vk):
    """(srs, pk, vk) as built by jobs.build_bucket_keys (a host or device
    SRS; a proving key with host or lazy coefficient lists) -> one blob."""
    powers = _srs_powers(srs)
    selectors = pk.selectors   # materializes lazy device keys if needed
    sigmas = pk.sigmas
    n = vk.domain_size
    assert len(selectors) == NUM_SELECTORS and len(sigmas) == NUM_WIRE_TYPES
    header = {
        "domain_size": n,
        "num_inputs": vk.num_inputs,
        "k": [hex(x) for x in vk.k],
        "n_powers": len(powers),
    }
    h = json.dumps(header, separators=(",", ":")).encode()
    out = bytearray()
    out += MAGIC + struct.pack("<HI", VERSION, len(h)) + h
    for p in powers:
        out += E.g1_to_zcash(p, compressed=False)
    for p in list(vk.selector_comms) + list(vk.sigma_comms):
        out += E.g1_to_zcash(p, compressed=False)
    out += E.g2_to_zcash(vk.g2) + E.g2_to_zcash(vk.tau_g2)
    for poly in list(selectors) + list(sigmas):
        assert len(poly) == n, "coefficient vector length != domain size"
        out += _fr_vector_bytes(poly)
    return bytes(out)


def deserialize_bucket(blob):
    """Blob -> (srs, pk, vk) equal (element-for-element) to the build that
    produced it. Raises ValueError on any structural problem — callers
    treat that as a cache miss and rebuild."""
    if blob[:4] != MAGIC:
        raise ValueError("not a bucket-key blob")
    version, hlen = struct.unpack_from("<HI", blob, 4)
    if version != VERSION:
        raise ValueError(f"bucket blob version {version} != {VERSION}")
    off = 10
    header = json.loads(blob[off:off + hlen].decode())
    off += hlen
    n = header["domain_size"]
    n_powers = header["n_powers"]
    k = [int(x, 16) for x in header["k"]]

    want = (n_powers + NUM_SELECTORS + NUM_WIRE_TYPES) * _PT + 2 * 96 \
        + (NUM_SELECTORS + NUM_WIRE_TYPES) * n * _FR
    if len(blob) - off != want:
        raise ValueError(f"bucket blob body {len(blob) - off}B != {want}B")

    powers = []
    for _ in range(n_powers):
        powers.append(_g1_load_fast(blob, off))
        off += _PT
    comms = []
    for _ in range(NUM_SELECTORS + NUM_WIRE_TYPES):
        comms.append(_g1_load_fast(blob, off))
        off += _PT
    g2 = E.g2_from_zcash(blob[off:off + 96])
    tau_g2 = E.g2_from_zcash(blob[off + 96:off + 192])
    off += 192

    def frs(count):
        nonlocal off
        out = [int.from_bytes(blob[o:o + _FR], "little")
               for o in range(off, off + count * _FR, _FR)]
        if not all(x < R_MOD for x in out):
            raise ValueError("scalar out of canonical range")
        off += count * _FR
        return out

    selectors = [frs(n) for _ in range(NUM_SELECTORS)]
    sigmas = [frs(n) for _ in range(NUM_WIRE_TYPES)]

    srs = kzg.UniversalSrs(powers, g2, tau_g2)
    vk = kzg.VerifyingKey(
        domain_size=n, num_inputs=header["num_inputs"],
        selector_comms=comms[:NUM_SELECTORS],
        sigma_comms=comms[NUM_SELECTORS:],
        k=k, g1=C.G1_GEN, g2=g2, tau_g2=tau_g2)
    ck = kzg.pad_commit_key(powers, n + 3)
    pk = kzg.ProvingKey(ck, vk, Domain(n), lazy=lambda: (selectors, sigmas))
    return srs, pk, vk


# -- ArtifactStore bridge -----------------------------------------------------

def store_bucket(store, shape_key, srs, pk, vk, build_s=None):
    """Persist one bucket's keys; returns the content digest."""
    blob = serialize_bucket(srs, pk, vk)
    meta = {"domain_size": vk.domain_size, "kind": "bucket_keys",
            "format_version": VERSION}
    if build_s is not None:
        meta["build_s"] = round(build_s, 6)
    return store.put(bucket_store_key(shape_key), blob, meta=meta)


def load_bucket(store, shape_key):
    """-> (srs, pk, vk, meta) or None. A blob that fails to parse (stale
    format version, structural damage below the SHA-256's radar) is
    deleted so the rebuild repopulates the entry."""
    key = bucket_store_key(shape_key)
    blob = store.get(key)
    if blob is None:
        return None
    meta = store.meta(key) or {}
    try:
        srs, pk, vk = deserialize_bucket(blob)
    except Exception as e:
        # ANY parse failure is a miss-and-rebuild, per the module
        # contract: the blob shapes several exception families
        # (struct.error on a short header, ValueError on bad
        # points/scalars, AssertionError from pad_commit_key on an
        # undersized SRS, TypeError from malformed header JSON) and a
        # damaged artifact must never crash the scheduler
        import logging
        logging.getLogger("dpt.store").warning(
            "bucket blob for %r undeserializable (%s); rebuilding", key, e)
        store.delete(key)
        return None
    return srs, pk, vk, meta
