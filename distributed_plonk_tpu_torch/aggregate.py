"""Batch-KZG proof aggregation: N proofs in, ONE 2-pair pairing check out (a
copy of the JAX package's aggregate.py: the same artifact bytes and the
same verdicts, so either package verifies the other's aggregates).

Every served proof costs its own pairing check: fine for a client
verifying one result, hopeless for anyone consuming the service's output
at rate. This module is the batching layer on top of
verifier.opening_terms:

  build()              N completed jobs' (spec, public input, proof
                       bytes) -> one canonical, content-addressed
                       aggregate artifact (a JSON blob; `agg_id` is the
                       SHA-256 of the canonical member encoding, so the
                       same batch always produces the same artifact)
  derive_challenges()  the aggregation transcript: a FRESH Merlin
                       transcript (label b"DptAggregate") absorbs every
                       member's canonical bytes — job id, spec wire
                       dict, public inputs (fr_to_bytes), the raw
                       944-byte proof — and only then draws, per member,
                       the opening-fold challenge u_j and the
                       linear-combination weight r_j. Flipping ANY bit
                       of any member shifts EVERY (u_j, r_j).
  verify()             artifact -> bool, by folding all members into
                       verifier.verify_aggregate's single 2-pair
                       pairing check.

Soundness sketch: each member's verification equation is a pairing
identity  e(lhs_j, g2) e(-rhs_j, tau_g2) == 1.  verify() checks the
r_j-weighted fold of those identities. The r_j are derived Fiat-Shamir
style AFTER every member's bytes are committed to the transcript, so a
prover cannot choose proof bytes as a function of the weights; if any
single member's identity fails, the fold is a nonzero element hit by a
random linear combination — it cancels with probability ~1/r (|Fr| ~
2^255). The u_j (which fold each member's two openings, at zeta and
omega*zeta) come from the same transcript for the same reason. Cost
model: verification is two size-O(30N) G1 MSMs + ONE pairing_check with
2 pairs, vs N pairing checks (2N pairs) sequentially — the pairings,
not the MSMs, dominate, so verify time is ~flat in N.

All members must share the SRS tail (g2, tau_g2): this repo's service
derives every bucket's keys from the fixed TEST_TAU, so that holds by
construction; verify_aggregate still REJECTS (not asserts) on mismatch.
"""

import hashlib
import json

from .constants import R_MOD
from . import proof_io, verifier
from .transcript import MerlinTranscript, fr_from_le_bytes_mod_order, fr_to_bytes

SCHEMA = 1
TRANSCRIPT_LABEL = b"DptAggregate"


def _canonical_json(obj):
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def _norm_member(m):
    proof = m["proof"] if isinstance(m["proof"], str) else bytes(m["proof"]).hex()
    return {
        "job_id": str(m["job_id"]),
        "spec": m["spec"],
        "pub": [x if isinstance(x, str) else format(int(x) % R_MOD, "x")
                for x in m["pub"]],
        "proof": proof,
    }


def member_id(members):
    """Content address of a member list: the artifact id is a digest of
    the canonical encoding, so the same batch of jobs aggregates to the
    same `aggregate:<id>` artifact on every run (and across restarts)."""
    blob = _canonical_json([_norm_member(m) for m in members])
    return "agg-" + hashlib.sha256(blob).hexdigest()[:16]


def build(members):
    """[{job_id, spec (wire dict), pub ([int]|[hex]), proof (bytes|hex)}]
    -> the canonical aggregate artifact dict."""
    if not members:
        raise ValueError("aggregate needs at least one member")
    norm = [_norm_member(m) for m in members]
    return {"schema": SCHEMA, "agg_id": member_id(members), "members": norm}


def to_bytes(agg):
    return _canonical_json(agg)


def from_bytes(blob):
    """Parse + structurally validate an untrusted artifact. Raises
    ValueError on anything malformed (verification happens in verify())."""
    try:
        agg = json.loads(bytes(blob).decode())
    except (UnicodeDecodeError, ValueError):
        raise ValueError("aggregate artifact is not valid JSON")
    if not isinstance(agg, dict) or agg.get("schema") != SCHEMA:
        raise ValueError("aggregate artifact has unknown schema")
    members = agg.get("members")
    if not isinstance(members, list) or not members:
        raise ValueError("aggregate artifact has no members")
    for m in members:
        if not isinstance(m, dict) or not isinstance(m.get("spec"), dict) \
                or not isinstance(m.get("pub"), list) \
                or not isinstance(m.get("proof"), str):
            raise ValueError("malformed aggregate member")
    return agg


def derive_challenges(members):
    """Normalized member list -> [(u_j, r_j)] from the aggregation
    transcript. Absorb-everything-then-draw ordering is the binding: no
    challenge exists until every member's bytes are committed."""
    t = MerlinTranscript(TRANSCRIPT_LABEL)
    t.append_message(b"n_members", len(members).to_bytes(4, "little"))
    for m in members:
        t.append_message(b"job_id", m["job_id"].encode())
        t.append_message(b"spec", _canonical_json(m["spec"]))
        t.append_message(b"pub", b"".join(
            fr_to_bytes(int(x, 16)) for x in m["pub"]))
        t.append_message(b"proof", bytes.fromhex(m["proof"]))
    out = []
    for _ in members:
        u = fr_from_le_bytes_mod_order(t.challenge_bytes(b"u", 64))
        r = fr_from_le_bytes_mod_order(t.challenge_bytes(b"r", 64))
        out.append((u, r))
    return out


def _vk_for_spec(spec_wire, cache, device=None):
    # lazy import: aggregate is a core-layer module; only vk resolution
    # needs the service's spec/bucket machinery
    from .service import jobs
    spec = jobs.JobSpec.from_wire(spec_wire)
    key = jobs.shape_key(spec)
    if key not in cache:
        cache[key] = jobs.build_bucket_keys(spec, device=device)[2]
    return cache[key]


def verify(agg, vk_cache=None, device=None):
    """Aggregate artifact -> bool: ONE 2-pair pairing check for all N
    members, accepting iff every constituent proof verifies.

    vk_cache (optional dict) carries shape_key -> vk across calls: vks
    are rebuilt deterministically from each member's spec (the service's
    fixed-test-tau contract, service/jobs.py), which costs a key build
    per distinct shape on `device` (None: the card): cache it when
    verifying a stream.
    """
    vk_cache = vk_cache if vk_cache is not None else {}
    try:
        agg = from_bytes(to_bytes(agg)) if isinstance(agg, dict) else from_bytes(agg)
    except ValueError:
        return False
    if agg.get("agg_id") != member_id(agg["members"]):
        return False  # content address doesn't match the content
    try:
        fold_members = []
        challenges = derive_challenges(agg["members"])
        for m, (u, r) in zip(agg["members"], challenges):
            vk = _vk_for_spec(m["spec"], vk_cache, device)
            pub = [int(x, 16) for x in m["pub"]]
            proof = proof_io.deserialize_proof(bytes.fromhex(m["proof"]))
            fold_members.append((vk, pub, proof, u, r))
    except ValueError:
        return False
    return verifier.verify_aggregate(fold_members)
