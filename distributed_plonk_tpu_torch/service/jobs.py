"""Job model: wire specs, circuit builders, and bucket (shape) keys (a copy
of the JAX package's service/jobs.py; bucket keys are built on the card).

A job spec names a WORKLOAD FAMILY + parameters + a witness seed, not a
circuit: the circuit is rebuilt deterministically from the spec on every
prove attempt (so a checkpoint-resumed retry sees the identical circuit),
and — crucially for the scheduler — two specs with the same parameters but
different seeds produce circuits with IDENTICAL structure (gates, wiring,
selectors): only witness values and the public input differ. That is what
makes a bucket's SRS + proving key shareable across every job in it
(proofs made with the bucket pk verify under the bucket vk for arbitrary
seeds).

Families:
  toy      {"kind": "toy", "gates": G, "seed": S}
           add/mul/lc chain, G gates -> domain next_pow2(G + ~4). The
           small-domain family load tests and tier-1 use.
  merkle   {"kind": "merkle", "height": H, "num_proofs": P,
            "num_leaves": L?, "seed": S}
           the paper's Merkle-membership workload (workload.py); structure
           depends only on (H, P, L) because leaf indices are k % L.
  range    {"kind": "range", "bits": B, "count": C?, "seed": S}
  preimage {"kind": "preimage", "count": C?, "seed": S}
  rollup   {"kind": "rollup", "height": H, "updates": M?,
            "num_accounts": A?, "seed": S}
           the circuit zoo (circuits/ package): validation and
           construction are delegated to circuits.REGISTRY, and every zoo
           builder honors the same structure-from-params contract.

The SRS uses the repo's fixed test tau, so clients can rebuild the
matching vk locally with build_bucket_keys() and verify results without a
vk serializer. This is a test-setup service, not a production ceremony.
The keys are built on a device: the SRS by the fixed-base walk
(kzg.universal_setup_device, n + 4 powers as the JAX package's host
universal_setup(n + 3) gives) and the preprocess on TorchBackend, so they
equal the JAX package's keys for the same spec.
"""

import itertools
import random
import threading
import time

from ..circuit import PlonkCircuit
from ..constants import R_MOD
from ..trace import new_trace_id
from .. import circuits

# same deterministic toxic-waste tau as tests/conftest.py's fixture SRS:
# server and clients derive identical keys from a spec alone
TEST_TAU = 0xDEADBEEF

_SPEC_KINDS = ("toy", "merkle") + circuits.KINDS

# SLO serving classes: per-class queue priority (flagship pops first),
# per-class default deadlines (CLASS_TTL_S), and shed-lowest-class-first
# under pressure (queue.steal_lowest). A spec without a class is
# `standard`, and an all-standard stream sorts, sheds and proves exactly
# like a classless one.
SLO_CLASSES = ("flagship", "standard", "batch")
SLO_RANK = {"batch": 0, "standard": 1, "flagship": 2}
DEFAULT_SLO = "standard"

# per-class default TTL seconds; the JAX package's default (no
# DPT_TTL_<CLASS>_S set) is no default deadline for any class
CLASS_TTL_S = {"flagship": None, "standard": None, "batch": None}


def class_default_ttl(slo):
    """Per-class default TTL seconds, or None (no default deadline). The
    explicit per-job `ttl_s` always overrides."""
    return CLASS_TTL_S.get(slo)


class JobSpec:
    """Validated job description (the SUBMIT payload).

    Beyond the shape/witness fields, a spec may carry two durability
    knobs (both excluded from the shape key — they change nothing about
    the circuit):
      job_key  client-supplied idempotency key: two SUBMITs with the same
               job_key are ONE job, across retries, reconnects, and
               service restarts (the journal persists the mapping) — the
               duplicate is answered from the existing job or its
               finished-proof artifact, never re-proved.
      ttl_s    deadline budget in seconds from submission: a job that has
               not STARTED proving within its TTL is load-shed with a
               journaled, queryable SHED verdict instead of burning a
               worker on an answer nobody is waiting for.
      slo      serving class, one of SLO_CLASSES (default "standard"):
               decides queue precedence (flagship > standard > batch,
               ahead of the numeric priority), the default deadline
               (class_default_ttl, overridden by ttl_s), and who sheds
               first under pressure (lowest class). Excluded from the
               shape key — a class changes scheduling, never the circuit
               or the proof bytes.
    """

    def __init__(self, kind, params, seed, priority=0, job_key=None,
                 ttl_s=None, slo=DEFAULT_SLO):
        self.kind = kind
        self.params = params  # shape-determining, seed excluded
        self.seed = seed
        self.priority = priority
        self.job_key = job_key
        self.ttl_s = ttl_s
        self.slo = slo

    @classmethod
    def from_wire(cls, obj):
        """Parse + validate an untrusted JSON dict. Raises ValueError with
        a client-presentable reason."""
        if not isinstance(obj, dict):
            raise ValueError("spec must be a JSON object")
        kind = obj.get("kind")
        if kind not in _SPEC_KINDS:
            raise ValueError(f"unknown kind {kind!r} (want one of {_SPEC_KINDS})")
        seed = obj.get("seed", 0)
        priority = obj.get("priority", 0)
        if not isinstance(seed, int) or not isinstance(priority, int):
            raise ValueError("seed and priority must be integers")
        job_key = obj.get("job_key")
        if job_key is not None and not (isinstance(job_key, str)
                                        and 0 < len(job_key) <= 128):
            raise ValueError("job_key must be a 1..128 char string")
        ttl_s = obj.get("ttl_s")
        if ttl_s is not None:
            if not isinstance(ttl_s, (int, float)) or not ttl_s > 0:
                raise ValueError("ttl_s must be a positive number")
            ttl_s = float(ttl_s)
        slo = obj.get("slo", DEFAULT_SLO)
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"slo must be one of {SLO_CLASSES} (got {slo!r})")
        if kind == "toy":
            gates = obj.get("gates")
            if not isinstance(gates, int) or not 1 <= gates <= 1 << 16:
                raise ValueError("toy spec needs 1 <= gates <= 65536")
            params = {"gates": gates}
        elif kind in circuits.REGISTRY:
            params = circuits.validate_params(kind, obj)
        else:
            height = obj.get("height")
            num_proofs = obj.get("num_proofs", 1)
            if not isinstance(height, int) or not 1 <= height <= 64:
                raise ValueError("merkle spec needs 1 <= height <= 64")
            if not isinstance(num_proofs, int) or not 1 <= num_proofs <= 1 << 12:
                raise ValueError("merkle spec needs 1 <= num_proofs <= 4096")
            num_leaves = obj.get("num_leaves")
            if num_leaves is None:
                num_leaves = max(num_proofs, 3)
            if not isinstance(num_leaves, int) or num_leaves < 1:
                raise ValueError("num_leaves must be a positive integer")
            params = {"height": height, "num_proofs": num_proofs,
                      "num_leaves": num_leaves}
        return cls(kind, params, seed, priority, job_key=job_key,
                   ttl_s=ttl_s, slo=slo)

    def to_wire(self):
        out = {"kind": self.kind, "seed": self.seed,
               "priority": self.priority}
        if self.job_key is not None:
            out["job_key"] = self.job_key
        if self.ttl_s is not None:
            out["ttl_s"] = self.ttl_s
        # omitted when standard: a classless client round-trips to the
        # byte-identical wire dict it sent (pre-class servers also parse)
        if self.slo != DEFAULT_SLO:
            out["slo"] = self.slo
        out.update(self.params)
        return out


def shape_key(spec):
    """Bucket key: everything that determines circuit STRUCTURE (and so
    the domain size, SRS, proving key, and compiled stages)."""
    return (spec.kind,) + tuple(sorted(spec.params.items()))


def _toy_circuit(gates, seed):
    rng = random.Random(seed)
    ckt = PlonkCircuit()
    x = ckt.create_public_variable(rng.randrange(1, R_MOD))
    y = ckt.create_public_variable(rng.randrange(1, R_MOD))
    acc = ckt.add(x, y)
    for i in range(gates):
        if i % 3 == 0:
            acc = ckt.mul(acc, x)
        elif i % 3 == 1:
            acc = ckt.add(acc, y)
        else:
            acc = ckt.lc([acc, x, y, acc], [1, 2, 3, 4])
    return ckt


def build_circuit(spec):
    """Spec -> finalized, satisfied circuit (deterministic in the spec)."""
    if spec.kind == "toy":
        ckt = _toy_circuit(spec.params["gates"], spec.seed)
        ok, bad = ckt.check_satisfiability()
        assert ok, f"toy circuit unsatisfied at gate {bad}"
        return ckt.finalize()
    if spec.kind in circuits.REGISTRY:
        return circuits.build(spec.kind, spec.params, spec.seed)
    from ..workload import generate_circuit
    ckt, _tree = generate_circuit(
        rng=random.Random(spec.seed), height=spec.params["height"],
        num_proofs=spec.params["num_proofs"],
        num_leaves=spec.params["num_leaves"])
    return ckt


def build_bucket_keys(spec, device=None):
    """(srs, pk, vk) for a spec's SHAPE: seed-independent, so the server's
    scheduler and a verifying client derive identical keys. Uses the
    canonical seed-0 circuit purely as the structure donor.

    Built on `device` (None: the card, raising without one; "cpu" runs
    the kernels' plain versions): the device SRS of n + 4 powers and the
    preprocess on TorchBackend. The proving key's commit key and
    coefficient handles stay on the device; a prover backend on the same
    device proves with them directly."""
    from .. import kzg
    from ..backend.torch_backend import TorchBackend
    backend = TorchBackend(device)
    canonical = JobSpec(spec.kind, dict(spec.params), seed=0)
    ckt = build_circuit(canonical)
    srs = kzg.universal_setup_device(ckt.n + 3, tau=TEST_TAU,
                                     device=backend.device)
    pk, vk = kzg.preprocess(srs, ckt, backend=backend)
    return srs, pk, vk


# --- job lifecycle -----------------------------------------------------------

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
SHED = "shed"        # deadline/TTL load shedding: a journaled, queryable
                     # verdict (STATUS reports it like done/failed)
TERMINAL = (DONE, FAILED, SHED)

_job_seq = itertools.count(1)
# per-process run token in every job id: ids (and so checkpoint file
# names under a persistent --ckpt-dir) can never collide with a previous
# crashed run's, whose counter also started at 1
_RUN_TOKEN = "%04x" % random.SystemRandom().randrange(1 << 16)


class Job:
    """One submitted proof job. Mutated by exactly one owner at a time
    (server accept thread -> scheduler -> pool worker); `status()` builds
    the externally visible JSON snapshot."""

    def __init__(self, spec, job_id=None):
        # job_id: journal recovery reuses the ORIGINAL id so the job's
        # checkpoint artifact (ckpt:<id>) and finished-proof artifact
        # (proof:<id>) still address its state from the previous process
        self.id = job_id or "job-%s-%06d" % (_RUN_TOKEN, next(_job_seq))
        self.spec = spec
        self.shape_key = shape_key(spec)
        self.priority = spec.priority
        self.job_key = spec.job_key
        self.slo = getattr(spec, "slo", DEFAULT_SLO)
        self.slo_rank = SLO_RANK.get(self.slo, SLO_RANK[DEFAULT_SLO])
        # wall clock, not monotonic: the deadline must survive a service
        # restart (the journal carries it; a recovered job whose TTL
        # expired during the outage is shed, not resumed). Explicit
        # ttl_s wins; otherwise the job's SLO class supplies the default
        ttl = spec.ttl_s if spec.ttl_s is not None \
            else class_default_ttl(self.slo)
        self.deadline_ts = time.time() + ttl if ttl is not None else None
        # every job IS one trace: the id is stamped here (or adopted from
        # the client's trace_ctx by the frontend), handed to the prover
        # tracer, and addresses the merged-timeline artifact trace:<id>
        self.trace_id = new_trace_id()
        self.trace_parent = None    # client-side parent span, if adopted
        self.trace_dump = None      # merged timeline (set at finish_ok)
        self.state = QUEUED
        self.submitted_at = time.monotonic()
        self.submitted_wall = time.time()   # anchors the queue-wait span
        self.scheduled_at = None
        self.started_at = None
        self.finished_at = None
        self.retries = 0
        self.attempts = []     # [{worker, outcome}]
        self.worker = None
        self.batch_id = None
        self.batch_size = None
        # placement verdict (service/placement.py): "batch" (data-parallel
        # cross-job prove), "mesh" (sharded submesh prove), or "pool"
        # (per-job worker dispatch — also the base scheduler's only mode)
        self.placement = None
        self.error = None
        self.proof_bytes = None
        self.public_input = None
        self.round_totals = {}
        self.done_event = threading.Event()

    @property
    def wait_s(self):
        """submit -> first prove start (queue + key-build wait)."""
        if self.started_at is None:
            return time.monotonic() - self.submitted_at
        return self.started_at - self.submitted_at

    @property
    def run_s(self):
        if self.started_at is None:
            return None
        end = self.finished_at or time.monotonic()
        return end - self.started_at

    def finish_ok(self, proof_bytes, public_input, round_totals):
        self.proof_bytes = proof_bytes
        self.public_input = public_input
        self.round_totals = round_totals
        self.state = DONE
        self.finished_at = time.monotonic()
        self.done_event.set()

    def finish_err(self, reason):
        self.error = reason
        self.state = FAILED
        self.finished_at = time.monotonic()
        self.done_event.set()

    def finish_shed(self, reason):
        """Terminal load-shed verdict (deadline/TTL): clients polling
        STATUS see state=shed + the reason, same shape as a failure."""
        self.error = reason
        self.state = SHED
        self.finished_at = time.monotonic()
        self.done_event.set()

    def expired(self, now=None):
        """True once the job's TTL deadline has passed (never for jobs
        without one). Checked before key build and before each prove
        attempt — not during one (a started prove is worth finishing:
        its result is cacheable under the job_key)."""
        if self.deadline_ts is None:
            return False
        return (now if now is not None else time.time()) > self.deadline_ts

    def status(self):
        return {
            "job_id": self.id,
            "state": self.state,
            "trace_id": self.trace_id,
            "trace_spans": (len(self.trace_dump.get("events") or [])
                            if self.trace_dump else None),
            "spec": self.spec.to_wire(),
            "shape_key": [str(p) for p in self.shape_key],
            "priority": self.priority,
            "slo": self.slo,
            "job_key": self.job_key,
            "deadline_ts": self.deadline_ts,
            "retries": self.retries,
            "attempts": list(self.attempts),
            "worker": self.worker,
            "batch_id": self.batch_id,
            "batch_size": self.batch_size,
            "placement": self.placement,
            "wait_s": round(self.wait_s, 6),
            "run_s": None if self.run_s is None else round(self.run_s, 6),
            "rounds": {k: round(v, 6) for k, v in self.round_totals.items()},
            "error": self.error,
        }
