"""Deterministic chaos injection for the proof service (a copy of the JAX
package's runtime/faults.py, its service planes only).

One injector object threads through the service's failure planes:

  checkpoint plane (`at=round`, service/pool.py): `on_round(round_no,
      checkpoint)` runs at every prover round boundary, after the snapshot
      is durable. Actions:
        delay         sleep `ms` (slow prover)
        corrupt_ckpt  flip a byte inside the just-written snapshot
                      (checkpoint.chaos_corrupt()): the integrity layer
                      (SHA-256 in the store, zip/manifest validation on
                      files) must detect it and restart the prove cleanly
                      rather than resume garbage

  proof plane (`at=proof`, service/pool.py): `on_proof(job_id)` runs in
      the service right after a finished proof is serialized and BEFORE
      the verify-before-serve gate: silent data corruption between prove
      and serve. The pool flips a byte in the proof bytes; the
      self-verify gate must block it from ever reaching a journal DONE
      record or a client:
        "corrupt:at=proof"

  journal plane (`at=journal`, service/journal.py): `on_journal(rtype,
      label, job_id)` runs right after each job-journal record is
      DURABLE. `tag` matches the record type ("SUBMIT", "START", "ROUND",
      "DONE", "SHED", "FAILED") or a round-qualified label ("ROUND2").
      Actions:
        kill    invoke the kill callback (a service's crash(), or a daemon's
                process exit): the record is on disk, nothing after it is
        delay   sleep `ms` (slow journal device)

Not ported: the dispatcher's wire and proc planes and the worker's
`at=data` plane (the port's fleet tests plant faults on the dispatcher's
side instead). A rule on one of them raises ValueError. Rules come from
code; `Rule.parse` reads the JAX package's text form:

    "kill:at=journal:tag=ROUND2"
    "corrupt_ckpt:tag=2"
    "corrupt:at=proof:nth=1"

Entries are `action[:key=value]*`. Keys: tag (a round number, or on the
journal plane a record label string), nth (1-based occurrence; default
1), rate (probability, overrides nth), ms, max (max fires, default 1 for
nth rules, unlimited for rate rules), at (plane: round | journal |
proof). Occurrence counting is per rule and thread-safe.
"""

import random
import threading
import time

# the planes the port runs; the JAX package's wire, proc and data planes
# have no hook in the port
PLANES = ("round", "journal", "proof")


class Rule:
    def __init__(self, action, tag=None, worker=None, nth=1, rate=None,
                 ms=0.0, max_fires=None, plane=None):
        if action not in ("kill", "drop", "corrupt", "delay",
                          "corrupt_ckpt"):
            raise ValueError(f"unknown fault action {action!r}")
        self.action = action
        self.tag = tag          # round no (round) / record label (journal)
        self.worker = worker    # worker index, or None = any
        self.nth = nth          # 1-based matching-occurrence to fire on
        self.rate = rate        # probability per occurrence (overrides nth)
        self.ms = ms
        # which hook runs the rule: corrupt_ckpt only makes sense at round
        # boundaries; the JAX package's default for the others is its wire
        # plane, which the port does not have
        self.plane = plane or ("round" if action == "corrupt_ckpt" else "wire")
        if self.plane not in PLANES:
            raise ValueError(f"fault plane {self.plane!r} not ported "
                             f"(the port runs {PLANES})")
        if max_fires is None:
            max_fires = None if rate is not None else 1
        self.max_fires = max_fires
        self.seen = 0
        self.fired = 0

    def matches(self, tag=None, worker=None):
        if self.max_fires is not None and self.fired >= self.max_fires:
            return False
        if self.tag is not None and tag != self.tag:
            return False
        if self.worker is not None and worker is not None \
                and worker != self.worker:
            return False
        return True

    @classmethod
    def parse(cls, entry):
        """'kill:at=journal:tag=ROUND2' -> Rule. Journal rules keep the
        record-label STRING; on the round plane the tag is a round
        number."""
        parts = entry.strip().split(":")
        action, kvs = parts[0], parts[1:]
        kw = {}
        tag_raw = None
        for kv in kvs:
            k, _, v = kv.partition("=")
            k = k.strip()
            v = v.strip()
            if k == "tag":
                tag_raw = v
            elif k == "worker":
                kw["worker"] = int(v)
            elif k == "nth":
                kw["nth"] = int(v)
            elif k == "rate":
                kw["rate"] = float(v)
            elif k == "ms":
                kw["ms"] = float(v)
            elif k == "max":
                kw["max_fires"] = int(v)
            elif k == "at":
                kw["plane"] = v
            else:
                raise ValueError(f"unknown fault key {k!r} in {entry!r}")
        if tag_raw is not None:
            kw["tag"] = tag_raw if kw.get("plane") == "journal" \
                else int(tag_raw)
        return cls(action, **kw)


class FaultInjector:
    """Holds the rule set + side-effect callbacks; thread-safe.

    kill_cb(label): registered by the harness that owns the service
    (ProofService.crash in tests and chip_smoke.py). metrics: duck-typed
    inc() (service.metrics.Metrics; a service adopts an injector built
    without one). rng: rate-based decisions (seed it for reproducible
    soaks)."""

    def __init__(self, rules=None, kill_cb=None, metrics=None, rng=None):
        self.rules = list(rules or [])
        self.kill_cb = kill_cb
        self.metrics = metrics
        self._rng = rng or random.Random()
        self._lock = threading.Lock()

    def _inc(self, name):
        if self.metrics is not None:
            self.metrics.inc(name)

    def _due(self, rule, tag=None, worker=None):
        """Occurrence bookkeeping under the lock; returns True to fire."""
        with self._lock:
            if not rule.matches(tag=tag, worker=worker):
                return False
            rule.seen += 1
            if rule.rate is not None:
                fire = self._rng.random() < rule.rate
            else:
                fire = rule.seen == rule.nth
            if fire:
                rule.fired += 1
            return fire

    # -- proof plane (service, post-serialize) --------------------------------

    def on_proof(self, job_id=None):
        """True when a `corrupt:at=proof` rule fires for this finished
        proof: the pool flips a byte in the serialized proof before the
        verify-before-serve gate sees it."""
        fired = False
        for rule in self.rules:
            if rule.plane != "proof" or rule.action != "corrupt":
                continue
            if not self._due(rule, tag=rule.tag):
                continue
            self._inc("faults_injected_corrupt")
            fired = True
        return fired

    # -- checkpoint plane (prover pool) ---------------------------------------

    def on_round(self, round_no, checkpoint=None):
        """Round-boundary hook: `tag` in rules is interpreted as the round
        number here (tag=2 -> after round 2), None = every round."""
        for rule in self.rules:
            if rule.plane != "round":
                continue
            if not self._due(rule, tag=round_no):
                continue
            self._inc(f"faults_injected_{rule.action}")
            if rule.action == "delay":
                time.sleep(rule.ms / 1000.0)
            elif rule.action == "corrupt_ckpt" and checkpoint is not None:
                if checkpoint.chaos_corrupt():
                    self._inc("faults_ckpt_corrupted")

    # -- journal plane (proof-service job journal) ----------------------------

    def on_journal(self, rtype, label, job_id=None):
        """Post-append hook: `tag` in journal rules matches either the
        bare record type ("ROUND": any round) or the qualified label
        ("ROUND2": that round exactly). The record is already durable
        when this runs, so a kill here models a crash with this
        transition journaled and nothing after it."""
        for rule in self.rules:
            if rule.plane != "journal":
                continue
            if rule.tag is not None and rule.tag not in (rtype, label):
                continue
            # tag match done above (two aliases per occurrence); _due only
            # does the nth/rate/max bookkeeping
            if not self._due(rule, tag=rule.tag):
                continue
            self._inc(f"faults_injected_{rule.action}")
            if rule.action == "delay":
                time.sleep(rule.ms / 1000.0)
            elif rule.action == "kill":
                if self.kill_cb is not None:
                    self.kill_cb(label)

    def counts(self):
        with self._lock:
            return {f"{r.action}@{r.tag}": {"seen": r.seen, "fired": r.fired}
                    for r in self.rules}
