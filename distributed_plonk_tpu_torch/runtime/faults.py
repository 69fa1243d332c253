"""Deterministic chaos injection for the distributed prover and the proof
service (a copy of the JAX package's runtime/faults.py).

One injector object threads through every failure plane:

  wire plane (runtime/dispatcher.py): `on_send(worker, tag, payload)` runs
      just before every dispatcher->worker frame. Rules select a protocol
      tag + worker + Nth occurrence (deterministic: a chaos test kills a
      worker at exactly one protocol phase per run) or a probability.
      Actions:
        kill     invoke the registered kill callback
        drop     raise InjectedDrop (a ConnectionError) without sending:
                 the frame "was lost"; the handle's reconnect path must
                 resend (worker handlers are idempotent)
        corrupt  scramble the frame TAG so the receiver rejects it loudly
                 (ERR "unknown tag")
        delay    sleep `ms` (slow worker / congested link)

  proc plane (`at=proc`): rides the same on_send occurrence matching as
      the wire plane, but `kill` invokes `proc_kill_cb`, which the
      supervisor registers as a real SIGKILL of the worker SUBPROCESS
      (runtime/supervisor.py `proc_killer`), so a chaos run exercises the
      supervisor's detect -> respawn -> rejoin path:
        "kill:at=proc:tag=FFT1:worker=1:nth=1"

  data plane (`at=data`, runtime/worker.py): `on_data(worker, tag)` runs
      WORKER-SIDE, right after a result is computed and before it is
      framed: the silent-data-corruption model. The worker perturbs its
      OWN computed value (MSM partial += G1 generator; FFT2 panel / NTT /
      EVAL element += 1 mod r), a well-formed wrong answer that only the
      result-integrity plane (runtime/integrity.py) can catch. `worker`
      matches the worker's own fleet index; the port's worker takes the
      rule text as `--faults RULES`:
        "corrupt:at=data:tag=MSM:rate=1"

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

Rules come from code or from the JAX package's text form (`parse_rules`
splits entries on `;`):

    "kill:tag=FFT1:worker=1:nth=1;delay:tag=MSM:ms=20"
    "kill:at=journal:tag=ROUND2"
    "corrupt_ckpt:tag=2"

Entries are `action[:key=value]*`. Keys: tag (a protocol tag name or
number, a round number, or on the journal plane a record label string),
worker, nth (1-based occurrence; default 1), rate (probability, overrides
nth), ms, max (max fires, default 1 for nth rules, unlimited for rate
rules), at (plane: wire | proc | data | round | journal | proof).
Occurrence counting is per rule and thread-safe.
"""

import random
import threading
import time

from . import protocol

PLANES = ("wire", "proc", "data", "round", "journal", "proof")


class InjectedDrop(ConnectionError):
    """A frame the injector 'lost' before it hit the socket."""


# scrambling the tag keeps the frame well-formed but unroutable, so the
# receiver's reply is a deterministic ERR (unknown tag), never a silently
# wrong computation
_CORRUPT_TAG_XOR = 0x40000000

_TAG_NAMES = {name: value for name, value in vars(protocol).items()
              if name.isupper() and isinstance(value, int)}


class Rule:
    def __init__(self, action, tag=None, worker=None, nth=1, rate=None,
                 ms=0.0, max_fires=None, plane=None):
        if action not in ("kill", "drop", "corrupt", "delay",
                          "corrupt_ckpt"):
            raise ValueError(f"unknown fault action {action!r}")
        self.action = action
        self.tag = tag          # protocol tag / round no / record label
        self.worker = worker    # worker index, or None = any
        self.nth = nth          # 1-based matching-occurrence to fire on
        self.rate = rate        # probability per occurrence (overrides nth)
        self.ms = ms
        # which hook runs the rule: corrupt_ckpt only makes sense at round
        # boundaries; everything else defaults to the wire
        self.plane = plane or ("round" if action == "corrupt_ckpt" else "wire")
        if self.plane not in PLANES:
            raise ValueError(f"unknown fault plane {self.plane!r}")
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
        """'kill:tag=FFT1:worker=1:nth=2' -> Rule. Tag resolution is
        plane-aware (after all keys are read, since `at=` may follow
        `tag=`): journal rules keep the record-label STRING ("SUBMIT" is
        both a protocol tag name and a journal record type); elsewhere a
        protocol tag name resolves to its number."""
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
            if kw.get("plane") == "journal":
                kw["tag"] = tag_raw                 # record label string
            elif tag_raw in _TAG_NAMES:
                kw["tag"] = _TAG_NAMES[tag_raw]     # protocol tag name
            else:
                kw["tag"] = int(tag_raw)
        return cls(action, **kw)


def parse_rules(spec):
    """'rule;rule;...' -> [Rule] (empty entries skipped)."""
    return [Rule.parse(e) for e in (spec or "").split(";") if e.strip()]


class FaultInjector:
    """Holds the rule set + side-effect callbacks; thread-safe.

    kill_cb(worker index | journal label): registered by the harness that
    owns the worker processes or the service (ProofService.crash in tests
    and chip_smoke.py). proc_kill_cb(worker index): the proc plane's
    SIGKILL of the worker subprocess (WorkerSupervisor.proc_killer); the
    proc plane falls back to kill_cb when it is unset. metrics:
    duck-typed inc() (service.metrics.Metrics; a service adopts an
    injector built without one). rng: rate-based decisions (seed it for
    reproducible soaks)."""

    def __init__(self, rules=None, kill_cb=None, metrics=None, rng=None,
                 proc_kill_cb=None):
        self.rules = list(rules or [])
        self.kill_cb = kill_cb
        self.proc_kill_cb = proc_kill_cb
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

    # -- wire and proc planes (dispatcher) ------------------------------------

    def on_send(self, worker, tag, payload):
        """Run matching wire and proc rules; returns the (possibly
        corrupted) tag. May sleep (delay), raise InjectedDrop (drop), or
        kill the worker out from under the send (kill)."""
        for rule in self.rules:
            if rule.plane not in ("wire", "proc"):
                continue
            if not self._due(rule, tag=tag, worker=worker):
                continue
            self._inc(f"faults_injected_{rule.action}")
            if rule.action == "delay":
                time.sleep(rule.ms / 1000.0)
            elif rule.action == "drop":
                raise InjectedDrop(
                    f"injected drop of tag {tag} to worker {worker}")
            elif rule.action == "corrupt":
                tag = tag ^ _CORRUPT_TAG_XOR
            elif rule.action == "kill":
                cb = (self.proc_kill_cb or self.kill_cb) \
                    if rule.plane == "proc" else self.kill_cb
                if cb is not None:
                    cb(worker)
        return tag

    # -- data plane (worker-side SDC) -----------------------------------------

    def on_data(self, worker, tag):
        """Worker-side hook, run between 'result computed' and 'result
        framed': True when a matching `corrupt:at=data` rule fires; the
        caller then perturbs the value it just computed."""
        fired = False
        for rule in self.rules:
            if rule.plane != "data" or rule.action != "corrupt":
                continue
            if not self._due(rule, tag=tag, worker=worker):
                continue
            self._inc("faults_injected_corrupt")
            fired = True
        return fired

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
