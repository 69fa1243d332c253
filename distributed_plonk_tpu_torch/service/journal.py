"""Crash-safe write-ahead job journal for the proof frontend (a copy of the
JAX package's service/journal.py).

The service process's own crash safety (the reference's sequential
dispatcher unwrap-panics and loses everything in flight). The service's
queue and job table are
in-memory; every state transition that matters is therefore journaled
here FIRST, so a frontend crash or deploy restart loses nothing:

    SUBMIT  job admitted (spec, idempotency key, deadline) — written
            before the job enters the in-memory queue (write-ahead)
    START   a prover attempt began (worker name)
    ROUND   round N's checkpoint snapshot is durable (store/ckpt-file) —
            appended AFTER the snapshot write, so a journaled ROUND N is a
            promise that resume-from-round-N state exists
    DONE    proof finished; the record carries the finished-proof store
            artifact's key+digest (or the raw bytes inline when the
            service has no store), the public input, and retry count
    SHED    deadline/TTL load shedding verdict (queryable by clients)
    FAILED  terminal failure (reason)

A restarted service replays the journal (`JobJournal(dir)` replays on
open), re-enqueues every non-terminal job under its ORIGINAL id — so its
`ckpt:<job_id>` checkpoint artifact still matches and the prove resumes at
the last round boundary with zero recompute — and serves DONE jobs from
their finished-proof artifacts without re-proving.

Durability model:
- One append-only file `journal.log`; each record is one line
  `crc32(json) json\n`, flushed + fsync'd before append() returns
  (fsync=False trades durability for speed in tests).
- Torn/corrupt tail (power cut mid-append, bit rot): replay keeps the
  longest valid prefix, TRUNCATES the file there, counts
  journal_torn_records, and continues — never crashes, never trusts a
  damaged suffix (append-only means damage can only be a suffix).
- Store-backed compaction: every COMPACT_EVERY appends (and
  once after each replay) the log is rewritten from live state — one
  SUBMIT(+ROUND/terminal) line per job, oldest terminal jobs beyond
  `retain_terminal` dropped. Payloads never bloat the log: proofs and
  checkpoints live in the artifact store; the journal only carries keys
  and digests.

Metrics (duck-typed inc): journal_appends, journal_replays,
journal_torn_records, journal_compactions.
"""

import json
import logging
import os
import threading
import zlib

from ..runtime.health import NullMetrics

log = logging.getLogger("dpt.journal")

# record types
SUBMIT = "SUBMIT"
START = "START"
ROUND = "ROUND"
DONE = "DONE"
SHED = "SHED"
FAILED = "FAILED"
AGG = "AGG"      # aggregate artifact built: id is the
                 # aggregate's content-addressed agg_id (NOT a job id);
                 # the record carries the member job ids and the
                 # artifact's store key+digest (or the JSON blob inline
                 # hex when the service has no store) — recovery re-serves
                 # the aggregate exactly like a DONE job's proof

# replayed-state phases that mean "no further records will follow"
# ("aggregate" rides along so compaction's retain_terminal bounds the
# journal's memory of old aggregates the same way it bounds old jobs)
TERMINAL_PHASES = ("done", "shed", "failed", "aggregate")

# SHED-record reason prefix for admission-control rejections: the client
# was told 'no' synchronously, so recovery keeps the verdict queryable
# by id but must NOT bind the job_key to it (a live retry of the key is
# a fresh admission attempt, matching the non-restart path)
REJECTED_PREFIX = "rejected: "

# the JAX package's DPT_JOURNAL_COMPACT_EVERY default
COMPACT_EVERY = 512


def record_label(rtype, rec):
    """Chaos-rule label for one record: ROUND records carry their round
    number (kill:at=journal:tag=ROUND2 dies after round 2's append),
    everything else is the bare type."""
    if rtype == ROUND:
        return f"{ROUND}{rec.get('round')}"
    return rtype


class JobJournal:
    """Append-only journal + the replayed job-state map it implies.

    `state` maps job_id -> {spec, key, deadline, submitted, phase, round,
    worker, done, reason} in SUBMIT order; `phase` is the lowercase last
    record type. The service reads `state` once at recovery and appends
    transitions forever after; the journal itself is the only component
    that parses the file.
    """

    def __init__(self, journal_dir, metrics=None, fsync=True,
                 retain_terminal=4096, chaos=None):
        self.dir = journal_dir
        self.path = os.path.join(journal_dir, "journal.log")
        self.metrics = metrics or NullMetrics()
        self.fsync = fsync
        self.retain_terminal = retain_terminal
        # chaos: runtime.faults.FaultInjector (or None). Its journal-plane
        # rules run after each record is DURABLE — "kill the service right
        # after journal occurrence X" is the restart-recovery test plane.
        self.chaos = chaos
        self._lock = threading.Lock()
        self._sealed = False
        self._since_compact = 0
        os.makedirs(journal_dir, exist_ok=True)
        self.state = {}
        self._replay()
        self._f = open(self.path, "ab")

    # -- replay ---------------------------------------------------------------

    def _replay(self):
        """Load the valid record prefix into `state`; truncate any torn or
        corrupt tail in place (append-only file: damage is always a
        suffix; the prefix before it is still the true history)."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return
        good_end = 0
        replayed = 0
        torn = False
        for line in raw.split(b"\n")[:-1]:
            rec = self._parse(line)
            if rec is None:
                torn = True
                break
            self._apply(rec)
            replayed += 1
            good_end += len(line) + 1
        if good_end < len(raw):
            # tail beyond the last valid record: torn final append, bit
            # rot, or a missing trailing newline — drop it and continue
            torn = True
        if torn:
            log.warning("journal %s: dropping %d damaged tail bytes "
                        "(%d valid records kept)", self.path,
                        len(raw) - good_end, replayed)
            self.metrics.inc("journal_torn_records")
            with open(self.path, "r+b") as f:
                f.truncate(good_end)
        if replayed:
            self.metrics.inc("journal_replays", replayed)

    @staticmethod
    def _parse(line):
        """One journal line -> record dict, or None if damaged."""
        head, sep, body = line.partition(b" ")
        if not sep or len(head) != 8:
            return None
        try:
            want = int(head, 16)
        except ValueError:
            return None
        if zlib.crc32(body) != want:
            return None
        try:
            rec = json.loads(body.decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            return None
        return rec if isinstance(rec, dict) and "t" in rec else None

    def _apply(self, rec):
        """Fold one record into the state map."""
        rtype, jid = rec.get("t"), rec.get("id")
        if jid is None:
            return
        if rtype == AGG:
            # aggregates are their own single-record state entries: no
            # SUBMIT precedes them, and no later record ever follows
            self.state[jid] = {
                "spec": None, "key": None, "deadline": None,
                "submitted": rec.get("ts"), "trace": None,
                "trace_parent": None, "phase": "aggregate", "round": 0,
                "worker": None, "reason": None,
                "done": {k: rec.get(k) for k in
                         ("members", "store_key", "digest", "agg_hex")},
            }
            return
        st = self.state.get(jid)
        if st is None:
            if rtype != SUBMIT:
                # record for a job whose SUBMIT was compacted away or lost
                # to a torn tail: tolerate (recovery treats unknown-spec
                # jobs as unrecoverable, never crashes)
                return
            self.state[jid] = {
                "spec": rec.get("spec"), "key": rec.get("key"),
                "deadline": rec.get("deadline"),
                "submitted": rec.get("ts"),
                # trace identity survives a restart: the client was told
                # this id at SUBMIT, so the recovered job (and its
                # trace:<job_id> artifact) must keep answering to it
                "trace": rec.get("trace"),
                "trace_parent": rec.get("trace_parent"),
                "phase": "submit", "round": 0, "worker": None,
                "done": None, "reason": None,
            }
            return
        if rtype == START:
            st["phase"] = "start"
            st["worker"] = rec.get("worker")
        elif rtype == ROUND:
            st["phase"] = "round"
            st["round"] = max(st["round"], int(rec.get("round") or 0))
        elif rtype == DONE:
            st["phase"] = "done"
            st["done"] = {k: rec.get(k) for k in
                          ("store_key", "digest", "proof_hex", "pub",
                           "retries")}
        elif rtype in (SHED, FAILED):
            st["phase"] = rtype.lower()
            st["reason"] = rec.get("reason")

    # -- append ---------------------------------------------------------------

    def append(self, rtype, job_id, **fields):
        """Durably journal one transition; returns False when sealed
        (crashed service — the in-process analog of a dead process writes
        nothing). The chaos hook runs AFTER the fsync, outside the lock:
        a journal-plane kill models a crash at exactly this occurrence,
        with this record on disk and nothing after it."""
        rec = dict(fields)
        rec["t"] = rtype
        rec["id"] = job_id
        with self._lock:
            if self._sealed:
                return False
            self._apply(rec)
            body = json.dumps(rec, separators=(",", ":")).encode()
            self._f.write(b"%08x " % zlib.crc32(body) + body + b"\n")
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self.metrics.inc("journal_appends")
            self._since_compact += 1
            if self._since_compact >= COMPACT_EVERY:
                self._compact_locked()
        if self.chaos is not None:
            self.chaos.on_journal(rtype, record_label(rtype, rec),
                                  job_id=job_id)
        return True

    # -- compaction -----------------------------------------------------------

    def compact(self):
        """Rewrite the log from live state (one line per surviving job),
        dropping the oldest terminal jobs beyond `retain_terminal` — their
        proof artifacts stay in the store; only the journal's memory of
        them is bounded. Atomic (tmp + fsync + rename)."""
        with self._lock:
            if not self._sealed:
                self._compact_locked()

    def _compact_locked(self):
        terminal = [j for j, st in self.state.items()
                    if st["phase"] in TERMINAL_PHASES]
        for jid in terminal[:max(0, len(terminal) - self.retain_terminal)]:
            del self.state[jid]
        tmp = self.path + ".tmp.%d" % os.getpid()
        with open(tmp, "wb") as f:
            for jid, st in self.state.items():
                for rec in self._state_records(jid, st):
                    body = json.dumps(rec, separators=(",", ":")).encode()
                    f.write(b"%08x " % zlib.crc32(body) + body + b"\n")
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self._since_compact = 0
        self.metrics.inc("journal_compactions")

    @staticmethod
    def _state_records(jid, st):
        """Minimal record sequence that replays back to `st`."""
        if st["phase"] == "aggregate":
            rec = {"t": AGG, "id": jid, "ts": st["submitted"]}
            rec.update({k: v for k, v in (st["done"] or {}).items()
                        if v is not None})
            yield rec
            return
        sub = {"t": SUBMIT, "id": jid, "spec": st["spec"],
               "key": st["key"], "deadline": st["deadline"],
               "ts": st["submitted"]}
        for k in ("trace", "trace_parent"):
            if st.get(k) is not None:
                sub[k] = st[k]
        yield sub
        if st["round"]:
            yield {"t": ROUND, "id": jid, "round": st["round"]}
        if st["phase"] == "done":
            rec = {"t": DONE, "id": jid}
            rec.update({k: v for k, v in (st["done"] or {}).items()
                        if v is not None})
            yield rec
        elif st["phase"] in ("shed", "failed"):
            yield {"t": st["phase"].upper(), "id": jid,
                   "reason": st["reason"]}

    # -- lifecycle ------------------------------------------------------------

    def seal(self):
        """Crash simulation (ProofService.crash / tests): stop writing as
        a SIGKILL'd process would — whatever is on disk now is exactly
        what a restarted service will see."""
        with self._lock:
            self._sealed = True
            try:
                self._f.close()
            except OSError:  # pragma: no cover - already closed
                pass

    def close(self):
        """Clean shutdown: flush + fsync + close (drain's last step)."""
        with self._lock:
            if self._sealed:
                return
            self._sealed = True
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
