"""Dynamic fleet membership: an epoch-numbered worker table and its JOIN
plane (a copy of the JAX package's runtime/membership.py).

The reference hard-codes its worker set at startup and panics on a loss
(reference src/worker.rs:303). This module makes the fleet's composition
dynamic:

    MembershipRegistry   owned by the Dispatcher: the epoch-numbered
        member table. Every change (join / rejoin / leave) bumps `epoch`
        and pushes the new roster to the live workers, so FFT2_PREPARE
        peer routing follows membership and frames planned against an
        older roster are rejected as stale (FFT_INIT carries the epoch;
        the dispatcher then replans at the current width).
    MembershipServer     a listener serving the registry over the native
        framed transport (JOIN / LEAVE / ROSTER): a worker started with
        `--join host:port` announces itself here, receives its index,
        epoch and peer roster, and is schedulable from that moment. The
        sharded FFT replans up to the wider fleet at its next phase
        boundary, and a rejoining worker's MSM range is re-provisioned
        through the dispatcher's re-admission path.

Index stability is the invariant: a member's fleet index never moves and
is never reused. Joins append; a known (host, port) re-joins IN PLACE;
leaves keep the slot (zero-width ranges, breaker open), so col_ranges
tables and peer routing always index by fleet position.

A member LEAVEd by the result-integrity plane (reason="integrity") has
its ADDRESS quarantined: its next JOIN stays suspect (unschedulable)
until the dispatcher's known-answer challenge passes (`_challenge`,
Dispatcher.run_challenge); a failed challenge LEAVEs it again.

Store-serving members (`--store`) are advertised in the roster's
`stores` list: joiners warm-rejoin from them (store/remote.warm_sync:
bucket-key artifacts over STORE_FETCH), and a ProofService attached with
`attach_membership` registers them as BucketCache peers.

Counters and gauges land in the duck-typed metrics registry:
membership_joins / membership_rejoins / membership_leaves /
roster_pushes / warm_rejoins, the warm_rejoin_s observation,
fleet_size / membership_epoch. With a tracer armed, joins and leaves
land as zero-duration spans (`membership/join`, `membership/leave`).
"""

import threading
import time

from . import native, protocol
from .health import NullMetrics
from ..obs import log as olog


class MembershipRegistry:
    """The dispatcher's member table. All mutation runs under one lock;
    the dispatcher's own structures (workers list, tracker) only ever
    GROW, and they grow here, so concurrent proves observe either the
    old or the new width — never a torn table."""

    def __init__(self, dispatcher, metrics=None, tracer=None):
        self.d = dispatcher
        self.metrics = metrics or NullMetrics()
        self.tracer = tracer
        self._lock = threading.RLock()
        self.epoch = 1
        # index -> True for members that answer STORE_FETCH/STORE_LIST
        self.stores = {}
        # indices declared permanently gone by LEAVE: the dispatcher's
        # half-open probe loop must NOT re-admit these (a decommissioned
        # address may still answer probes), and must stop dialing them
        self.left = set()
        # (host, port) addresses LEAVEd by the result-integrity plane
        # (reason="integrity"): a fresh JOIN from one of these is only
        # SCHEDULABLE after the known-answer challenge passes
        # (Dispatcher.run_challenge) — a wrong-answer worker must not
        # re-enter service just by answering its own JOIN
        self.quarantined = set()
        self._listeners = []
        self._publish()

    # -- read side ------------------------------------------------------------

    def addresses(self):
        with self._lock:
            return [(w.host, w.port) for w in self.d.workers]

    def store_peers(self):
        """[(host, port)] of members advertising a store."""
        with self._lock:
            return [(self.d.workers[i].host, self.d.workers[i].port)
                    for i in sorted(self.stores)
                    if self.stores[i] and i < len(self.d.workers)]

    def roster(self):
        with self._lock:
            return {
                "epoch": self.epoch,
                "workers": [f"{h}:{p}" for h, p in self.addresses()],
                "stores": [f"{h}:{p}" for h, p in self.store_peers()],
            }

    def subscribe(self, fn):
        """fn(event dict) after every membership change — how a
        ProofService auto-registers store-serving joiners as bucket-cache
        peers without the registry knowing the service exists."""
        with self._lock:
            self._listeners.append(fn)

    # -- mutation -------------------------------------------------------------

    def join(self, host, port, store=False, phase=None, stats=None):
        """Admit (or re-admit) a member; returns the JOIN reply dict.

        phase="ready" is the post-warm-sync update from a worker that
        already joined: it records the reported warm-rejoin stats and
        returns the current roster WITHOUT bumping the epoch."""
        port = int(port)
        if phase == "ready":
            return self._ready(host, port, stats or {})
        with self._lock:
            index = self._find(host, port)
            rejoin = index is not None
            challenged = (host, port) in self.quarantined \
                and getattr(self.d, "integrity", None) is not None
            if rejoin:
                self.left.discard(index)  # an explicit JOIN un-leaves
                self._readmit(index, challenged=challenged)
            else:
                index = self.d.adopt_worker(host, port)
                if challenged:
                    # a quarantined ADDRESS coming back under a fresh
                    # slot is still gated (shouldn't happen — rejoins
                    # land in place — but the gate must not be evadable)
                    self.d.tracker.mark_suspect(index)
                    self.d.pool.submit(self._challenge, index, host, port)
            if store:
                self.stores[index] = True
            self.epoch += 1
            self.metrics.inc(
                "membership_rejoins" if rejoin else "membership_joins")
            self._publish()
            reply = dict(self.roster(), index=index)
            event = {"event": "join", "index": index, "host": host,
                     "port": port, "store": bool(store), "rejoin": rejoin,
                     "epoch": self.epoch}
        self._emit("membership/join", event)
        self._push_roster(exclude=index)
        return reply

    def leave(self, index=None, host=None, port=None, reason=None):
        """Declare a member permanently gone (flap cap / decommission /
        integrity quarantine): breaker opened immediately, epoch bumped,
        slot retained. reason="integrity" additionally quarantines the
        ADDRESS: its next JOIN is challenge-gated, and an attached
        supervisor kills the (alive but lying) process so it respawns
        clean."""
        with self._lock:
            if index is None:
                index = self._find(host, int(port))
            if index is None or not 0 <= index < len(self.d.workers):
                raise LookupError(f"unknown member {host}:{port}")
            w = self.d.workers[index]
            self.left.add(index)
            self.d.tracker.mark_dead(index)
            w.drop_conn()
            self.stores.pop(index, None)
            if reason == "integrity":
                self.quarantined.add((w.host, w.port))
            self.epoch += 1
            self.metrics.inc("membership_leaves")
            self._publish()
            event = {"event": "leave", "index": index, "host": w.host,
                     "port": w.port, "epoch": self.epoch,
                     "reason": reason}
        self._emit("membership/leave", event)
        self._push_roster(exclude=index)
        return {"epoch": self.epoch, "index": index}

    def is_left(self, index):
        """True for a member declared permanently gone: the dispatcher's
        re-admission planes skip it (only an explicit JOIN revives it)."""
        with self._lock:
            return index in self.left

    # -- internals ------------------------------------------------------------

    def _find(self, host, port):
        for i, w in enumerate(self.d.workers):
            if w.host == host and w.port == port:
                return i
        return None

    def _readmit(self, index, challenged=False):
        """Re-admission through the dispatcher's path: fresh stream, breaker
        closed (counts fleet_readmissions when it was open), and the
        member's original MSM base range re-provisioned so routing
        rebalances off the adopter. The re-provision runs on the
        dispatcher's executor AFTER the JOIN reply goes out: the joiner
        is still blocked on that reply and not yet serving, so an inline
        INIT_BASES here would deadlock the whole membership plane until
        the call timeout (found live: the supervisor then wedge-killed
        the healthy rejoiner in a loop).

        challenged=True (the address was quarantined by the integrity
        plane): the member STAYS suspect — unschedulable — until the
        async known-answer challenge passes; same deadlock rationale,
        the challenge dials the joiner after the reply goes out."""
        w = self.d.workers[index]
        w.drop_conn()
        if challenged:
            self.d.tracker.mark_suspect(index)  # idempotent; stays dark
            self.d.pool.submit(self._challenge, index, w.host, w.port)
            return
        self.d.tracker.record_ok(index)
        self.d.pool.submit(self.d._reprovision, index)

    def _challenge(self, index, host, port):
        """Async challenge gate for a quarantined address's fresh JOIN:
        pass -> absolved (suspect cleared, schedulable, range
        re-provisioned); fail -> LEAVEd again, still quarantined — a
        worker that still serves wrong answers never re-enters service."""
        try:
            ok = self.d.run_challenge(host, port)
        except Exception:
            ok = False
        if ok:
            with self._lock:
                self.quarantined.discard((host, port))
            self.d.tracker.clear_suspect(index)
            self.d.tracker.record_ok(index)
            self.d._reprovision(index)
            self._emit("membership/challenge_passed",
                       {"event": "challenge_passed", "index": index,
                        "host": host, "port": port})
        else:
            try:
                self.leave(index=index, reason="integrity")
            except Exception:
                pass
            self._emit("membership/challenge_failed",
                       {"event": "challenge_failed", "index": index,
                        "host": host, "port": port})

    def _ready(self, host, port, stats):
        with self._lock:
            index = self._find(host, port)
            if index is None:
                raise LookupError(f"ready from non-member {host}:{port}")
            v = stats.get("warm_rejoin_s")
            if isinstance(v, (int, float)):
                self.metrics.observe("warm_rejoin_s", float(v))
                self.metrics.inc("warm_rejoins")
            event = {"event": "ready", "index": index, "stats": stats,
                     "epoch": self.epoch}
            reply = dict(self.roster(), index=index)
        self._emit("membership/ready", event)
        return reply

    def _publish(self):
        self.metrics.gauge("fleet_size", len(self.d.workers))
        self.metrics.gauge("membership_epoch", self.epoch)

    def _emit(self, span, event):
        attrs = {k: v for k, v in event.items()
                 if k != "event" and isinstance(v, (int, float, str, bool))}
        kind = event.get("event", "change")
        # every roster change is a structured log event too (obs/log.py):
        # trace-correlated when the dispatcher's tracer is armed, so the
        # merged per-job timeline shows the membership churn it survived
        olog.emit("membership", kind,
                  level="warn" if kind in ("leave", "challenge_failed")
                  else "info",
                  trace_id=self.tracer.trace_id
                  if self.tracer is not None else None, **attrs)
        if self.tracer is not None:
            self.tracer.add_event(span, 0.0, event=kind, **attrs)
        for fn in list(self._listeners):
            try:
                fn(event)
            except Exception:  # a listener must not break membership
                pass

    def push_roster(self, exclude=None):
        """Best-effort epoch-table push to every member not LEAVEd (the
        excluded one — the joiner itself — gets the roster in its JOIN
        reply; breaker-open members are still attempted, since a
        transiently-marked-dead worker may be reachable and MUST learn
        the table before it is re-admitted). Runs on the dispatcher's
        executor. A member that still misses the push converges later:
        an epoch-mismatched FFT_INIT draws a loud error, and the
        dispatcher's replan path calls push_roster() again before the
        next attempt."""
        payload = protocol.encode_json(
            {k: v for k, v in self.roster().items()
             if k in ("epoch", "workers")})

        def push(i):
            try:
                self.d.workers[i].call(protocol.ROSTER, payload,
                                       traced=False)
                self.metrics.inc("roster_pushes")
            except Exception:
                pass  # breaker fast-fail / dead member: converges later

        with self._lock:
            targets = [i for i in range(len(self.d.workers))
                       if i != exclude and i not in self.left]
        return [self.d.pool.submit(push, i) for i in targets]

    _push_roster = push_roster


class MembershipServer:
    """Serve one registry over the framed transport (JOIN / LEAVE /
    ROSTER / PING). Lives inside the dispatcher's process — membership
    is dispatcher-owned state, the listener is just its wire face."""

    def __init__(self, registry, host="127.0.0.1", port=0):
        self.registry = registry
        self.host = host
        self._listener = native.Listener(host, port)
        self.port = port or native.listener_port(self._listener)
        self._accept = threading.Thread(target=self._accept_loop,
                                        name="membership-accept",
                                        daemon=True)
        self._accept.start()

    def address(self):
        return self.host, self.port

    def _accept_loop(self):
        while True:
            try:
                conn = self._listener.accept()
            except Exception:
                # native.Conn asserts on the -1 a failed/closed accept
                # returns. A dead accept thread would silently stop ALL
                # healing (no JOIN ever served again), so: exit cleanly
                # when the listener was closed, retry on transients
                # (EMFILE/ECONNABORTED under load)
                if self._listener.fd < 0:
                    return
                time.sleep(0.05)
                continue
            if conn.fd < 0:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                try:
                    tag, payload = conn.recv()
                except ConnectionError:
                    return
                try:
                    self._dispatch(conn, tag, payload)
                except Exception as e:
                    try:
                        conn.send(protocol.ERR, protocol.encode_json(
                            {"reason": repr(e)}))
                    except ConnectionError:
                        return
        finally:
            conn.close()

    def _dispatch(self, conn, tag, payload):
        reg = self.registry
        if tag == protocol.PING:
            conn.send(protocol.OK)
        elif tag == protocol.JOIN:
            req = protocol.decode_json(payload)
            reply = reg.join(req["host"], req["port"],
                             store=bool(req.get("store")),
                             phase=req.get("phase"),
                             stats=req.get("stats"))
            conn.send(protocol.OK, protocol.encode_json(reply))
        elif tag == protocol.LEAVE:
            req = protocol.decode_json(payload)
            reply = reg.leave(index=req.get("index"),
                              host=req.get("host"), port=req.get("port"))
            conn.send(protocol.OK, protocol.encode_json(reply))
        elif tag == protocol.ROSTER:
            conn.send(protocol.OK, protocol.encode_json(reg.roster()))
        else:
            conn.send(protocol.ERR, protocol.encode_json(
                {"reason": "unknown membership tag"}))

    def close(self):
        self._listener.close()


# -- worker-side join client --------------------------------------------------

# how long a joiner retries while the membership server comes up, and the
# budget of one membership call
JOIN_RETRY_S = 30.0
JOIN_TIMEOUT_MS = 10000


def _member_call(host, port, tag, obj, timeout_ms=None):
    timeout_ms = JOIN_TIMEOUT_MS if timeout_ms is None else timeout_ms
    conn = native.connect(host, port, timeout_ms=timeout_ms)
    try:
        if timeout_ms:
            conn.set_timeout(timeout_ms)
        conn.send(tag, protocol.encode_json(obj))
        rtag, rpayload = conn.recv()
    finally:
        conn.close()
    if rtag != protocol.OK:
        raise RuntimeError(
            f"membership call failed: {protocol.decode_json(rpayload)}")
    return protocol.decode_json(rpayload)


def join_fleet(join_host, join_port, my_host, my_port, store=False,
               retry_s=None):
    """Announce one worker to the membership server, retrying while the
    server comes up (the supervisor may spawn workers before the
    dispatcher finishes binding). Returns the JOIN reply."""
    deadline = time.monotonic() + (JOIN_RETRY_S if retry_s is None
                                   else retry_s)
    last = None
    while True:
        try:
            return _member_call(join_host, join_port, protocol.JOIN,
                                {"host": my_host, "port": my_port,
                                 "store": bool(store)})
        except (ConnectionError, OSError) as e:
            last = e
            if time.monotonic() >= deadline:
                raise ConnectionError(
                    f"cannot join fleet at {join_host}:{join_port}: "
                    f"{last!r}") from last
            time.sleep(0.25)


def report_ready(join_host, join_port, my_host, my_port, stats):
    """Post-warm-sync JOIN update (phase=ready): best-effort — a lost
    update only loses the warm_rejoin_s observation, never membership."""
    try:
        return _member_call(join_host, join_port, protocol.JOIN,
                            {"host": my_host, "port": my_port,
                             "phase": "ready", "stats": stats})
    except (ConnectionError, OSError, RuntimeError):
        return None


def leave_fleet(join_host, join_port, host, port):
    """Declare (host, port) permanently gone (the supervisor's flap-cap
    path). Best-effort; returns the reply or None."""
    try:
        return _member_call(join_host, join_port, protocol.LEAVE,
                            {"host": host, "port": port})
    except (ConnectionError, OSError, RuntimeError):
        return None
