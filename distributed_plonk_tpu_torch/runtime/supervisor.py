"""Worker supervision: spawn, liveness-watch, respawn with backoff (a copy
of the JAX package's runtime/supervisor.py, spawning the port's worker).

The process half of the self-healing fleet (runtime/membership.py is the
fleet half): a WorkerSupervisor owns N local worker SUBPROCESSES,

    python -m distributed_plonk_tpu_torch.runtime.worker --join H:P
        --listen H:P [--device DEV] [--store DIR] [--build-dir DIR]

watches each one's liveness through the HEALTH probe with a
consecutive-miss budget, and respawns dead or wedged ones with jittered
exponential backoff. A respawned worker rejoins through the same JOIN
path as a new one (same port, same fleet index, re-admitted through the
dispatcher's breaker and warm-rejoined from the roster's store peers);
the supervisor has no re-entry protocol of its own.

A crash-looping worker must not be respawned forever: `flap_cap`
respawns inside `flap_window_s` mark the slot FAILED, stop respawning it
and declare it gone with a LEAVE, so the fleet stops probing the corpse.
Counters land in the duck-typed metrics registry: worker_respawns /
worker_flap_capped / supervisor_probe_misses / worker_retires, gauge
supervised_workers (active slots: not failed, not retired).

Scale-down is graceful (`retire_slot`, the autoscaler's down actuator):
drain (HEALTH's fft_tasks table empties) -> membership LEAVE -> SIGTERM,
escalating to SIGKILL only past RETIRE_TIMEOUT_S per phase. The order
is the no-lost-work contract: the worker finishes its in-flight tasks
before the fleet stops routing to it, and is signalled only after it is
out of the roster. A retired slot is not a flap: the watch loop skips
it, it is never respawned, and it adds nothing to the flap window.

Start-up is graced: the miss budget only ticks once a worker has answered
its FIRST probe; before that, only `startup_grace_s` elapsing counts as
wedged (a fresh interpreter importing torch and reaching its device can
take tens of seconds on a loaded host).

Settings are the JAX package's defaults: probe every 0.5 s with a 3 s
budget, 3 misses, 120 s start-up grace, backoff 0.25 s doubling to 10 s,
5 respawns in 60 s, 20 s per retire phase; the probe interval, the
backoff and the flap cap are constructor arguments.
"""

import random
import signal
import socket
import subprocess
import sys
import threading
import time

from . import membership
from .dispatcher import WorkerHandle
from .health import NullMetrics
from ..obs import log as olog


PROBE_INTERVAL_S = 0.5
PROBE_TIMEOUT_MS = 3000
MISS_BUDGET = 3
STARTUP_GRACE_S = 120.0
BACKOFF_BASE_S = 0.25
BACKOFF_MAX_S = 10.0
FLAP_CAP = 5
FLAP_WINDOW_S = 60.0
RETIRE_TIMEOUT_S = 20.0


def reserve_port(host="127.0.0.1"):
    """Pick a currently-free port for a worker slot. The tiny bind race
    (another process grabbing it before the worker does) is tolerated on
    the loopback deployments this targets: the worker's bind then fails,
    the supervisor sees the death and respawns on a fresh port."""
    s = socket.socket()
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()


class _Slot:
    """One supervised worker: its reserved address, live subprocess, and
    flap bookkeeping. Mutated only under the supervisor's lock."""

    def __init__(self, port, store_dir=None, build_dir=None):
        self.port = port
        self.store_dir = store_dir
        self.build_dir = build_dir
        self.proc = None
        self.misses = 0
        self.backoff = 0.0
        self.next_spawn = 0.0
        self.spawn_times = []  # monotonic stamps inside the flap window
        self.spawned_at = 0.0
        self.answered = False  # this incarnation answered >= 1 probe
        self.healthy_since = None
        self.failed = False
        self.retired = False
        self.respawns = 0


class WorkerSupervisor:
    def __init__(self, join_host, join_port, n=0, device=None,
                 host="127.0.0.1", store_dirs=None, metrics=None,
                 probe_interval_s=PROBE_INTERVAL_S,
                 backoff_base_s=BACKOFF_BASE_S, backoff_max_s=BACKOFF_MAX_S,
                 flap_cap=FLAP_CAP, flap_window_s=FLAP_WINDOW_S, cwd=None,
                 spawn_cmd=None, build_dirs=None,
                 retire_timeout_s=RETIRE_TIMEOUT_S):
        """device: the workers' --device (None: the card); store_dirs:
        per-slot artifact-store dirs (workers then serve STORE_FETCH and
        warm-rejoin on respawn); build_dirs: per-slot kernel build
        directories (--build-dir; None: the checkout's, shared);
        retire_timeout_s: retire_slot's per-phase budget by default;
        spawn_cmd(slot_index, slot) -> argv
        replaces the worker command line (`worker_cmd` gives the default
        to extend; tests inject crash-looping commands)."""
        self.join_host, self.join_port = join_host, join_port
        self.device = device
        self.host = host
        self.metrics = metrics or NullMetrics()
        self.cwd = cwd
        self.spawn_cmd = spawn_cmd
        self.probe_interval_s = probe_interval_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.flap_cap = flap_cap
        self.flap_window_s = flap_window_s
        self.retire_timeout_s = retire_timeout_s
        self._rng = random.Random()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._watcher = None
        store_dirs = list(store_dirs or [])
        build_dirs = list(build_dirs or [])
        self.slots = [
            _Slot(reserve_port(host),
                  store_dirs[i] if i < len(store_dirs) else None,
                  build_dirs[i] if i < len(build_dirs) else None)
            for i in range(n)]

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        for i in range(len(self.slots)):
            self._spawn(i)
        self._watcher = threading.Thread(target=self._watch_loop,
                                         name="worker-supervisor",
                                         daemon=True)
        self._watcher.start()
        return self

    def stop(self):
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=10)
        with self._lock:
            procs = [s.proc for s in self.slots if s.proc is not None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except Exception:
                pass

    def attach_registry(self, registry):
        """Close the quarantine loop (runtime/integrity.py): when the
        membership registry LEAVEs a member with reason="integrity", the
        process is ALIVE — it answers probes, its answers are wrong — so
        liveness supervision alone would never replace it. Subscribing
        here turns the quarantine verdict into a SIGKILL of the owning
        slot; the normal watch loop then respawns it (backoff + flap-cap
        rules apply to repeat offenders) and the fresh process re-JOINs
        through the challenge gate."""
        def _on_event(ev):
            if ev.get("event") != "leave" \
                    or ev.get("reason") != "integrity":
                return
            j = self.slot_for_port(ev.get("port"))
            if j is not None:
                # kill() waits on the process: never block the
                # registry's emit path behind it
                threading.Thread(target=self.kill, args=(j,),
                                 daemon=True).start()
        registry.subscribe(_on_event)
        return self

    def add_slot(self, store_dir=None, build_dir=None):
        """Grow the supervised fleet by one slot at runtime (scale-up):
        the new worker takes the exact JOIN path of every other member.
        Returns the slot index; the worker is spawned immediately."""
        with self._lock:
            self.slots.append(_Slot(reserve_port(self.host), store_dir,
                                    build_dir))
            i = len(self.slots) - 1
        self._spawn(i)
        return i

    def retire_slot(self, i, timeout_s=None):
        """Graceful scale-down of slot i: drain -> LEAVE -> SIGTERM, with
        SIGKILL escalation only past the per-phase budget
        (RETIRE_TIMEOUT_S, or `timeout_s`). Order is the no-lost-work contract:
        the worker first empties its in-flight task table (HEALTH's
        fft_tasks — finished or checkpointed), is THEN declared gone
        through the membership registry so nothing new routes to it, and
        only after that receives a signal — a retiring worker is never
        killed mid-prove. Marking `retired` under the lock first takes
        the slot out of supervision atomically: the watch loop skips it,
        nothing respawns it, and the retire is not a flap. Returns True
        iff this call performed the retire (False: already retired /
        failed)."""
        budget = self.retire_timeout_s if timeout_s is None else timeout_s
        with self._lock:
            slot = self.slots[i]
            if slot.retired or slot.failed:
                return False
            slot.retired = True
            proc = slot.proc
        olog.emit("supervisor", "retire", slot=i, port=slot.port)
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if proc is None or proc.poll() is not None:
                break  # already dead == already drained
            snap = WorkerHandle(self.host, slot.port).probe(
                timeout_ms=PROBE_TIMEOUT_MS)
            if snap is not None and not snap.get("fft_tasks"):
                break
            time.sleep(min(0.1, self.probe_interval_s))
        # LEAVE before any signal: the fleet must stop routing first
        membership.leave_fleet(self.join_host, self.join_port,
                               self.host, slot.port)
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=max(1.0, budget))
            except subprocess.TimeoutExpired:
                # SIGTERM ignored past the budget — the member already
                # LEAVEd and drained, so a hard kill cannot lose work
                proc.kill()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    pass
        self.metrics.inc("worker_retires")
        self.metrics.gauge("supervised_workers", self.active_count())
        olog.emit("supervisor", "retired", slot=i, port=slot.port)
        return True

    def active_count(self):
        """Slots still under supervision (not failed, not retired) —
        the autoscaler's worker-count sensor."""
        with self._lock:
            return sum(1 for s in self.slots
                       if not s.failed and not s.retired)

    # -- chaos / introspection ------------------------------------------------

    def slot_for_port(self, port):
        with self._lock:
            for j, s in enumerate(self.slots):
                if s.port == port:
                    return j
        return None

    def proc_killer(self, dispatcher):
        """kill_cb for the `kill:at=proc` chaos plane: the injector hands
        over a DISPATCHER worker index, which need not equal the slot
        index (join order is concurrent) — translate through the
        address, which is the stable identity on both sides."""
        def _kill(i):
            j = self.slot_for_port(dispatcher.workers[i].port)
            if j is not None:
                self.kill(j)
        return _kill

    def kill(self, i, sig=signal.SIGKILL):
        """SIGKILL slot i's subprocess — the `kill:at=proc` chaos plane's
        callback (runtime/faults.py) and the heal canary's trigger. The
        watch loop then detects the death and respawns through the
        normal path."""
        with self._lock:
            proc = self.slots[i].proc
        if proc is not None and proc.poll() is None:
            proc.send_signal(sig)
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass

    def address(self, i):
        return self.host, self.slots[i].port

    def snapshot(self):
        with self._lock:
            return [{"port": s.port, "respawns": s.respawns,
                     "failed": s.failed, "retired": s.retired,
                     "alive": s.proc is not None and s.proc.poll() is None}
                    for s in self.slots]

    # -- internals ------------------------------------------------------------

    def worker_cmd(self, i, slot):
        """The port worker's command line for slot i."""
        cmd = [sys.executable, "-m",
               "distributed_plonk_tpu_torch.runtime.worker",
               "--join", f"{self.join_host}:{self.join_port}",
               "--listen", f"{self.host}:{slot.port}"]
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        if slot.store_dir is not None:
            cmd += ["--store", slot.store_dir]
        if slot.build_dir is not None:
            cmd += ["--build-dir", slot.build_dir]
        return cmd

    def _cmd(self, i, slot):
        if self.spawn_cmd is not None:
            return self.spawn_cmd(i, slot)
        return self.worker_cmd(i, slot)

    def _spawn(self, i):
        """Start slot i's subprocess (caller ensured backoff elapsed)."""
        with self._lock:
            slot = self.slots[i]
            if slot.failed or slot.retired or self._stop.is_set():
                return
            now = time.monotonic()
            slot.spawn_times = [t for t in slot.spawn_times
                                if now - t <= self.flap_window_s]
            slot.spawn_times.append(now)
            slot.misses = 0
            slot.healthy_since = None
            slot.spawned_at = now
            slot.answered = False
            first = slot.proc is None
            slot.proc = subprocess.Popen(self._cmd(i, slot), cwd=self.cwd)
        if not first:
            self.metrics.inc("worker_respawns")
            with self._lock:
                slot.respawns += 1
            olog.emit("supervisor", "respawn", level="warn", slot=i,
                      port=slot.port, respawns=slot.respawns)
        else:
            olog.emit("supervisor", "spawn", slot=i, port=slot.port)
        self.metrics.gauge("supervised_workers", self.active_count())

    def _schedule_respawn(self, i):
        """Slot i's process is dead/wedged: arm the next spawn time with
        jittered exponential backoff, or give up at the flap cap (stop
        respawning, declare the member gone via LEAVE)."""
        now = time.monotonic()
        gave_up = False
        with self._lock:
            slot = self.slots[i]
            if slot.failed or slot.retired:
                return
            recent = [t for t in slot.spawn_times
                      if now - t <= self.flap_window_s]
            if len(recent) >= self.flap_cap:
                slot.failed = True
                gave_up = True
            else:
                slot.backoff = min(self.backoff_max_s,
                                   (slot.backoff * 2) or self.backoff_base_s)
                jitter = 1.0 + 0.5 * self._rng.random()
                slot.next_spawn = now + slot.backoff * jitter
                slot.misses = 0
        if gave_up:
            # network call outside the lock: a slow membership server
            # must not stall supervision of the other slots
            self.metrics.inc("worker_flap_capped")
            olog.emit("supervisor", "flap_capped", level="error", slot=i,
                      port=slot.port)
            membership.leave_fleet(self.join_host, self.join_port,
                                   self.host, slot.port)

    def _watch_one(self, i):
        now = time.monotonic()
        with self._lock:
            slot = self.slots[i]
            if slot.failed or slot.retired:
                return
            proc, next_spawn = slot.proc, slot.next_spawn
        if proc is None or proc.poll() is not None:
            # process is gone: respawn once the backoff window passes
            if next_spawn == 0.0:
                self._schedule_respawn(i)
            elif now >= next_spawn:
                with self._lock:
                    slot.next_spawn = 0.0
                self._spawn(i)
            return
        # process alive: probe HEALTH (a wedged worker answers nothing)
        h, p = self.address(i)
        snap = WorkerHandle(h, p).probe(timeout_ms=PROBE_TIMEOUT_MS)
        with self._lock:
            if snap is None:
                self.metrics.inc("supervisor_probe_misses")
                if not slot.answered:
                    # STARTUP GRACE: a fresh interpreter on a loaded
                    # host takes tens of seconds to import and bind —
                    # the steady-state miss budget would wedge-kill
                    # healthy starting workers in a loop straight into
                    # the flap cap. Before the first answer, only the
                    # grace deadline counts as wedged.
                    wedged = (now - slot.spawned_at
                              >= STARTUP_GRACE_S)
                else:
                    slot.misses += 1
                    slot.healthy_since = None
                    wedged = slot.misses >= MISS_BUDGET
            else:
                slot.answered = True
                slot.misses = 0
                if slot.healthy_since is None:
                    slot.healthy_since = now
                elif now - slot.healthy_since >= self.flap_window_s:
                    slot.backoff = 0.0  # stable again: forgive the past
                wedged = False
        if wedged:
            olog.emit("supervisor", "wedge_kill", level="warn", slot=i,
                      port=p)
            self.kill(i)
            self._schedule_respawn(i)

    def _watch_loop(self):
        while not self._stop.wait(self.probe_interval_s):
            for i in range(len(self.slots)):
                if self._stop.is_set():
                    return
                try:
                    self._watch_one(i)
                except Exception:  # supervision must outlive any one slot
                    pass
