"""Closed-loop autoscaler: the service's sensors drive the fleet (a copy of
the JAX package's service/autoscale.py).

An `Autoscaler` ticks every `tick_s` seconds:

  sensors   queue depth and depth by SLO class, busy pool workers, the
            standard-class roundtrip p95 from the metrics registry, the
            fleet's width / usable / suspects from the dispatcher's
            liveness tracker (a service attached to a membership
            registry), the supervised worker count, and the mean of the
            `mfu_*` gauges (`mfu_pct`: the kernel stages' share of the
            card's own peak, service/metrics.py; None until a prove on
            the card has published one).
  control   hysteresis streaks + cooldown windows + min/max bounds:
            scale UP (WorkerSupervisor.add_slot: a warm membership JOIN)
            after `up_ticks` consecutive breach ticks (queue depth per
            worker at or over `up_queue_per_worker`, or the standard p95
            over `slo_p95_standard_s`) and an elapsed `up_cooldown_s`;
            scale DOWN (WorkerSupervisor.retire_slot: drain, membership
            LEAVE, then SIGTERM, never a mid-prove kill) after
            `down_ticks` consecutive idle ticks and an elapsed
            `down_cooldown_s`; resize the submesh lease capacity between
            batch-dominated and flagship traffic; and under queue pressure
            shed lowest-class-first through queue.steal_lowest +
            pool.shed.
  obs       every decision is one structured log event (subsystem
            `autoscale`) and autoscale_* counters and gauges; the
            ObsServer's /autoscale returns `state()`.

Modes: "0" (the default) is OFF: `attach` returns None without
constructing anything; "dry" runs the loop and records every decision
with applied=False and zero actuator calls; "1" actuates.

Settings are constructor arguments; the defaults are the JAX package's:
a 2 s tick, 1 to 8 workers, 2 queued jobs per worker as a breach, 2
breach ticks before an up and 5 idle ticks before a down, 10 s and 30 s
cooldowns, no latency target, a shed watermark at 90 % of the queue.

The controller is dependency-injected: `sensors` (a callable returning
the sensor dict) and `actuators` (worker_count / add_worker /
retire_worker / lease_capacity / shed_lowest) default to the live service
and supervisor but are plain fakes in the tests; `tick()` is directly
callable, so the control law is tested without threads, sockets or
clocks (inject `clock`).
"""

import threading
import time
from collections import deque

from ..obs import log as olog
from ..runtime.health import NullMetrics
from .jobs import SLO_CLASSES, SLO_RANK

MODES = ("0", "dry", "1")

TICK_S = 2.0
MIN_WORKERS = 1
MAX_WORKERS = 8
UP_QUEUE_PER_WORKER = 2.0
UP_TICKS = 2
DOWN_TICKS = 5
UP_COOLDOWN_S = 10.0
DOWN_COOLDOWN_S = 30.0
SHED_WATERMARK = 0.9


class ServiceActuators:
    """The live actuator surface over a ProofService (+ optional
    WorkerSupervisor). Worker scaling without a supervisor is a no-op
    returning None — the controller records the decision as not applied
    instead of crashing a supervisor-less deployment."""

    def __init__(self, service, supervisor=None):
        self.service = service
        self.supervisor = supervisor

    def worker_count(self):
        if self.supervisor is not None:
            return self.supervisor.active_count()
        return None  # unsupervised pool: worker scaling is unavailable

    def add_worker(self):
        if self.supervisor is None:
            return None
        return self.supervisor.add_slot()

    def retire_worker(self):
        """Retire the highest-index active slot. The drain can take up
        to the supervisor's RETIRE_TIMEOUT_S, so it runs on a daemon
        thread: the control loop must keep ticking while a worker drains.
        Returns the retiring slot index (the retire is INITIATED, not
        complete) or None."""
        sup = self.supervisor
        if sup is None:
            return None
        with sup._lock:
            victims = [j for j, s in enumerate(sup.slots)
                       if not s.failed and not s.retired]
        if not victims:
            return None
        j = victims[-1]
        threading.Thread(target=sup.retire_slot, args=(j,),
                         name=f"autoscale-retire-{j}", daemon=True).start()
        return j

    def lease_capacity(self, frac):
        """Resize the submesh leaser to `frac` of the device pool.
        Returns the applied capacity, or None when no leaser exists yet
        (small-jobs-only service: nothing to resize)."""
        sched = self.service.scheduler
        leaser = getattr(sched, "_leaser_if_ready", lambda: None)()
        if leaser is None:
            return None
        k = max(1, round(frac * leaser.total()))
        return leaser.set_capacity(k)

    def shed_lowest(self, below_rank):
        """Evict the worst queued job of class rank < below_rank with a
        journaled SHED verdict. Returns the victim's class or None."""
        victim = self.service.queue.steal_lowest(below_rank)
        if victim is None:
            return None
        self.service.pool.shed(victim, "autoscale pressure shed")
        return victim.slo


class Autoscaler:
    def __init__(self, service=None, supervisor=None, metrics=None,
                 mode="0", tick_s=TICK_S, sensors=None, actuators=None,
                 min_workers=MIN_WORKERS, max_workers=MAX_WORKERS,
                 up_queue_per_worker=UP_QUEUE_PER_WORKER, up_ticks=UP_TICKS,
                 down_ticks=DOWN_TICKS, up_cooldown_s=UP_COOLDOWN_S,
                 down_cooldown_s=DOWN_COOLDOWN_S, slo_p95_standard_s=None,
                 shed_watermark=SHED_WATERMARK, clock=time.monotonic):
        self.service = service
        self.metrics = metrics if metrics is not None else \
            (service.metrics if service is not None else NullMetrics())
        self.mode = str(mode)
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        self.tick_s = tick_s
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.up_queue_per_worker = up_queue_per_worker
        self.up_ticks = up_ticks
        self.down_ticks = down_ticks
        self.up_cooldown_s = up_cooldown_s
        self.down_cooldown_s = down_cooldown_s
        self.slo_p95_standard_s = slo_p95_standard_s
        self.shed_watermark = shed_watermark
        self.clock = clock
        self.sensors = sensors or self.read_sensors
        self.actuators = actuators or ServiceActuators(service, supervisor)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._ticks = 0
        self._up_streak = 0
        self._down_streak = 0
        self._up_cool_until = 0.0
        self._down_cool_until = 0.0
        self._lease_frac = 1.0
        self._last_sensors = None
        self._decisions = deque(maxlen=32)

    @property
    def actuating(self):
        return self.mode == "1"

    # -- sensors --------------------------------------------------------------

    def read_sensors(self):
        """The default sensor sweep over the live service. Every field
        degrades to None/empty rather than raising — a half-wired
        service (no fleet, no supervisor) still autoscales on what it
        can see."""
        out = {"queue_depth": 0, "queue_by_class": {}, "max_depth": None,
               "busy_workers": 0, "p95_standard_s": None, "mfu_pct": None,
               "fleet": None}
        svc = self.service
        if svc is None:
            return out
        out["queue_depth"] = svc.queue.depth()
        out["queue_by_class"] = svc.queue.depth_by_class()
        out["max_depth"] = svc.queue.max_depth
        out["busy_workers"] = len(svc.pool.busy())
        snap = svc.metrics.snapshot()
        h = snap["histograms"].get("slo_roundtrip/standard")
        if h and h.get("count"):
            out["p95_standard_s"] = h.get("p95_s")
        mfu = [v for k, v in snap["gauges"].items()
               if k.startswith("mfu_") and isinstance(v, (int, float))]
        if mfu:
            out["mfu_pct"] = round(sum(mfu) / len(mfu), 3)
        d = svc.fleet_dispatcher
        if d is not None:
            try:
                ts = d.tracker.snapshot()
                out["fleet"] = {
                    "epoch": d.epoch, "width": len(ts),
                    "usable": sum(1 for s in ts if not s["open"]),
                    "suspects": sum(1 for s in ts if s["suspect"]),
                }
            except Exception:
                pass
        return out

    # -- the control law ------------------------------------------------------

    def tick(self):
        """One control cycle: read sensors, decide, (maybe) actuate,
        record. Directly callable — the unit tests and the bench canary
        drive the law without the thread. Returns this tick's decision
        list (possibly empty)."""
        now = self.clock()
        try:
            sensors = self.sensors()
        except Exception:
            self.metrics.inc("autoscale_sensor_errors")
            return []
        with self._lock:
            self._ticks += 1
            self._last_sensors = sensors
        self.metrics.inc("autoscale_ticks")
        decisions = []
        workers = self.actuators.worker_count()
        depth = sensors.get("queue_depth") or 0
        busy = sensors.get("busy_workers") or 0
        p95 = sensors.get("p95_standard_s")

        # breach / idle hysteresis streaks (mutually exclusive per tick)
        breach = False
        reasons = []
        if workers is not None and workers > 0 \
                and depth / workers >= self.up_queue_per_worker:
            breach = True
            reasons.append(f"queue/worker={depth / workers:.2f}"
                           f">={self.up_queue_per_worker:g}")
        if self.slo_p95_standard_s is not None and p95 is not None \
                and p95 > self.slo_p95_standard_s:
            breach = True
            reasons.append(f"p95={p95:.3f}s>{self.slo_p95_standard_s:g}s")
        idle = depth == 0 and busy == 0
        with self._lock:
            self._up_streak = self._up_streak + 1 if breach else 0
            self._down_streak = self._down_streak + 1 if idle else 0
            up_streak, down_streak = self._up_streak, self._down_streak

        # scale up: streak + bounds + cooldown
        if breach and up_streak >= self.up_ticks and workers is not None:
            if workers >= self.max_workers:
                pass  # at the ceiling: the streak stays armed, no event
            elif now < self._up_cool_until:
                pass  # cooling down from the last up
            else:
                applied, detail = self._actuate(
                    lambda: self.actuators.add_worker())
                decisions.append(self._decision(
                    "scale_up", "; ".join(reasons), applied,
                    {"workers": workers, "target": workers + 1,
                     "slot": detail}))
                with self._lock:
                    self._up_streak = 0
                    self._up_cool_until = now + self.up_cooldown_s

        # scale down: idle streak + floor + cooldown. Only when nothing
        # is queued or proving — retire never races in-flight work (the
        # retire itself also drains before LEAVE, belt and braces).
        if idle and down_streak >= self.down_ticks and workers is not None:
            if workers <= self.min_workers or now < self._down_cool_until:
                pass
            else:
                applied, detail = self._actuate(
                    lambda: self.actuators.retire_worker())
                decisions.append(self._decision(
                    "scale_down", f"idle x{down_streak}", applied,
                    {"workers": workers, "target": workers - 1,
                     "slot": detail}))
                with self._lock:
                    self._down_streak = 0
                    self._down_cool_until = now + self.down_cooldown_s

        # lease capacity: batch-dominated queues give half the device
        # pool back to interactive classes; any queued flagship (or an
        # empty queue) restores full capacity
        by_class = sensors.get("queue_by_class") or {}
        flagship_q = by_class.get("flagship", 0)
        batch_q = by_class.get("batch", 0)
        want_frac = 0.5 if (depth > 0 and flagship_q == 0
                            and batch_q >= depth / 2) else 1.0
        if want_frac != self._lease_frac:
            applied, detail = self._actuate(
                lambda: self.actuators.lease_capacity(want_frac))
            decisions.append(self._decision(
                "lease_resize",
                f"batch={batch_q} flagship={flagship_q} depth={depth}",
                applied, {"frac": want_frac, "capacity": detail}))
            self._lease_frac = want_frac

        # pressure shed: the queue is nearly full — evict the worst
        # sub-flagship job now instead of letting admission bounce the
        # next flagship SUBMIT
        max_depth = sensors.get("max_depth")
        if max_depth and depth >= self.shed_watermark * max_depth:
            applied, detail = self._actuate(
                lambda: self.actuators.shed_lowest(SLO_RANK["flagship"]))
            if not self.actuating or detail is not None:
                decisions.append(self._decision(
                    "shed", f"depth={depth}/{max_depth}", applied,
                    {"victim_class": detail}))

        for d in decisions:
            self._record(d)
        self._publish_gauges(sensors, workers)
        return decisions

    def _actuate(self, fn):
        """Run one actuator call in mode "1"; in "dry" record only.
        Returns (applied, detail) — applied is False in dry mode and
        when the actuator declined (returned None)."""
        if not self.actuating:
            return False, None
        try:
            detail = fn()
        except Exception as e:  # an actuator failing must not kill the loop
            self.metrics.inc("autoscale_actuator_errors")
            return False, f"error: {e!r}"
        return detail is not None, detail

    def _decision(self, action, reason, applied, detail):
        return {"ts": round(time.time(), 3), "action": action,
                "reason": reason, "mode": self.mode,
                "applied": bool(applied), "detail": detail}

    def _record(self, d):
        with self._lock:
            self._decisions.append(d)
        self.metrics.inc("autoscale_decisions")
        if d["applied"]:
            self.metrics.inc({"scale_up": "autoscale_scale_ups",
                              "scale_down": "autoscale_scale_downs",
                              "lease_resize": "autoscale_lease_resizes",
                              "shed": "autoscale_sheds"}[d["action"]])
        olog.emit("autoscale", d["action"],
                  level="info" if d["applied"] else "debug",
                  mode=d["mode"], applied=d["applied"],
                  reason=d["reason"], **{
                      k: v for k, v in (d["detail"] or {}).items()
                      if isinstance(v, (int, float, str, bool,
                                        type(None)))})

    def _publish_gauges(self, sensors, workers):
        if workers is not None:
            self.metrics.gauge("autoscale_workers", workers)
            self.metrics.gauge("autoscale_target_workers",
                               max(self.min_workers,
                                   min(self.max_workers, workers)))
        by_class = sensors.get("queue_by_class") or {}
        for cls in SLO_CLASSES:
            self.metrics.gauge(f"autoscale_queue_{cls}",
                               by_class.get(cls, 0))

    # -- introspection --------------------------------------------------------

    def state(self):
        """The /autoscale endpoint payload: mode, bounds/targets, live
        worker count, per-class queue depth, hysteresis streaks,
        cooldown remainders, and the recent decision ring."""
        now = self.clock()
        with self._lock:
            decisions = list(self._decisions)
            sensors = self._last_sensors or {}
            ticks = self._ticks
            up_streak, down_streak = self._up_streak, self._down_streak
            up_rem = max(0.0, self._up_cool_until - now)
            down_rem = max(0.0, self._down_cool_until - now)
        return {
            "mode": self.mode,
            "tick_s": self.tick_s,
            "ticks": ticks,
            "bounds": {"min_workers": self.min_workers,
                       "max_workers": self.max_workers},
            "targets": {"up_queue_per_worker": self.up_queue_per_worker,
                        "slo_p95_standard_s": self.slo_p95_standard_s,
                        "up_ticks": self.up_ticks,
                        "down_ticks": self.down_ticks,
                        "up_cooldown_s": self.up_cooldown_s,
                        "down_cooldown_s": self.down_cooldown_s},
            "workers": self.actuators.worker_count(),
            "queue": {"depth": sensors.get("queue_depth"),
                      "by_class": sensors.get("queue_by_class") or {}},
            "p95_standard_s": sensors.get("p95_standard_s"),
            "fleet": sensors.get("fleet"),
            "lease_frac": self._lease_frac,
            "streaks": {"up": up_streak, "down": down_streak},
            "cooldowns": {"up_remaining_s": round(up_rem, 3),
                          "down_remaining_s": round(down_rem, 3)},
            "last_decisions": decisions,
        }

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler", daemon=True)
        self._thread.start()
        olog.emit("autoscale", "start", mode=self.mode,
                  tick_s=self.tick_s, min_workers=self.min_workers,
                  max_workers=self.max_workers)
        return self

    def _loop(self):
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # the control loop must outlive any tick
                self.metrics.inc("autoscale_sensor_errors")

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def attach(service, supervisor=None, mode="0", start=True, **kw):
    """Build and start an Autoscaler for `service`. Mode "0" returns None
    WITHOUT constructing anything (no thread, no metrics, no log events);
    "dry" and "1" attach (service.autoscaler) and, with start=True, begin
    ticking."""
    m = str(mode)
    if m == "0":
        return None
    asc = Autoscaler(service=service, supervisor=supervisor, mode=m, **kw)
    if service is not None:
        service.autoscaler = asc
    return asc.start() if start else asc
