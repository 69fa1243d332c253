"""Fleet metrics aggregation: scrape, aggregate, render — one pane.

The dispatcher (or a ProofService with an attached fleet) scrapes every
roster member's FULL Metrics snapshot over the METRICS_FETCH wire tag and
this module turns the results into the operator surfaces:

    scrape(dispatcher)       one fan-out over the CURRENT roster,
                             breaker/suspect-aware: breaker-open and
                             LEAVEd members are reported by state without
                             burning a dial; an old worker (ERR
                             "unknown tag") degrades to snapshot=None
                             with reachable=True — never an error.
    aggregate(entries, m)    fold a scrape into dpt_fleet_* gauges on the
                             shared registry (width, reachable, suspects,
                             open breakers, fleet-total served/errors),
                             and the workers' mean kernel share per stage
                             into mfu_fleet_<stage>_pct (what the
                             autoscaler's mfu_pct reads for a service
                             proving on the fleet).
    render_prom(entries)     Prometheus text with per-worker labels:
                             dpt_fleet_<name>{worker="i",addr="h:p"} for
                             every numeric counter/gauge a worker
                             published — per-worker MFU/gflops, served
                             counters, sdc_injected, all on one scrape.
    FleetScraper             the interval loop (`interval_s`, default
                             5): owns the latest scrape for the /fleet
                             endpoint and appends its rendering to
                             ObsServer /metrics.

A copy of the JAX package's obs/fleet.py: the same entries, gauges and
Prometheus text, so either package's dispatcher renders either package's
workers alike.
"""

import json
import re
import threading
import time

SCRAPE_S = 5.0

_LABEL_SAFE = re.compile(r"[^a-zA-Z0-9_:.\-]")


def _prom_name(name):
    return "dpt_fleet_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _labels(entry):
    addr = _LABEL_SAFE.sub("_", str(entry.get("addr", "?")))
    return f'{{worker="{entry["index"]}",addr="{addr}"}}'


def scrape(dispatcher):
    """[entry] per roster slot: {index, addr, usable, suspect, left,
    reachable, snapshot|None}. Runs the fan-out on the dispatcher's
    executor (one slow worker doesn't serialize the scrape)."""
    from ..runtime import protocol

    tracker = dispatcher.tracker

    def one(iw):
        i, w = iw
        entry = {"index": i, "addr": f"{w.host}:{w.port}",
                 "usable": tracker.usable(i),
                 "suspect": tracker.is_suspect(i),
                 "left": dispatcher._left(i),
                 "reachable": False, "snapshot": None}
        if entry["left"] or not entry["usable"]:
            # breaker/suspect-aware: no dial — the state IS the datum
            return entry
        try:
            raw = w.call(protocol.METRICS_FETCH, traced=False)
            entry["snapshot"] = json.loads(raw.decode() or "{}")
            entry["reachable"] = True
        except RuntimeError:
            # ERR reply — an old worker without the tag: alive, opaque
            entry["reachable"] = True
            entry["unsupported"] = True
        except Exception:
            pass  # dead/unreachable: breaker machinery will catch up
        return entry

    return list(dispatcher.pool.map(one, enumerate(dispatcher.workers)))


def aggregate(entries, metrics):
    """Fold one scrape into fleet-level gauges on `metrics`."""
    reachable = [e for e in entries if e["reachable"]]
    with_snap = [e for e in entries if e["snapshot"]]
    metrics.inc("fleet_scrapes")
    metrics.gauge("fleet_width", len(entries))
    metrics.gauge("fleet_reachable", len(reachable))
    metrics.gauge("fleet_suspects",
                  sum(1 for e in entries if e["suspect"]))
    metrics.gauge("fleet_breakers_open",
                  sum(1 for e in entries
                      if not e["usable"] and not e["left"]))
    served = errors = 0
    for e in with_snap:
        ctr = (e["snapshot"].get("counters") or {})
        served += sum(v for k, v in ctr.items()
                      if k.startswith("served_") and isinstance(v, int))
        errors += ctr.get("serve_errors", 0)
    metrics.gauge("fleet_served_total", served)
    metrics.gauge("fleet_serve_errors_total", errors)
    shares = {}
    for e in with_snap:
        for k, v in (e["snapshot"].get("gauges") or {}).items():
            if k.startswith("mfu_") and k.endswith("_pct") \
                    and isinstance(v, (int, float)) \
                    and not isinstance(v, bool):
                shares.setdefault(k[len("mfu_"):-len("_pct")], []).append(v)
    for stage, vals in shares.items():
        metrics.gauge(f"mfu_fleet_{stage}_pct",
                      float("%.6g" % (sum(vals) / len(vals))))
    return {"width": len(entries), "reachable": len(reachable),
            "scraped": len(with_snap)}


def render_prom(entries):
    """Per-worker labelled series for one scrape (Prometheus text).
    Counters become dpt_fleet_<name>_total{worker=,addr=}, numeric
    gauges dpt_fleet_<name>{...}; an up/suspect pair per slot always."""
    lines = []
    typed = set()

    def put(name, entry, value, kind):
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            return
        n = _prom_name(name) + ("_total" if kind == "counter" else "")
        if n not in typed:
            typed.add(n)
            lines.append(f"# TYPE {n} {kind}")
        lines.append(f"{n}{_labels(entry)} {value}")

    for e in entries:
        put("up", e, int(bool(e["reachable"])), "gauge")
        put("suspect", e, int(bool(e["suspect"])), "gauge")
        snap = e.get("snapshot") or {}
        for k, v in sorted((snap.get("counters") or {}).items()):
            put(k, e, v, "counter")
        gauges = dict(snap.get("gauges") or {})
        for k in ("uptime_s", "epoch", "sdc_injected"):
            if isinstance(snap.get(k), (int, float)):
                gauges[k] = snap[k]
        for k, v in sorted(gauges.items()):
            put(k, e, v, "gauge")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_json(dispatcher, entries, extra=None):
    """The /fleet endpoint body: roster + per-member state + the latest
    per-worker snapshots, one JSON object."""
    out = {
        "ts": round(time.time(), 3),
        "epoch": dispatcher.epoch,
        "width": len(entries),
        "members": entries,
    }
    if extra:
        out.update(extra)
    return out


class FleetScraper:
    """Interval scraper owned by whoever holds the dispatcher (the
    ProofService via attach_fleet, or a standalone operator loop). Keeps
    the latest scrape for /fleet, folds aggregates into the shared
    registry each cycle, and renders the labelled series for /metrics."""

    def __init__(self, dispatcher, metrics, interval_s=SCRAPE_S):
        self.d = dispatcher
        self.metrics = metrics
        self.interval_s = interval_s
        self.last = []          # latest entries
        self.last_ts = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    def scrape_once(self):
        # the WHOLE cycle is guarded: a malformed snapshot from one
        # skewed worker must neither kill the interval thread (which
        # would freeze /fleet silently) nor escape into a caller — the
        # error counter exists exactly for this
        try:
            entries = scrape(self.d)
            aggregate(entries, self.metrics)
            with self._lock:
                self.last = entries
                self.last_ts = time.time()
            return entries
        except Exception:
            self.metrics.inc("fleet_scrape_errors")
            return self.snapshot()

    def snapshot(self):
        with self._lock:
            return list(self.last)

    def render(self):
        """Labelled per-worker series for the latest scrape."""
        return render_prom(self.snapshot())

    def fleet_json(self, extra=None):
        with self._lock:
            entries, ts = list(self.last), self.last_ts
        out = snapshot_json(self.d, entries, extra=extra)
        out["scraped_at"] = round(ts, 3) if ts else None
        return out

    def start(self):
        self.scrape_once()  # the first /fleet must not race the interval
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-scraper", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.scrape_once()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
