"""Service observability: counters, gauges, latency histograms, exposition
(a copy of the JAX package's service/metrics.py; its kernel gauges count
32-bit integer multiply-adds against the card's own peak).

The structured upgrade of the worker plane's raw `{tag: count}` STATS
counters (runtime/worker.py) for the serving layer: one `Metrics` registry
aggregates queue depth, wait/run latencies, per-prover-round times (fed
from trace.Tracer totals), retries/kills, and throughput, snapshots to one
JSON-able dict for the METRICS wire tag, and renders the Prometheus text
exposition (`to_prometheus`) that serve.py --obs-port serves at /metrics.

Histograms keep a bounded reservoir (uniform sampling past the cap, so
long runs stay O(1) memory) and report count/sum/min/mean/percentiles
computed from the reservoir at snapshot time; `samples` says how many
reservoir values back the percentile estimates (past the cap they are
estimates over a uniform sample, not exact order statistics).

METRIC GLOSSARY: every counter/histogram name the code records is
documented here (a `_*` suffix documents a name family). Scoped
registries (Metrics.scoped)
publish under their prefix: the artifact store's entries appear as
store_<name>.

Job lifecycle (service/server.py, service/pool.py, service/queue.py):
    jobs_submitted / jobs_accepted / jobs_rejected   admission outcomes
    jobs_completed / jobs_failed / jobs_timeout      terminal outcomes
    job_retries / job_attempt_errors                 retry-loop activity
    jobs_evicted                                     finished jobs aged out
                                                     of the job table
    workers_spawned / workers_killed / kill_requests  pool slot lifecycle
                                                     + fault injection
    warmups                                          WARMUP requests served
    job_wait / job_run (histograms)                  submit->start and
                                                     start->done seconds
    prove_round/* (histograms)                       per-round prover
                                                     latency (trace totals)
    queue_depth / queue_high_water (gauges)          admission backlog

Scheduler + shape buckets (service/scheduler.py):
    batches_dispatched / batch_size                  shape-batch activity
    dispatch_errors                                  pool handoff failures

Placement + cross-job batched proving (service/placement.py, pool.py):
    placement_*                                      decisions per popped
                                                     shape batch: _batch
                                                     (data-parallel cross-
                                                     job prove), _mesh
                                                     (sharded submesh
                                                     prove), _pool (per-job
                                                     dispatch)
    batch_proves                                     batched prove_many
                                                     attempts launched
    batch_jobs                                       jobs proved inside
                                                     batched attempts
    batch_jobs_per_launch (histogram)                achieved jobs per
                                                     batched attempt
    batch_member_kills                               batch members killed
                                                     mid-prove (resumed
                                                     alone; the others
                                                     finished unaffected)
    submesh_leases                                   device leases granted
                                                     (big sharded proves +
                                                     opportunistic batch
                                                     leases)
    submesh_devices_free (gauge)                     unleased devices
    bucket_hits / bucket_misses / bucket_disk_hits   key-cache tiers
    bucket_peer_hits                                 keys fetched from a
                                                     warm STORE_FETCH peer
    bucket_latch_waits                               callers that waited on
                                                     another thread's
                                                     in-flight key setup
    bucket_mem_evictions / buckets_resident (gauge)  memory-tier LRU
    bucket_build / bucket_disk_load (histograms)     tier latencies
    bucket_build_errors                              key builds that failed
    store_write_errors                               best-effort artifact
                                                     writes that failed

Round-pipelined proving (prover.PipelinedProver via pool._run_pipeline):
    pipelined_proves                         pipelined attempts launched
                                             (one per coalesced window)
    pipelined_jobs                           jobs proved inside pipelined
                                             attempts
    pipeline_depth (gauge)                   members in flight at the last
                                             observed stage boundary
    pipeline_depth_achieved (histogram)      in-flight depth sampled at
                                             every stage finalize (the
                                             fill the pipeline actually
                                             achieved vs PIPELINE_DEPTH)
    pipeline_stage_wait_s (histogram)        driver wait for a member's
                                             oldest ready stage (also per
                                             round: pipeline_stage_wait_s/
                                             round<N>)
    pipeline_host_finalize_s/round<N> (gauge)  host work of a stage's
                                             finalize after the device
                                             force (transcript absorb,
                                             checkpoint save): the serial
                                             host work the pipeline
                                             overlaps with other members'
                                             launches

Artifact store, scoped `store_*` (store/artifacts.py, store/remote.py):
    store_hits / store_misses / store_evictions      blob cache activity
    store_corrupt                                    integrity failures on
                                                     read (entry deleted,
                                                     rebuilt on demand)
    store_entries / store_bytes (gauges)             resident inventory
    store_put_bytes                                  bytes written
    store_fetch_served / store_fetch_misses          STORE_FETCH server side
    store_fetch_bytes                                blob bytes served
    store_list_served                                STORE_LIST enumerations
                                                     answered

Failure-observability vocabulary:
    checkpoint_saves / checkpoint_resumes    prover round snapshots and
                                             resumed (not restarted)
                                             attempts (service pool)
    faults_injected_* / faults_ckpt_corrupted  chaos-injection activity
                                             (runtime/faults.py)

Durability vocabulary (service/journal.py + the restart-recovery path):
    journal_appends / journal_replays        records written / replayed
                                             at open
    journal_torn_records / journal_compactions  damaged-tail truncations
                                             and log rewrites
    jobs_recovered / jobs_recovered_finished  re-enqueued in-flight jobs
                                             and artifact-served DONE
                                             jobs after a restart
    jobs_shed                                TTL/deadline load-shed
                                             verdicts (journaled)
    dedup_hits                               duplicate job_key SUBMITs
                                             answered from the original
    drain_started / drain_clean / drain_forced  graceful-drain outcomes
    jobs_drain_parked                        in-flight jobs checkpointed
                                             + parked by a forced drain
    proof_artifacts_lost                     DONE records whose proof
                                             artifact was evicted (job
                                             re-proved, same bytes)

Result-integrity vocabulary (service/pool.py's verify-before-serve):
    self_verify_checks                       verify-before-serve pairing
                                             checks run (self_verify)
    self_verify_failures                     finished proofs that failed
                                             the pairing verifier
    self_verify_s (histogram)                verify-before-serve latency
    proofs_blocked                           proofs withheld from the
                                             journal/client by a failed
                                             self-verify (job re-proved)

Tracing vocabulary (trace.py, service/pool.py, ObsServer):
    trace_spans_recorded                     spans folded into finished
                                             jobs' merged timelines
    traces_stored                            trace:<job_id> artifacts
                                             written to the store
    trace_workers_lost                       workers whose connection
                                             was lost while a timeline
                                             was collected (named in its
                                             lost_workers)
    obs_http_requests                        /metrics /healthz /trace
                                             requests served
    log_events / log_dropped                 structured log events
                                             recorded into the ring /
                                             ring-capacity overwrites
    kernel_*_gflops / mfu_*_pct (gauges)     live per-stage throughput
                                             from the work model of
                                             trace.py, in G IMAD/s (32-bit
                                             integer multiply-adds per
                                             second, the unit of the
                                             card's integer peak), and
                                             its share of the card's peak
                                             (observe_kernels; mfu_* only
                                             where a peak is known: never
                                             on the CPU)

Fleet observability vocabulary (obs/fleet.py, runtime/worker.py
METRICS_FETCH / LOG_FETCH / PROFILE, service/server.py):
    served_*                                 worker-side request counters
                                             per wire tag (served_msm,
                                             served_fft2, ...)
    serve_errors                             worker-side ERR replies (a
                                             malformed frame, a failed
                                             handler)
    worker_*_s (histograms)                  worker-side kernel latency
                                             per stage (worker_msm_s,
                                             worker_ntt_s, worker_fft1_s,
                                             worker_fft2_s, worker_eval_s),
                                             each ending in the transfer
                                             of its result to the host
    fleet_scrapes                            METRICS_FETCH scrape cycles
                                             completed by the aggregator
    fleet_scrape_errors                      scrape cycles that failed
                                             whole (fan-out error)
    fleet_width / fleet_reachable (gauges)   roster size vs members that
                                             answered the last scrape
    fleet_suspects / fleet_breakers_open (gauges)  quarantined members /
                                             open breakers at last scrape
    fleet_served_total / fleet_serve_errors_total (gauges)  fleet-summed
                                             request counters from the
                                             last scrape
    mfu_fleet_*_pct (gauges)                 per kernel stage, the mean
                                             over the scraped workers of
                                             their mfu_<stage>_pct
    profiles_captured                        PROFILE captures served by
                                             this worker
    profiles_stored                          profile:<id> artifacts
                                             persisted by the service
    profile_errors                           captures that failed or came
                                             back empty/unsupported

Fleet recovery, membership and result-integrity vocabulary (runtime/
dispatcher.py, runtime/health.py, runtime/integrity.py, runtime/
membership.py, runtime/supervisor.py, service/scheduler.py):
    fleet_reconnects / fleet_backoff_waits   reconnect loop activity
    fleet_backoff (histogram)                seconds slept in backoff
    fleet_breaker_opens / fleet_readmissions  circuit-breaker transitions
    fleet_range_adoptions                    MSM ranges moved off a dead
                                             worker
    fleet_ntt_reroutes / fleet_eval_reroutes  NTT and evaluation calls
                                             sent to another worker
    fleet_fft_replans / fleet_fft_degraded   sharded-FFT recovery events
    membership_leaves                        members declared permanently
                                             gone (flap cap, operator)
    roster_pushes                            epoch tables pushed to live
                                             workers after a change
    warm_rejoins                             JOIN phase=ready reports
                                             carrying warm-sync stats
    warm_rejoin_s (histogram)                seconds a joiner spent
                                             pulling artifacts from peers
    supervisor_probe_misses                  liveness probes a supervised
                                             worker failed to answer
    bucket_peers_added / bucket_peers_removed  store-serving members
                                             registered as key-fetch
                                             peers / parked
    integrity_checks                         algebraic phase checks run
    integrity_failures                       checks that caught a wrong
                                             (well-formed) answer
    integrity_msm_dups / integrity_eval_dups  MSM ranges / evaluation
                                             chunks executed twice
    workers_quarantined                      workers marked SUSPECT by an
                                             attributed integrity failure
    integrity_challenges                     known-answer challenge proves
                                             run against (re-)joining
                                             quarantined addresses
    integrity_challenges_failed              challenges a joiner failed

Autoscaler vocabulary (service/autoscale.py):
    autoscale_*                              controller activity:
                                             autoscale_ticks (loop
                                             cycles), autoscale_decisions
                                             (recorded verdicts),
                                             autoscale_sensor_errors /
                                             autoscale_actuator_errors
                                             (failed reads and moves)

Kernel-autotune vocabulary (backend/autotune.py, store/calibration.py):
    autotune_runs                            calibration measure passes
                                             started (mode=run on a
                                             plan-less store)
    autotune_cells                           (kind, domain-size) cells
                                             decided by a pass
    autotune_measure_runs                    candidate configurations
                                             measured (incl. the parity
                                             reference per cell)
    autotune_candidate_errors                candidates that failed to
                                             run (skipped)
    autotune_parity_rejects                  fast-but-WRONG candidates
                                             rejected by the bit-identity
                                             gate (never adopted)
    autotune_run_s (histogram)               wall-clock per measure pass
    autotune_plan_stores / autotune_plan_loads  plan artifacts persisted
                                             to / adopted from the store
    autotune_plan_source (gauge)             off|none|store|fresh — where
                                             this process's plan came from
    autotune_plan_cells (gauge)              cells in the active plan
    autotune_plan_revision (gauge)           process-wide plan revision
                                             (bumps on every reload)

Per-class serving outcomes (service/pool.py, service/server.py):
    slo_roundtrip/<class> (histogram)        submit -> done seconds per
                                             SLO class
    slo_sheds_<class>                        terminal SHED verdicts per
                                             class
    slo_preempt_sheds                        lower-class jobs evicted by
                                             a full queue admitting a
                                             higher class

Circuit zoo + proof aggregation vocabulary (circuits/, aggregate.py,
service/server.py AGGREGATE path):
    circuit_kind_*                           jobs served to DONE per
                                             circuit kind (circuit_kind_
                                             toy, circuit_kind_range,
                                             ...): the zoo mix as the
                                             server actually proved it
    aggregates_built                         batch-KZG aggregates built
                                             (self-verified + journaled)
    aggregate_members                        constituent proofs folded
                                             into built aggregates
                                             (members per build summed)
    aggregate_verify_s (histogram)           server-side fold-then-one-
                                             pairing-check latency per
                                             built aggregate
    aggregate_verify_failures                aggregate builds REJECTED by
                                             the server's own verify gate
                                             (nothing journaled/served)
    aggregates_recovered                     aggregate artifacts restored
                                             from the journal after a
                                             restart
    aggregate_artifacts_lost                 journaled aggregates whose
                                             artifact bytes were gone at
                                             recovery (store eviction)
"""

import math
import random
import re
import shutil
import subprocess
import threading
import time

from ..trace import IMAD_PER_SM_CLOCK

_RESERVOIR = 2048


class Histogram:
    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._samples = []
        self._rng = random.Random(0xC0FFEE)

    def record(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self._samples) < _RESERVOIR:
            self._samples.append(v)
        else:
            i = self._rng.randrange(self.count)
            if i < _RESERVOIR:
                self._samples[i] = v

    def snapshot(self):
        if not self.count:
            return {"count": 0}
        s = sorted(self._samples)

        def pct(p):
            # nearest-rank percentile over the reservoir: ceil(p*k)-1,
            # clamped for tiny counts
            return s[max(0, min(len(s) - 1, math.ceil(p * len(s)) - 1))]

        return {
            "count": self.count,
            # percentiles below are computed over `samples` retained
            # reservoir values, not all `count` observations — estimates,
            # not exact order statistics, once samples < count
            "samples": len(s),
            "sum_s": round(self.sum, 6),
            "min_s": round(self.min, 6),
            "mean_s": round(self.sum / self.count, 6),
            "p50_s": round(pct(0.50), 6),
            "p90_s": round(pct(0.90), 6),
            "p95_s": round(pct(0.95), 6),
            "p99_s": round(pct(0.99), 6),
            "max_s": round(self.max, 6),
        }


def _prom_name(name):
    """Metric name -> Prometheus-legal name under the dpt_ namespace."""
    return "dpt_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


_PEAKS = {}
_PEAKS_LOCK = threading.Lock()


def _max_sm_clock_hz(uuid):
    """The maximum SM clock `nvidia-smi` reports for the card whose UUID
    is `uuid`, in Hz; None when nvidia-smi is absent or names no such
    card."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=uuid,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].lower().endswith(uuid.lower()):
            try:
                return float(parts[1]) * 1e6
            except ValueError:
                return None
    return None


def device_peak(device):
    """The card's own peak of 32-bit integer multiply-adds per second:
    SMs (torch.cuda.get_device_properties) x IMADs per SM per clock of
    its compute capability (trace.IMAD_PER_SM_CLOCK) x the maximum SM
    clock nvidia-smi reports. None on the CPU, for a compute capability
    without a known rate, or when the clock cannot be read: no gauge is
    then published against an invented peak. Computed once per device."""
    import torch
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _PEAKS_LOCK:
        if index not in _PEAKS:
            props = torch.cuda.get_device_properties(index)
            rate = IMAD_PER_SM_CLOCK.get((props.major, props.minor))
            clock = _max_sm_clock_hz(str(props.uuid)) if rate else None
            _PEAKS[index] = (props.multi_processor_count * rate * clock
                             if clock else None)
        return _PEAKS[index]


def backend_peak(backend):
    """The IMAD/s peak of the cards a backend computes on: its device's,
    or the sum over a mesh's distinct devices. None when any of them has
    no known peak (the host, a fleet's RemoteBackend)."""
    mesh = getattr(backend, "mesh", None)
    devs = set(mesh.devices) if mesh is not None \
        else {getattr(backend, "device", None)}
    peaks = [device_peak(d) for d in devs]
    return sum(peaks) if peaks and all(peaks) else None


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._hists = {}
        self.started_at = time.monotonic()

    def inc(self, name, by=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def gauge(self, name, value):
        with self._lock:
            self._gauges[name] = value

    def observe(self, name, seconds):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.record(seconds)

    def scoped(self, prefix):
        """A view of this registry that prefixes every metric name with
        `prefix_` — how subsystems with their own metric vocabulary (the
        artifact store's hits/misses/bytes/evictions) publish into the
        one service registry without hardcoding its namespace."""
        return _Scoped(self, prefix)

    def observe_rounds(self, totals):
        """Fold a prove's trace.Tracer.totals() into per-round histograms
        (keys like round1..round5, checkpoint_save)."""
        for span, dur in totals.items():
            self.observe(f"prove_round/{span}", dur)

    def observe_kernels(self, events, peak=None, device=None):
        """Fold the events of kernel work carrying a `flops` attribute
        (trace.Tracer events of a finished prove, or a fleet worker's
        kernel timings) into per-stage gauges, the stage being the last
        segment of the span name: kernel_<stage>_gflops (G IMAD/s: the
        work model of trace.py over the event's seconds) and
        mfu_<stage>_pct (that rate over `peak` IMAD/s; default: the peak
        of `device`, device_peak). With no peak (the CPU) only the
        gflops gauge is published."""
        if peak is None:
            peak = device_peak(device)
        for ev in events:
            flops = ev.get("flops")
            dur = ev.get("dur_s")
            if not flops or not dur:
                continue
            stage = re.sub(r"[^a-zA-Z0-9_]", "_",
                           ev["span"].rsplit("/", 1)[-1])
            # six significant digits: a stage far below the peak must not
            # round to a zero share
            self.gauge(f"kernel_{stage}_gflops",
                       float("%.6g" % (flops / dur / 1e9)))
            if peak:
                self.gauge(f"mfu_{stage}_pct",
                           float("%.6g" % (100.0 * flops / (dur * peak))))

    def snapshot(self):
        with self._lock:
            done = self._counters.get("jobs_completed", 0)
            uptime = time.monotonic() - self.started_at
            return {
                "uptime_s": round(uptime, 3),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                # analysis: ok(Histogram.snapshot is a lockless data object)
                "histograms": {k: h.snapshot()
                               for k, h in sorted(self._hists.items())},
                "throughput_jobs_per_s": round(done / uptime, 6) if uptime else 0.0,
            }

    def to_prometheus(self, extra_gauges=None):
        """Prometheus text exposition (format version 0.0.4) of the
        current snapshot: counters as `dpt_<name>_total`, gauges as
        `dpt_<name>`, histograms as summaries (`{quantile=...}` series
        from the reservoir percentiles, plus _sum/_count and a _samples
        gauge for the reservoir size). `extra_gauges` lets the caller
        splice in point-in-time values (queue depth) the registry does
        not own."""
        snap = self.snapshot()
        gauges = dict(snap["gauges"])
        if extra_gauges:
            gauges.update(extra_gauges)
        gauges["uptime_s"] = snap["uptime_s"]
        gauges["throughput_jobs_per_s"] = snap["throughput_jobs_per_s"]
        lines = []
        for name, v in sorted(snap["counters"].items()):
            n = _prom_name(name) + "_total"
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {v}")
        for name, v in sorted(gauges.items()):
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue  # non-numeric gauge (labels) — JSON snapshot only
            n = _prom_name(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {v}")
        for name, h in sorted(snap["histograms"].items()):
            if not h.get("count"):
                continue
            n = _prom_name(name) + "_seconds"
            lines.append(f"# TYPE {n} summary")
            for q, key in (("0.5", "p50_s"), ("0.9", "p90_s"),
                           ("0.95", "p95_s"), ("0.99", "p99_s")):
                lines.append(f'{n}{{quantile="{q}"}} {h[key]}')
            lines.append(f"{n}_sum {h['sum_s']}")
            lines.append(f"{n}_count {h['count']}")
            lines.append(f"# TYPE {n}_samples gauge")
            lines.append(f"{n}_samples {h['samples']}")
        return "\n".join(lines) + "\n"


class _Scoped:
    """Name-prefixing adapter over a Metrics registry (see Metrics.scoped)."""

    def __init__(self, base, prefix):
        self._base = base
        self._prefix = prefix

    def inc(self, name, by=1):
        self._base.inc(f"{self._prefix}_{name}", by)

    def gauge(self, name, value):
        self._base.gauge(f"{self._prefix}_{name}", value)

    def observe(self, name, seconds):
        self._base.observe(f"{self._prefix}_{name}", seconds)
