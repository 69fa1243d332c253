"""Span tracer: wall-clock seconds per named span, one timeline per proof.

The prover opens one span per round (`round1` .. `round5`) and one per
kernel batch inside it; `totals(depth)` sums them by name, which
chip_smoke.py prints as the per-round times. Spans that cover device work
should end in a synchronize to mean device time; the rounds do, because
each one hands its commitments to the host.

One tracer may serve a pipelined prove, whose launch halves run on a
worker thread, and a fleet dispatcher, whose fan-outs run on executor
threads: the span stack is kept per thread. `add_event` records a span of
a duration measured elsewhere (a dispatched kernel batch forced later, a
batched round shared by several members).

Across processes (the fleet): every tracer owns a 128-bit `trace_id`,
every span a 64-bit id (`sid`, what `span` yields) with a `parent` link,
and a wall-anchored start `ts`. A dispatcher call carries its trace id and
span id in the frame (runtime/protocol.py's TRACED flag); the worker
records its serve spans into a `Tracer(trace_id=..., proc="worker/i")`
and ships `dump()` back on TRACE_DUMP; `merge_traces` stitches the dumps
into one timeline, each shifted by its process's clock offset. A span
is its name, depth, duration, start, id and parent link, plus whatever
attributes its caller gave it (the service pool stamps the job id and its
placement on the queue-wait span). A tracer made with a `parent_id` (a
client's span, adopted by the service) links its root spans to it.
`to_chrome_trace` renders a merged timeline for chrome://tracing or
Perfetto (the service's /trace endpoint).

The work model (`ntt_flops`, `msm_flops`): spans of kernel work carry
`flops` and `data_bytes` attributes (the JAX package's keys), which
service/metrics.Metrics.observe_kernels folds into per-stage throughput
and utilisation gauges. The port counts 32-bit integer multiply-adds
(IMAD), the unit of the card's integer peak: a 32 x 32 -> 64-bit product
is two of them, and a Montgomery product of L words by word-level CIOS
is 2 (2 L^2 + L). Field additions, comparisons and data movement are not
counted; `data_bytes` is the 32-byte elements a span's work reads.

Device annotation: `Tracer(annotate=True)` opens a
`torch.profiler.record_function` and an NVTX range named by the span
around each span, so a `profile_to` capture or an NVTX timeline
shows the prover's spans above the kernels they launched. Off by
default.
"""

import os
import secrets
import socket
import threading
import time
from contextlib import contextmanager, nullcontext, ExitStack

# --- the work model ------------------------------------------------------

# 32-bit integer multiply-adds per SM per clock on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput)
IMAD_PER_SM_CLOCK = {(9, 0): 64}
FR_MUL_IMADS = 2 * (2 * 8 * 8 + 8)      # word-level CIOS, 8 words
FQ_MUL_IMADS = 2 * (2 * 12 * 12 + 12)   # 12 words
FR_BYTES = 32
MSM_WINDOWS = 37        # signed c = 7 windows over 256-bit scalars
MSM_BUCKETS = 64        # buckets per window (|digit| - 1)
MSM_CHUNK = 32          # sorted points per bucket_sums thread (default)
MIXED_ADD_FQ_MULS = 11  # RCB15 mixed add (the bucket accumulation)
FULL_ADD_FQ_MULS = 12   # RCB15 full add (chunk tree, tail)


def ntt_flops(n, count=1):
    """IMADs of `count` n-point radix-2 NTTs: (n / 2) log2 n butterflies,
    one Fr product each. The coset and 1/n scales and the twiddles
    between passes are not counted."""
    if n < 2:
        return 0
    return count * (n // 2) * (n.bit_length() - 1) * FR_MUL_IMADS


def msm_flops(n_points, count=1):
    """IMADs of `count` n-point MSMs by the signed c = 7 Pippenger of
    backend/msm_torch.py: one mixed add per (point, window) into its
    bucket, the pairwise tree over each bucket's chunks of MSM_CHUNK
    points (full adds), and the tail's full adds (msm_tail: 8 segments of
    8 columns, the segment running sums, their doublings and the tree).
    Digits that are zero (skipped) are counted as adds."""
    per_bucket = -(-n_points * MSM_WINDOWS // MSM_BUCKETS)
    tree = MSM_BUCKETS * max(0, -(-per_bucket // MSM_CHUNK) - 1)
    S, L = 8, MSM_BUCKETS // 8
    tail = 2 * S * (L - 1) + 2 * (S - 2) + (L.bit_length() - 1) + S
    return count * (n_points * MSM_WINDOWS * MIXED_ADD_FQ_MULS
                    + (tree + tail) * FULL_ADD_FQ_MULS) * FQ_MUL_IMADS


# --- profiler hooks ------------------------------------------------------

def annotate(path):
    """A context that names the enclosed device work `path` on a
    torch.profiler capture (record_function) and on an NVTX timeline."""
    import torch
    stack = ExitStack()
    stack.enter_context(torch.profiler.record_function(path))
    if torch.cuda.is_available():
        stack.enter_context(torch.cuda.nvtx.range(path))
    return stack


@contextmanager
def profile_to(log_dir):
    """Capture a torch.profiler trace (CPU activity, and CUDA activity
    when the card is visible) of the enclosed block into `log_dir` as a
    Chrome trace (`trace.json`, viewable in chrome://tracing or
    Perfetto). The device is synchronized before the capture stops, so
    kernels enqueued inside the block are in the trace. Yields the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def new_trace_id():
    """128-bit trace id, 32 hex chars."""
    return secrets.token_hex(16)


def new_span_id():
    """64-bit span id, 16 hex chars."""
    return secrets.token_hex(8)


class Tracer:
    def __init__(self, trace_id=None, parent_id=None, proc=None,
                 annotate=False):
        self.trace_id = trace_id or new_trace_id()
        self.annotate = annotate  # name spans on a profiler / NVTX timeline
        self.parent_id = parent_id    # remote parent span (adopted ctx)
        self.proc = proc or "main"
        self.host = socket.gethostname()
        self.pid = os.getpid()
        self.events = []   # one dict per span, in closing order
        self._tls = threading.local()
        self._lock = threading.Lock()
        # wall anchor: ts derives from the perf_counter delta, monotonic
        # within the process and wall-anchored for the cross-process merge
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _record(self, ev):
        with self._lock:
            self.events.append(ev)

    @contextmanager
    def span(self, name, parent=None, **attrs):
        """Record one span; yields its span id. `parent` overrides the
        inferred parent (the innermost open span on this thread, else the
        tracer's `parent_id`): a frame served on a worker links to the
        span id its caller sent. `attrs` ride on the span's event."""
        stack = self._stack()
        sid = new_span_id()
        if parent is None:
            parent = stack[-1] if stack else self.parent_id
        depth = len(stack)
        stack.append(sid)
        t0 = time.perf_counter()
        try:
            with (annotate(name) if self.annotate else nullcontext()):
                yield sid
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            ev = {"span": name, "depth": depth, "dur_s": dur,
                  "ts": self._wall0 + (t0 - self._perf0), "sid": sid,
                  "tid": threading.get_ident() % 1_000_000}
            if parent is not None:
                ev["parent"] = parent
            if attrs:
                ev.update(attrs)
            self._record(ev)

    def add_event(self, name, dur_s=None, ts=None, depth=None, **attrs):
        """A span of dur_s seconds at `depth` (default: the calling
        thread's current depth), starting at wall time `ts` (default:
        ending now), with `attrs` on its event (the JAX package's
        signature, keywords first)."""
        stack = self._stack()
        dur_s = 0.0 if dur_s is None else float(dur_s)
        ev = {"span": name,
              "depth": len(stack) if depth is None else depth,
              "dur_s": dur_s,
              "ts": time.time() - dur_s if ts is None else float(ts),
              "sid": new_span_id()}
        parent = stack[-1] if stack else self.parent_id
        if parent is not None:
            ev["parent"] = parent
        if attrs:
            ev.update(attrs)
        self._record(ev)
        return ev["sid"]

    def totals(self, depth=0):
        """name -> summed seconds over the spans at `depth`."""
        out = {}
        with self._lock:
            events = list(self.events)
        for ev in events:
            if ev["depth"] == depth:
                out[ev["span"]] = out.get(ev["span"], 0.0) + ev["dur_s"]
        return out

    def dump(self):
        """This process's slice of the trace as one JSON-able dict (what
        a worker's TRACE_DUMP reply carries; merge_traces' input)."""
        with self._lock:
            events = [dict(ev) for ev in self.events]
        return {"trace_id": self.trace_id, "proc": self.proc,
                "host": self.host, "pid": self.pid, "events": events}


class _NullTracer:
    """Records nothing: `span` costs one contextmanager enter/exit."""

    @contextmanager
    def span(self, name, parent=None, **attrs):
        yield None

    def add_event(self, name, dur_s=None, ts=None, depth=None, **attrs):
        return None


NULL_TRACER = _NullTracer()


def merge_traces(dumps, offsets=None):
    """Stitch per-process dumps into one timeline.

    dumps: Tracer.dump() dicts (or TRACE_DUMP replies); offsets: the
    seconds each dump's clock runs ahead of the reference clock (dump 0's,
    the dispatcher's), subtracted from its timestamps. Returns
    {"trace_id", "processes": [{proc, host, pid, offset_s, spans}],
    "events": [...]}, each event labelled with its process and the list
    sorted by corrected start time."""
    if offsets is None:
        offsets = [0.0] * len(dumps)
    trace_id = next((d.get("trace_id") for d in dumps
                     if d.get("trace_id")), None)
    processes, events = [], []
    for d, off in zip(dumps, offsets):
        if not d or not d.get("events"):
            continue
        if "processes" in d:
            # an already-merged timeline: its events carry their labels
            processes.extend(dict(p) for p in d.get("processes") or [])
            for ev in d["events"]:
                ev = dict(ev)
                ev["ts"] = float(ev.get("ts", 0.0)) - off
                events.append(ev)
            continue
        proc, host, pid = (d.get("proc") or "?", d.get("host") or "?",
                           d.get("pid") or 0)
        processes.append({"proc": proc, "host": host, "pid": pid,
                          "offset_s": float(off),
                          "spans": len(d["events"])})
        for ev in d["events"]:
            ev = dict(ev)
            ev["ts"] = float(ev.get("ts", 0.0)) - off
            ev.update(proc=proc, host=host, pid=pid)
            events.append(ev)
    events.sort(key=lambda ev: ev["ts"])
    return {"trace_id": trace_id, "processes": processes, "events": events}


_EVENT_KEYS = ("span", "ts", "dur_s", "sid", "parent", "proc", "host",
               "pid", "tid", "depth")


def to_chrome_trace(merged):
    """Merged timeline (merge_traces output, or a single Tracer.dump())
    -> Chrome trace-event JSON dict for chrome://tracing or Perfetto:
    complete events ("ph": "X") in microseconds from the earliest span,
    one metadata row per process, and the timeline's structured log
    events (obs/log.py) as instant events."""
    if "processes" not in merged:
        merged = merge_traces([merged])
    events = merged.get("events") or []
    base = min((ev["ts"] for ev in events), default=0.0)
    out = []
    for p in merged.get("processes", []):
        out.append({"ph": "M", "name": "process_name", "pid": p["pid"],
                    "args": {"name": f"{p['proc']}@{p['host']}"}})
    for ev in events:
        args = {k: v for k, v in ev.items() if k not in _EVENT_KEYS}
        args["sid"] = ev.get("sid")
        if ev.get("parent") is not None:
            args["parent"] = ev["parent"]
        out.append({
            "ph": "X", "name": ev["span"], "cat": "span",
            "ts": round((ev["ts"] - base) * 1e6, 1),
            "dur": round(ev["dur_s"] * 1e6, 1),
            "pid": ev.get("pid", 0), "tid": ev.get("tid", 0),
            "args": args,
        })
    for ev in merged.get("logs") or []:
        out.append({
            "ph": "i",
            "name": f"{ev.get('subsystem', '?')}/{ev.get('event', '?')}",
            "cat": "log", "s": "g",
            "ts": round((float(ev.get("ts", base)) - base) * 1e6, 1),
            "pid": ev.get("pid", 0), "tid": 0,
            "args": {k: v for k, v in ev.items() if k not in ("ts", "pid")},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"trace_id": merged.get("trace_id"),
                          "base_ts_s": base}}
