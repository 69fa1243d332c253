"""On-demand profile capture (the PROFILE wire tag's engine; the port of
the JAX package's obs/profiling.py).

Two capture formats, chosen by what the process can do:

    torch-trace-gz  torch.profiler with CPU and CUDA activity around the
                    window, the Chrome trace it exports gzipped into one
                    blob (chrome://tracing or Perfetto): every kernel the
                    process launched in the window, from any thread,
                    named (ntt_pass_kernel, chunk_kernel, ...). The
                    counterpart of the JAX package's xplane-targz.
    pystacks-json   all-thread Python stack sampler (host workers, or a
                    torch capture that failed): every 1 / SAMPLE_HZ s it
                    grabs sys._current_frames() and accumulates collapsed
                    stacks, seeing every connection thread's work.

`capture(kind="auto")` takes torch.profiler on a CUDA device and the
sampler otherwise. A torch capture that fails falls back to the sampler,
and its meta says so (`"fallback_from": "torch"` and the error): a
fallback never passes as a torch capture. torch.profiler allows one
session per process, so torch captures hold a lock; a second request
while one runs is refused with an error meta, never queued behind a
minute-long window.

`capture()` never raises: a failed capture returns a degraded but valid
({"format": "error", ...}, b"") pair, because observability must never
kill the serving thread that armed it.

Captures are content-addressed by blob digest: `profile_id(blob)` is the
store key suffix (`profile:<id>`, store/keycache.py), so identical
captures dedupe and the /profile/<id> URL is tamper-evident.
"""

import gzip
import hashlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time

DEFAULT_MS = 250
SAMPLE_HZ = 100.0
MAX_MS = 60_000  # a scraper typo must not arm a minute-long capture

_TORCH_LOCK = threading.Lock()
_warmed = False


def profile_id(blob):
    """Content id for one capture blob (16 hex chars)."""
    return hashlib.sha256(blob).hexdigest()[:16]


def capture(duration_ms=None, kind="auto", device=None):
    """(meta dict, blob bytes) for one profile window. kind: "auto"
    (torch on a CUDA device, else stacks), "torch", or "stacks"; device:
    the device whose work the window covers (a torch.device or its
    name; None is the host)."""
    ms = min(int(duration_ms or DEFAULT_MS), MAX_MS)
    try:
        cuda = device is not None and str(device).startswith("cuda")
        if kind == "torch" or (kind == "auto" and cuda):
            if not _TORCH_LOCK.acquire(blocking=False):
                return {"format": "error", "duration_ms": ms,
                        "error": "a torch.profiler capture is already "
                                 "running in this process"}, b""
            try:
                return _capture_torch(ms, device if cuda else None)
            except Exception as e:  # noqa: BLE001 - degrade, say so
                meta, blob = _capture_stacks(ms)
                meta.update(fallback_from="torch", error=repr(e)[:300])
                return meta, blob
            finally:
                _TORCH_LOCK.release()
        return _capture_stacks(ms)
    except Exception as e:  # noqa: BLE001 - never kill the serving thread
        return {"format": "error", "duration_ms": ms,
                "error": repr(e)[:300]}, b""


def _warm(activities):
    """The first torch.profiler session of a process pays for the
    profiler's (CUPTI's) start-up, and a short window opened cold can end
    before device activity is recorded: open and close one empty session
    first, once per process."""
    global _warmed
    if _warmed:
        return
    from torch.profiler import profile
    with profile(activities=activities):
        pass
    _warmed = True


def _capture_torch(ms, device):
    """torch.profiler window -> gzipped Chrome trace. The device is
    synchronized before the session stops, so kernels launched inside
    the window and still running are in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None:
        acts.append(ProfilerActivity.CUDA)
    _warm(acts)
    tmp = tempfile.mkdtemp(prefix="dpt-profile-")
    try:
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            time.sleep(ms / 1000.0)
            if device is not None:
                torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, "rb") as f:
            raw = f.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    events = json.loads(raw).get("traceEvents") or []
    kernels = sum(1 for ev in events
                  if ev.get("cat") in ("kernel", "Kernel"))
    blob = gzip.compress(raw, mtime=0)
    return {"format": "torch-trace-gz", "duration_ms": ms,
            "window_s": round(window_s, 6), "events": len(events),
            "kernel_events": kernels, "bytes": len(blob),
            "device": str(device) if device is not None else "cpu"}, blob


def _capture_stacks(ms):
    """All-thread stack sampler: collapsed stacks -> JSON blob."""
    stacks = {}
    samples = 0
    me = threading.get_ident()
    interval = 1.0 / SAMPLE_HZ
    deadline = time.perf_counter() + ms / 1000.0
    while time.perf_counter() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # the sampler's own loop is noise
            parts = []
            depth = 0
            while frame is not None and depth < 64:
                code = frame.f_code
                parts.append(f"{os.path.basename(code.co_filename)}:"
                             f"{code.co_name}:{frame.f_lineno}")
                frame = frame.f_back
                depth += 1
            key = ";".join(reversed(parts))
            stacks[key] = stacks.get(key, 0) + 1
        samples += 1
        time.sleep(interval)
    blob = json.dumps(
        {"format": "pystacks-json", "duration_ms": ms,
         "sample_hz": SAMPLE_HZ, "samples": samples,
         "stacks": dict(sorted(stacks.items(), key=lambda kv: -kv[1]))},
        separators=(",", ":")).encode()
    return {"format": "pystacks-json", "duration_ms": ms,
            "samples": samples, "bytes": len(blob)}, blob


def kernel_names(blob):
    """The names of the device kernels in a torch-trace-gz blob, with
    their counts."""
    events = json.loads(gzip.decompress(blob)).get("traceEvents") or []
    out = {}
    for ev in events:
        if ev.get("cat") in ("kernel", "Kernel"):
            out[ev.get("name", "?")] = out.get(ev.get("name", "?"), 0) + 1
    return out
