"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` compiles with `nvcc` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ctypes; pointers and the stream pass as `c_void_p`. All sources build
at once, one `nvcc` process each, at first use, into
`build/dpt_torch_kernels/<hash>/` under the checkout, keyed by a hash of
every source and the flags — an edit rebuilds, an unchanged tree reuses.
The existence check and the build run under an `fcntl` lock file beside
the build directory (`<hash>.lock`), so processes that start together on
a tree with no built kernels (a supervisor's workers) run nvcc once: the
first builds, the others wait and load its libraries.

There is no fallback: without `nvcc` or a card, `load()` raises.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BUILD_DIR = os.path.join(_ROOT, "build", "dpt_torch_kernels")

# library name -> source file
SOURCES = {
    "field": "mont_mul.cu",
    "ntt": "ntt.cu",
    "msm": "msm_bucket.cu",
    "curve": "curve_add.cu",
}
HEADERS = ("field.cuh", "curve.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_V = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures (every function returns its launch's cudaGetLastError())
SIGNATURES = {
    "field": {"dpt_mont_mul": (_I, _V, _V, _L, _L, _L, _V, _L, _L, _L, _L,
                               _L, _V)},
    "ntt": {"dpt_ntt_pass": (_V, _V, _V, _V, _V, _V, _V, _V, _V)},
    "msm": {"dpt_msm_digits": (_V, _V, _V, _V, _I, _L, _I, _I, _I, _I, _I,
                               _V),
            "dpt_bucket_sums": (_V, _V, _V, _V, _V, _V, _V, _V, _V, _L, _I,
                                _L, _I, _V)},
    "curve": {"dpt_proj_add": (_V, _V, _V, _V, _V, _V, _V, _V, _V, _L,
                               _V),
              "dpt_msm_tail": (_V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I,
                               _V)},
}

_lock = threading.Lock()
_libs = None
build_log = {}  # library name -> nvcc output (ptxas register/spill report)
build_seconds = {}  # library name -> seconds until its nvcc finished

# Launch counters, one plain integer per kernel entry: each wrapper adds one
# where it launches its kernel (the NTT counts every pass it launches;
# proj_add counts the full add and proj_add_mixed the mixed add of the same
# kernel; bucket_sums counts one per call, which launches its chunk and
# tree kernels). CALLS counts the entry calls of the NTT, which launches
# one kernel per pass. The service's pool threads launch concurrently, so
# every increment goes through count() under a lock (a bare `+= 1` on a
# dict entry can lose an update when two threads interleave).
LAUNCHES = {"mont_mul": 0, "ntt": 0, "msm_digits": 0, "bucket_sums": 0,
            "msm_tail": 0, "proj_add": 0, "proj_add_mixed": 0}
CALLS = {"ntt": 0}
_count_lock = threading.Lock()


def count(name, counts=LAUNCHES):
    """Add one to counts[name] (LAUNCHES by default)."""
    with _count_lock:
        counts[name] += 1


def reset_launches():
    with _count_lock:
        for counts in (LAUNCHES, CALLS):
            for k in counts:
                counts[k] = 0


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(set(SOURCES.values()) | set(HEADERS)):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _build(out_dir):
    """Compile every source in parallel into out_dir; raise on failure."""
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    procs, outs, t0 = {}, {}, time.perf_counter()
    for name, src in SOURCES.items():
        tmp = os.path.join(out_dir, "lib%s.so.tmp%d" % (name, os.getpid()))
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))

    def wait(name, proc):
        outs[name] = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(name, proc))
               for name, (_, proc) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    errors = []
    for name, (tmp, proc) in procs.items():
        out = outs[name]
        build_log[name] = out
        if proc.returncode != 0:
            errors.append("%s (%s):\n%s" % (name, SOURCES[name], out))
            continue
        os.replace(tmp, os.path.join(out_dir, "lib%s.so" % name))
        with open(os.path.join(out_dir, "%s.log" % name), "w") as f:
            f.write(out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))


def _ensure_built():
    """The build directory of this tree's sources, built if needed. The
    check and the build hold an exclusive lock on `<hash>.lock` across
    processes (the in-process callers are serialized by `_lock`)."""
    digest = source_hash()
    out_dir = os.path.join(BUILD_DIR, digest)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, digest + ".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not all(os.path.exists(os.path.join(out_dir, "lib%s.so" % n))
                       for n in SOURCES):
                _build(out_dir)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out_dir


def load():
    """name -> ctypes.CDLL for every kernel library, building if needed."""
    global _libs
    with _lock:
        if _libs is not None:
            return _libs
        out_dir = _ensure_built()
        libs = {}
        for name in SOURCES:
            lib = ctypes.CDLL(os.path.join(out_dir, "lib%s.so" % name))
            for fn, sig in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                f.argtypes = list(sig)
            libs[name] = lib
            log = os.path.join(out_dir, "%s.log" % name)
            if name not in build_log and os.path.exists(log):
                with open(log) as f:
                    build_log[name] = f.read()
        _libs = libs
        return libs


def check(rc, what):
    """Raise on a non-zero cudaGetLastError() code returned by a launch."""
    if rc != 0:
        raise RuntimeError("CUDA launch of %s failed: cudaError %d"
                           % (what, rc))
