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

The build directory is the checkout's `build/dpt_torch_kernels/` unless
`set_build_dir(path)` names another before the first `load()`. A built
directory travels as one blob: `pack_build()` tars this tree's libraries
and their nvcc logs with the meta that decides whether another host may
load them (source hash, nvcc flags, compute capability), and
`install_build(blob, meta)` checks that meta and every member name, then
renames the unpacked directory into place under the same `<hash>.lock`
the build holds (store/kernels.py keeps the blob as a `kbuild:` store
artifact). `build_report` is the one record of where this process's
libraries came from: `local` (already in the build directory), `store` or
`peer` (installed from a blob) or `nvcc` (built here), with the seconds
store/kernels.ensure_build took to provision them. HEALTH, METRICS and
the operator scripts serve it as it is.

There is no fallback: without `nvcc` or a card, `load()` raises, and a
library that fails to load raises too; it is never rebuilt behind the
caller's back.
"""

import ctypes
import fcntl
import hashlib
import io
import os
import shutil
import subprocess
import tarfile
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
    "round3": "round3.cu",
    "finish": "msm_finish.cu",
    "eval": "eval.cu",
}
HEADERS = ("field.cuh", "curve.cuh", "msm_tail.cuh", "curve_coop.cuh")
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
                               _I, _I, _V),
              "dpt_msm_tail": (_V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I,
                               _V)},
    "round3": {"dpt_r3_gate_fold": (_V, _L, _V, _L, _V, _L, _L, _V, _L, _L,
                                    _I, _I, _L, _V),
               "dpt_r3_sigma_fold": (_V, _L, _V, _L, _V, _L, _L, _V, _L,
                                     _L, _I, _I, _L, _V, _V),
               "dpt_r3_combine": (_V, _V, _L, _L, _V, _V, _L, _V, _V)},
    "finish": {"dpt_msm_finish": (_V, _V, _V, _V, _V, _V, _V, _V, _V, _I,
                                   _I, _I, _I, _I, _I, _I, _V)},
    "eval": {"dpt_poly_eval": (_V, _V, _L, _L, _L, _V, _L, _L, _I, _I, _I,
                               _I, _V)},
}

_lock = threading.Lock()
_libs = None
build_log = {}  # library name -> nvcc output (ptxas register/spill report)
build_seconds = {}  # library name -> seconds until its nvcc finished
# where this process's libraries came from: source None until the first
# install or load (on the CPU it stays None: no kernels load); "nvcc" from
# the moment store/kernels.ensure_build falls through to a build or a build
# starts (nvcc_s, the seconds until its last library, once every library
# is built here; None while it runs or when another process built them
# under the lock); install_s and bytes for a blob installed from a store
# or peer; seconds, ensure_build's own time (for nvcc, until its build
# thread started)
build_report = {"source": None, "nvcc_s": None, "install_s": None,
                "bytes": None, "dir": None, "seconds": None}

# Launch counters, one plain integer per kernel entry: each wrapper adds one
# where it launches its kernel (the NTT counts every pass it launches;
# proj_add counts the full add, one for a launch of `reps` doublings, and
# proj_add_mixed the mixed add of the same entry; bucket_sums counts one
# per call, which launches its chunk and tree kernels; each round-3 fold
# counts its one launch; msm_finish counts one per call, which launches
# its window-sum and Horner kernels; poly_eval counts one per call, which
# launches one kernel). CALLS counts the entry calls of the
# NTT, which launches one kernel per pass. The service's pool threads
# launch concurrently, so every increment goes through count() under a
# lock (a bare `+= 1` on a dict entry can lose an update when two threads
# interleave).
LAUNCHES = {"mont_mul": 0, "ntt": 0, "msm_digits": 0, "bucket_sums": 0,
            "msm_tail": 0, "proj_add": 0, "proj_add_mixed": 0,
            "r3_gate_fold": 0, "r3_sigma_fold": 0, "r3_combine": 0,
            "msm_finish": 0, "poly_eval": 0}
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


def set_build_dir(path):
    """Build and load under `path` instead of the checkout's directory.
    Call it before the first load(): the libraries of a process come from
    one directory."""
    global BUILD_DIR
    path = os.path.abspath(path)
    with _lock:
        if _libs is not None and path != BUILD_DIR:
            raise RuntimeError("set_build_dir(%r) after the kernels loaded "
                               "from %s" % (path, BUILD_DIR))
        BUILD_DIR = path


def build_dir():
    """This tree's build directory (it may not exist yet)."""
    return os.path.join(BUILD_DIR, source_hash())


def _complete(out_dir):
    return all(os.path.exists(os.path.join(out_dir, "lib%s.so" % n))
               for n in SOURCES)


def is_built():
    """Whether this tree's libraries are in the build directory."""
    return _complete(build_dir())


def report():
    """A copy of build_report."""
    return dict(build_report)


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


class _DirLock:
    """The exclusive `<hash>.lock` beside a build directory, across
    processes and threads (each holder opens its own file description)."""

    def __init__(self, digest):
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.path = os.path.join(BUILD_DIR, digest + ".lock")

    def __enter__(self):
        self.f = open(self.path, "a")
        fcntl.flock(self.f, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self.f, fcntl.LOCK_UN)
        self.f.close()
        return False


def _ensure_built():
    """The build directory of this tree's sources, built if needed. The
    check and the build hold an exclusive lock on `<hash>.lock` across
    processes (the in-process callers are serialized by `_lock`)."""
    digest = source_hash()
    out_dir = os.path.join(BUILD_DIR, digest)
    with _DirLock(digest):
        if not _complete(out_dir):
            build_report.update(source="nvcc", install_s=None, bytes=None)
            t0 = time.perf_counter()
            _build(out_dir)
            build_report["nvcc_s"] = round(time.perf_counter() - t0, 3)
    return out_dir


def nvcc_version():
    """The last line of `nvcc --version`, or None without nvcc."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    lines = [line for line in out.splitlines() if line.strip()]
    return lines[-1].strip() if lines else None


def _member_names():
    return ({"lib%s.so" % n for n in SOURCES}
            | {"%s.log" % n for n in SOURCES})


def pack_build(capability):
    """This tree's built directory as one blob: -> (blob, meta). The blob
    is an uncompressed tar of every `lib<name>.so` and its `<name>.log`;
    meta holds what install_build checks (source_hash, nvcc_flags,
    capability "sm_<major><minor>" of the card the build is for) and the
    nvcc version line, each file's size and the blob's bytes. Raises
    when the directory is not complete."""
    out_dir = build_dir()
    if not _complete(out_dir):
        raise RuntimeError("no complete build in %s to pack" % out_dir)
    buf = io.BytesIO()
    files = {}
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.PAX_FORMAT) \
            as tar:
        for name in sorted(_member_names()):
            path = os.path.join(out_dir, name)
            if not os.path.exists(path):
                continue        # a log of a build made before logs were kept
            with open(path, "rb") as f:
                data = f.read()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mode = 0o755 if name.endswith(".so") else 0o644
            tar.addfile(info, io.BytesIO(data))
            files[name] = len(data)
    meta = {"source_hash": source_hash(), "nvcc_flags": list(NVCC_FLAGS),
            "capability": capability, "nvcc_version": nvcc_version(),
            "files": files}
    blob = buf.getvalue()
    meta["bytes"] = len(blob)
    return blob, meta


class BuildRejected(ValueError):
    """A packed build this process must not install: foreign meta, a
    member outside the library names, or a blob that does not unpack."""


def _unpack_members(blob, meta):
    """{name: bytes} of a packed build, every check done before a byte
    is written: regular files only, each named lib<name>.so or <name>.log
    for a name in SOURCES (so no path component), every library present,
    each size the meta's."""
    allowed = _member_names()
    try:
        tar = tarfile.open(fileobj=io.BytesIO(blob), mode="r:")
        members = tar.getmembers()
    except (tarfile.TarError, EOFError, OSError) as e:
        raise BuildRejected("packed build does not unpack: %r" % e)
    out = {}
    for m in members:
        if m.name not in allowed or not m.isfile():
            raise BuildRejected("packed build holds %r" % m.name)
        if m.name in out:
            raise BuildRejected("packed build repeats %r" % m.name)
        out[m.name] = tar.extractfile(m).read()
    missing = sorted({"lib%s.so" % n for n in SOURCES} - set(out))
    if missing:
        raise BuildRejected("packed build lacks %s" % missing)
    sizes = meta.get("files") or {}
    if {k: len(v) for k, v in out.items()} != sizes:
        raise BuildRejected("packed build's sizes differ from its meta")
    return out


def install_build(blob, meta, capability, source="store"):
    """Install a packed build (pack_build's blob and meta) as this tree's
    build directory. Refuses (BuildRejected) a foreign source hash, other
    nvcc flags, another capability than `capability` (this card's, as
    "sm_<major><minor>"), or a blob whose members are not exactly the
    library names. The members unpack into a temporary directory that is
    renamed into `<build dir>/<hash>/` under the `<hash>.lock` the build
    holds; a directory that is already complete is kept (a racing install
    or build got there first). Records `source`, the install seconds and
    the blob's bytes in build_report. Returns build_report's copy."""
    t0 = time.perf_counter()
    digest = source_hash()
    if meta.get("source_hash") != digest:
        raise BuildRejected("packed build of sources %r, this tree is %s"
                            % (meta.get("source_hash"), digest))
    if tuple(meta.get("nvcc_flags") or ()) != NVCC_FLAGS:
        raise BuildRejected("packed build's nvcc flags differ")
    if meta.get("capability") != capability:
        raise BuildRejected("packed build for %r, this card is %r"
                            % (meta.get("capability"), capability))
    if meta.get("bytes") != len(blob):
        raise BuildRejected("packed build of %d bytes, its meta says %r"
                            % (len(blob), meta.get("bytes")))
    members = _unpack_members(blob, meta)
    out_dir = os.path.join(BUILD_DIR, digest)
    with _DirLock(digest):
        if not _complete(out_dir):
            tmp = os.path.join(BUILD_DIR, ".%s.tmp%d.%d" % (
                digest, os.getpid(), threading.get_ident()))
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for name, data in members.items():
                with open(os.path.join(tmp, name), "wb") as f:
                    f.write(data)
                if name.endswith(".so"):
                    os.chmod(os.path.join(tmp, name), 0o755)
            # a partial directory (a build that died) makes way
            shutil.rmtree(out_dir, ignore_errors=True)
            os.rename(tmp, out_dir)
    build_report.update(source=source, bytes=len(blob), dir=out_dir,
                        install_s=round(time.perf_counter() - t0, 6))
    return report()


def load():
    """name -> ctypes.CDLL for every kernel library, building if needed."""
    global _libs
    with _lock:
        if _libs is not None:
            return _libs
        out_dir = _ensure_built()
        if build_report["source"] is None:
            build_report["source"] = "local"
        build_report["dir"] = out_dir
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
