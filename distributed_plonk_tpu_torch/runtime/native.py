"""ctypes binding + on-demand build of the native library.

Replaces the reference's build.rs capnp codegen step
(reference build.rs:1-2): the repo's native/dpt_native.cpp is compiled
with the local g++ once per source hash into .native_build/ (the JAX
package's build directory: the same source gives the same library) and
memoized. Concurrent builds by a fleet of worker processes are safe: each
compiles to a pid-unique file and renames it into place.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO, "native", "dpt_native.cpp")
_BUILD_DIR = os.path.join(_REPO, ".native_build")

_lib = None


def build_native():
    """Compile (if needed) and return the path to the shared library."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"dpt_native_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # pid-unique tmp + atomic rename: a fleet of worker subprocesses
        # all hitting a fresh source hash build concurrently; a SHARED
        # tmp path lets one racer rename the file out from under another
        tmp = f"{so_path}.tmp.{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True)
        os.replace(tmp, so_path)
    return so_path


def lib():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build_native())
        L = _lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        L.le_bytes_to_limbs.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64, u32p]
        L.limbs_to_le_bytes.argtypes = [u32p, ctypes.c_uint64, ctypes.c_uint64, u8p]
        L.limbs_to_le_bytes.restype = ctypes.c_int
        L.transpose_u32.argtypes = [u32p, ctypes.c_uint64, ctypes.c_uint64, u32p]
        L.dpt_listen.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        L.dpt_accept.argtypes = [ctypes.c_int]
        L.dpt_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int]
        L.dpt_send.argtypes = [ctypes.c_int, ctypes.c_uint32, u8p, ctypes.c_uint64]
        L.dpt_recv_header.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32)]
        L.dpt_recv_payload.argtypes = [ctypes.c_int, u8p, ctypes.c_uint64]
        L.dpt_set_timeout.argtypes = [ctypes.c_int, ctypes.c_int]
        L.dpt_close.argtypes = [ctypes.c_int]
    return _lib


def _u8(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


# --- data plane --------------------------------------------------------------

def bytes_to_limbs(raw, n, elem_bytes):
    """Concatenated LE elements -> (elem_bytes/2, n) uint32 limb matrix."""
    inp = np.frombuffer(raw, dtype=np.uint8)
    assert inp.size == n * elem_bytes
    out = np.empty((elem_bytes // 2, n), dtype=np.uint32)
    lib().le_bytes_to_limbs(_u8(inp), n, elem_bytes, _u32(out))
    return out


def limbs_to_bytes(limbs):
    """(n_limbs, n) uint32 limb matrix -> concatenated LE elements."""
    limbs = np.ascontiguousarray(limbs, dtype=np.uint32)
    n_limbs, n = limbs.shape
    out = np.empty(n * n_limbs * 2, dtype=np.uint8)
    rc = lib().limbs_to_le_bytes(_u32(limbs), n, n_limbs * 2, _u8(out))
    if rc != 0:
        raise ValueError("unreduced limb at native boundary")
    return out.tobytes()


def transpose(arr):
    """Blocked transpose of a 2-D uint32 array."""
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    rows, cols = arr.shape
    out = np.empty((cols, rows), dtype=np.uint32)
    lib().transpose_u32(_u32(arr), rows, cols, _u32(out))
    return out


# --- transport ---------------------------------------------------------------

class Conn:
    """One framed TCP connection ([u64 len][u32 tag][payload])."""

    def __init__(self, fd):
        assert fd >= 0
        self.fd = fd

    def send(self, tag, payload=b""):
        buf = np.frombuffer(payload, dtype=np.uint8) if payload else \
            np.empty(0, dtype=np.uint8)
        rc = lib().dpt_send(self.fd, tag, _u8(buf), len(payload))
        if rc != 0:
            raise ConnectionError("send failed")

    def recv(self):
        length = ctypes.c_uint64()
        tag = ctypes.c_uint32()
        if lib().dpt_recv_header(self.fd, ctypes.byref(length),
                                 ctypes.byref(tag)) != 0:
            raise ConnectionError("recv header failed")
        buf = np.empty(length.value, dtype=np.uint8)
        if length.value and lib().dpt_recv_payload(self.fd, _u8(buf),
                                                   length.value) != 0:
            raise ConnectionError("recv payload failed")
        return tag.value, buf.tobytes()

    def set_timeout(self, ms):
        """Socket send/recv timeout. A timeout mid-frame desynchronizes the
        stream, so callers must reconnect after one fires (WorkerHandle
        does)."""
        if lib().dpt_set_timeout(self.fd, int(ms)) != 0:
            raise OSError("set_timeout failed")

    def close(self):
        if self.fd >= 0:
            lib().dpt_close(self.fd)
            self.fd = -1


class Listener:
    def __init__(self, host, port, backlog=16):
        self.fd = lib().dpt_listen(host.encode(), port, backlog)
        if self.fd < 0:
            raise OSError(f"cannot listen on {host}:{port}")

    def accept(self):
        return Conn(lib().dpt_accept(self.fd))

    def close(self):
        if self.fd >= 0:
            lib().dpt_close(self.fd)
            self.fd = -1


def listener_port(listener):
    """Actual bound port of a Listener (needed when it bound port 0 for
    an ephemeral port)."""
    import os
    import socket
    s = socket.socket(fileno=os.dup(listener.fd))
    try:
        return s.getsockname()[1]
    finally:
        s.close()


def connect(host, port, timeout_ms=0):
    """timeout_ms bounds the CONNECT itself (0 = blocking); I/O timeouts
    are set separately via Conn.set_timeout after the dial succeeds."""
    fd = lib().dpt_connect(host.encode(), port, timeout_ms)
    if fd < 0:
        raise ConnectionError(f"cannot connect to {host}:{port}")
    return Conn(fd)
