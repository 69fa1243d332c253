"""Host-side conversion between Python ints and device word tensors.

Device representation: 32-bit little-endian words, limbs on the LEADING
axis -> a torch.int32 tensor (8, *batch) for Fr, (12, *batch) for Fq. Each
entry holds a uint32 bit pattern (torch has no uint32 arithmetic); kernels
read the same bytes as uint32, and the plain torch paths widen to int64.

The JAX package's handles are (16, *batch) / (24, *batch) uint32 arrays of
16-bit limbs in the same Montgomery radix; `from_jax_limbs` /
`to_jax_limbs` convert between the two by a pure bit reshuffle (word i =
limb 2i | limb 2i+1 << 16, i.e. field_jax.pack_limb_pairs).
"""

import numpy as np
import torch

from ..constants import R_MOD, FR_MONT_R, FR_WORDS, WORD_BITS

_R_INV = pow(FR_MONT_R, -1, R_MOD)


def ints_to_words(xs, n_words):
    """List of ints -> (n_words, len(xs)) uint32 numpy array."""
    nbytes = 4 * n_words
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(xs), n_words)
    return np.ascontiguousarray(arr.T)


def words_to_ints(arr):
    """(n_words, n) uint32 array -> list of n Python ints."""
    arr = np.asarray(arr, dtype=np.uint32)
    assert arr.ndim == 2
    raw = np.ascontiguousarray(arr.T).astype("<u4").tobytes()
    nbytes = 4 * arr.shape[0]
    return [int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "little")
            for i in range(arr.shape[1])]


def to_tensor(arr, device):
    """uint32 numpy words -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_numpy(t):
    """int32 word tensor -> uint32 numpy array with the same bits."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint32)


def _join16(a):
    """(2K, *batch) uint32 16-bit limbs -> (K, *batch) uint32 words."""
    a = np.asarray(a, dtype=np.uint32)
    assert a.shape[0] % 2 == 0, a.shape
    return a[0::2] | (a[1::2] << np.uint32(16))


def _split16(w):
    """(K, *batch) uint32 words -> (2K, *batch) uint32 16-bit limbs."""
    out = np.empty((2 * w.shape[0],) + w.shape[1:], dtype=np.uint32)
    out[0::2] = w & np.uint32(0xFFFF)
    out[1::2] = w >> np.uint32(16)
    return out


def from_jax_limbs(arr, device):
    """JAX (2K, *batch) uint32 16-bit limbs -> port (K, *batch) int32 words."""
    return to_tensor(_join16(arr), device)


def to_jax_limbs(t):
    """Port (K, *batch) int32 words -> JAX (2K, *batch) uint32 16-bit limbs."""
    return _split16(to_numpy(t))


def ints_to_limbs16(xs, n_words=FR_WORDS):
    """Ints -> (2 * n_words, len(xs)) uint32 16-bit limbs (the JAX
    package's limbs.ints_to_limbs layout)."""
    return _split16(ints_to_words(xs, n_words))


def limbs16_to_ints(arr):
    """(2K, n) uint32 16-bit limbs -> n ints."""
    return words_to_ints(_join16(arr))


def lift(values, device):
    """Canonical Fr ints -> (8, n) Montgomery handle (prover_jax.lift)."""
    return to_tensor(ints_to_words([v % R_MOD * FR_MONT_R % R_MOD
                                    for v in values], FR_WORDS), device)


def lift_scalar(x, device, ndim=2):
    """One Fr int -> (8, 1, ...) Montgomery broadcastable constant."""
    return lift([x], device).reshape((FR_WORDS,) + (1,) * (ndim - 1))


def lower(h):
    """(8, n) Montgomery handle -> canonical Fr ints (prover_jax.lower)."""
    return [v * _R_INV % R_MOD for v in words_to_ints(to_numpy(h))]


assert WORD_BITS == 32
