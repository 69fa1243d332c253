"""Prime-field arithmetic on word tensors: the port of backend/field_jax.py.

Values are (L, *batch) torch.int32 tensors of 32-bit little-endian words
(L = 8 for Fr, 12 for Fq) in Montgomery form with R = 2^256 / 2^384 — the
JAX package's radix, so every canonical result has the same bits as
field_jax's (`limbs.from_jax_limbs` is the bit-level map between them).

`mont_mul` is kernel 1 (csrc/mont_mul.cu): on a CUDA tensor it launches the
kernel on the operands as they are (broadcast scalars and strided slices
are read through their strides, never copied), on a CPU tensor it runs
`mont_mul_ref`, its plain torch version.
add / sub / neg are plain torch on either device (the JAX package computes
them in XLA, outside any Pallas kernel); they widen the words to int64,
since torch cannot add, shift or compare uint32.
"""

import torch

from ..constants import (R_MOD, Q_MOD, FR_WORDS, FQ_WORDS, FR_MONT_R,
                         FQ_MONT_R, FR_MONT_R2, FQ_MONT_R2, FR_MONT_INV,
                         FQ_MONT_INV, FR_MONT_INV32, FQ_MONT_INV32,
                         WORD_MASK)
from . import _build

_M16 = 0xFFFF


class FieldSpec:
    """Static per-field constants (host ints and word lists)."""

    def __init__(self, name, index, mod, n_words, mont_r, mont_r2,
                 mont_inv, n0):
        self.name = name
        self.index = index          # field selector of the C interface
        self.mod = mod
        self.n_words = n_words
        self.mont_r = mont_r        # 1 in Montgomery form
        self.mont_r2 = mont_r2
        self.n0 = n0                # -p^-1 mod 2^32
        self.mod_words = [(mod >> (32 * i)) & WORD_MASK
                          for i in range(n_words)]
        self.negmod_words = [(((1 << (32 * n_words)) - mod) >> (32 * i))
                             & WORD_MASK for i in range(n_words)]
        nl = 2 * n_words
        # 16-bit limb constants of the plain multiplier
        self.mod16 = [(mod >> (16 * i)) & _M16 for i in range(nl)]
        self.ninv16 = [(mont_inv >> (16 * i)) & _M16 for i in range(nl)]
        self.negmod16 = [(((1 << (16 * nl)) - mod) >> (16 * i)) & _M16
                         for i in range(nl)]


FR = FieldSpec("Fr", 0, R_MOD, FR_WORDS, FR_MONT_R, FR_MONT_R2,
               FR_MONT_INV, FR_MONT_INV32)
FQ = FieldSpec("Fq", 1, Q_MOD, FQ_WORDS, FQ_MONT_R, FQ_MONT_R2,
               FQ_MONT_INV, FQ_MONT_INV32)


# Side conditions that intervals cannot prove: a value spread across words
# stays below 2p, a carry out is zero, a running sum fits its words. Each is
# a named inequality over a FieldSpec's real constants that the port's
# static verifier (analysis/bounds.py::check_contracts) evaluates for Fr and
# Fq; "where" names the code that relies on it ("csrc/field.cuh:N" quotes
# "quote" from that line). The interval pass proves the plain versions'
# int64 arithmetic never wraps; these prove what that arithmetic assumes
# of the moduli, and what the CUDA bodies assume, whose carry chains no
# interval reaches.

def _r(spec):
    return 1 << (32 * spec.n_words)


CARRY_CONTRACTS = (
    {"name": "reduce_once_fits",
     "where": "field_torch._reduce_once, add",
     "claim": "a + b < 2p <= 2^(32L): add's sum fits L words plus a carry "
              "of at most 1, and _reduce_once's one conditional subtract "
              "of (hi:w) < 2p leaves a canonical value",
     "holds": lambda spec: 2 * spec.mod <= _r(spec)},
    {"name": "sweep32_columns",
     "where": "field_torch._sweep32 (add, sub, _reduce_once)",
     "claim": "_sweep32's callers feed columns of at most three terms below "
              "2^32 (a + ~b + 1, w + (2^(32L) - p)): each column plus its "
              "carry in (< 4) stays below 2^62, as its docstring asks",
     "holds": lambda spec: 3 * (1 << 32) + 4 < 1 << 62},
    {"name": "mont_hi_fits",
     "where": "field_torch.mont_mul_ref",
     "claim": "for a, b < p the Montgomery high half (a*b + m*p) / R is "
              "< 2p (p^2 + R*p <= 2*p*R, i.e. p <= R), so the one "
              "conditional subtract leaves a canonical value",
     "holds": lambda spec: spec.mod ** 2 + _r(spec) * spec.mod
              <= 2 * spec.mod * _r(spec)},
    {"name": "mont_ref_columns_int64",
     "where": "field_torch.mont_mul_ref (_mul_cols, _sweep16)",
     "claim": "mont_mul_ref's 16-bit column sums stay below 2^62: a column "
              "of t + m*p takes at most 2 * 2L products of two 16-bit "
              "limbs plus a carry in below 2^47",
     "holds": lambda spec: 4 * spec.n_words * ((1 << 16) - 1) ** 2
              + (1 << 47) < 1 << 62},
    {"name": "cuh_reduce_once_top_bit",
     "where": "csrc/field.cuh:114",
     "quote": "t < 2p (< 2^(32N): both moduli leave the",
     "claim": "fe_reduce_once takes t < 2p < 2^(32N): t fits N words, and "
              "one borrow chain decides t >= p",
     "holds": lambda spec: 2 * spec.mod < _r(spec)},
    {"name": "cuh_add_no_carry_out",
     "where": "csrc/field.cuh:128",
     "quote": "a + b < 2p < 2^(32N), so no carry leaves the top",
     "claim": "fe_add's sum of two values < p is < 2p - 1 < 2^(32N): its "
              "top word's addc drops no carry",
     "holds": lambda spec: 2 * (spec.mod - 1) < _r(spec)},
    {"name": "cuh_cios_row_fits",
     "where": "csrc/field.cuh:161-170",
     "quote": "both moduli satisfy 2p < 2^(32N) with room",
     "claim": "the top word of p is below 2^31 - 1, and CIOS's running sum "
              "before a row's division, T + a*b_i + m*p < 2p + 2^32 * 2p, "
              "stays under 2^(32N + 32): the odd array's reduction chain "
              "carries out 0, and no spare word is needed",
     "holds": lambda spec: (spec.mod >> (32 * (spec.n_words - 1)))
              < (1 << 31) - 1
              and 2 * spec.mod * ((1 << 32) + 1) <= _r(spec) << 32},
    {"name": "cuh_mont_final_fits",
     "where": "csrc/field.cuh:258",
     "quote": "the sum is even + (odd >> 32) < 2p",
     "claim": "after the last CIOS row the sum (a*b + M*p) / R < 2p for "
              "a, b < p and M < R, and 2p < 2^(32N): the final carry chain "
              "fits N words and fe_reduce_once's precondition holds",
     "holds": lambda spec: spec.mod ** 2 + _r(spec) * spec.mod
              <= 2 * spec.mod * _r(spec) and 2 * spec.mod < _r(spec)},
)


def device_of(device):
    """torch.device with its index filled in ("cuda" -> "cuda:0")."""
    return torch.empty(0, device=device).device


def resolve_device(device, who):
    """An entry point's device argument: None means "cuda" and raises
    without a card; "cpu" has to be asked for, and runs the plain
    versions of the kernels."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("%s: CUDA is not available (pass device='cpu' "
                           "for the plain path)" % who)
    if device.type not in ("cuda", "cpu"):
        raise ValueError("%s: unsupported device %s" % (who, device))
    return device_of(device)


# --- word tensors <-> int64 -------------------------------------------------

def _wide(a):
    """int32 words -> int64 in [0, 2^32)."""
    return a.to(torch.int64) & WORD_MASK


def _narrow(w):
    """int64 in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def pad_words(v, n):
    """v zero-padded along its last axis to n entries. An int zero:
    torch.nn.functional.pad passes its value as a float, a float literal
    in the word kernels' graphs."""
    return torch.constant_pad_nd(v, (0, n - v.shape[-1]), 0)


_COLS = {}


def _col(values, ndim, device):
    """Host list -> (len, 1, ..., 1) int64 constant (memoized: the plain
    paths ask for the same few field constants on every call)."""
    key = (tuple(values), ndim, str(device))
    hit = _COLS.get(key)
    if hit is None:
        hit = _COLS[key] = torch.tensor(
            values, dtype=torch.int64, device=device).reshape(
                (len(values),) + (1,) * (ndim - 1))
    return hit


def const(spec, value, device, ndim=2):
    """One field int (already in the wanted form) -> (L, 1, ...) words."""
    words = [(value >> (32 * i)) & WORD_MASK for i in range(spec.n_words)]
    return _narrow(_col(words, ndim, device))


# --- add / sub (plain torch) -------------------------------------------------

def _sweep32(x):
    """Carry-propagate non-negative int64 word columns (each < 2^62):
    returns (words < 2^32, carry out of the top word). The words are
    stacked once at the end: a row-by-row assignment costs one
    device-to-device copy per word."""
    rows = []
    c = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        v = x[i] + c
        rows.append(v & WORD_MASK)
        c = v >> 32
    return torch.stack(rows), c


def _reduce_once(spec, w, hi):
    """(hi:w) - p if (hi:w) >= p else w, for (hi:w) < 2p; int64 words.
    Adding 2^(32L) - p carries out exactly when w >= p."""
    d, c = _sweep32(w + _col(spec.negmod_words, w.dim(), w.device))
    return torch.where(((c != 0) | (hi != 0))[None], d, w)


def add(spec, a, b):
    """a + b mod p (inputs < p)."""
    w, c = _sweep32(_wide(a) + _wide(b))
    return _narrow(_reduce_once(spec, w, c))


def sub(spec, a, b):
    """a - b mod p (inputs < p): a + (2^(32L) - b) carries out iff a >= b;
    otherwise the wrapped difference gets p added back."""
    nb = WORD_MASK - _wide(b)                      # ~b, word by word
    one = torch.zeros_like(nb)
    one[0] = 1
    w, c = _sweep32(_wide(a) + nb + one)           # a - b mod 2^(32L)
    wp, _ = _sweep32(w + _col(spec.mod_words, w.dim(), w.device))
    return _narrow(torch.where((c != 0)[None], w, wp))


def neg(spec, a):
    return sub(spec, torch.zeros_like(a), a)


def double(spec, a):
    return add(spec, a, a)


# --- kernel 1: Montgomery multiply ------------------------------------------

def _to16(a):
    """(L, *b) int32 words -> (2L, *b) int64 16-bit limbs."""
    w = _wide(a)
    return torch.stack([w & _M16, w >> 16], dim=1).reshape(
        (2 * a.shape[0],) + tuple(a.shape[1:]))


def _from16(limbs):
    return _narrow(limbs[0::2] | (limbs[1::2] << 16))


def _sweep16(cols):
    """Exact carry normalization of non-negative int64 column sums (each
    < 2^62), rippled limb by limb: returns (limbs < 2^16, carry out of the
    top limb)."""
    out = torch.empty_like(cols)
    c = torch.zeros_like(cols[0])
    for i in range(cols.shape[0]):
        v = cols[i] + c
        out[i] = v & _M16
        c = v >> 16
    return out, c


def _mul_cols(a, b, n_out):
    """Column sums of the product of two 16-bit limb vectors, truncated to
    n_out columns (each sum < 2L * 2^32, exact in int64), row by row."""
    la, lb = a.shape[0], b.shape[0]
    batch = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    out = torch.zeros((n_out,) + batch, dtype=torch.int64, device=a.device)
    for i in range(min(la, n_out)):
        w = min(lb, n_out - i)
        out[i:i + w] += a[i] * b[:w]
    return out


def mont_mul_ref(spec, a, b):
    """Plain torch Montgomery product a*b*R^-1 mod p (inputs < p, output
    canonical): SOS over 16-bit limbs held in int64. t = a*b stays as
    uncarried columns (< 2^37): m = t*(-p^-1) mod R only needs t mod R up
    to congruence, and t + m*p is normalized once; then one conditional
    subtract."""
    a, b = torch.broadcast_tensors(a, b)
    nl = 2 * spec.n_words
    nd = a.dim()
    t = _mul_cols(_to16(a), _to16(b), 2 * nl)                    # < 2^37
    m, _ = _sweep16(_mul_cols(t[:nl], _col(spec.ninv16, nd, a.device),
                              nl))                               # mod R
    u, c = _sweep16(_mul_cols(m, _col(spec.mod16, nd, a.device), 2 * nl)
                    + t)
    hi = u[nl:]                       # (t + m*p) / R < 2p
    d, c2 = _sweep16(hi + _col(spec.negmod16, nd, a.device))
    take = (c2 != 0) | (c != 0)       # carry out <=> hi >= p
    return _from16(torch.where(take[None], d, hi))


def _check_words(spec, t, what, contiguous=True):
    if t.dtype != torch.int32:
        raise TypeError("%s: expected int32 words, got %s" % (what, t.dtype))
    if t.dim() < 1 or t.shape[0] != spec.n_words:
        raise ValueError("%s: expected (%d, ...) words, got %s"
                         % (what, spec.n_words, tuple(t.shape)))
    if contiguous and not t.is_contiguous():
        raise ValueError("%s: expected a contiguous tensor" % what)


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t):
    """The current CUDA stream of t's device, as an int handle."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def _lane_strides(x, batch):
    """x's strides along the broadcast batch shape (0 on broadcast axes)."""
    pad = len(batch) - (x.dim() - 1)
    shape, stride = x.shape[1:], x.stride()[1:]
    return [0 if d < pad or shape[d - pad] == 1 else stride[d - pad]
            for d in range(len(batch))]


def _lane_grid(batch, sa, sb):
    """Collapse the batch axes into at most (outer, inner) lanes: drop axes
    of size 1 and merge neighbours that both operands step through evenly.
    Returns ([outer, inner], [a's strides], [b's strides])."""
    sizes, ga, gb = [1, 1], [0, 0], [0, 0]
    for n, x, y in zip(batch, sa, sb):
        if n == 1:
            continue
        if sizes[1] == 1 or (ga[1] == x * n and gb[1] == y * n):
            sizes[1] *= n
            ga[1], gb[1] = x, y
        elif sizes[0] == 1:
            sizes, ga, gb = [sizes[1], n], [ga[1], x], [gb[1], y]
        else:
            raise ValueError("mont_mul: batch shape %s with these strides "
                             "needs more than two lane axes" % (batch,))
    return sizes, ga, gb


def lane_layout(a, b):
    """How kernel 1 reads two (L, *batch) operands: (broadcast batch shape,
    [outer, inner] lane counts, (word stride, [outer, inner] strides) of a,
    the same of b). Lane (o, i) of operand x, word k, sits at
    x[k * word + o * outer + i * inner] (in elements)."""
    if a.shape == b.shape and a.is_contiguous() and b.is_contiguous():
        lanes = a.numel() // a.shape[0]
        return (tuple(a.shape[1:]), [1, lanes], (lanes, [0, 1]),
                (lanes, [0, 1]))
    batch = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    sizes, ga, gb = _lane_grid(batch, _lane_strides(a, batch),
                               _lane_strides(b, batch))
    return batch, sizes, (a.stride(0), ga), (b.stride(0), gb)


_mont_mul_fn = None


def mont_mul_cuda(spec, a, b):
    """Kernel 1 launch on (L, *batch) int32 CUDA words whose batch shapes
    broadcast, read through their strides (no operand is copied) -> a fresh
    contiguous a*b*R^-1 mod p of the broadcast shape."""
    global _mont_mul_fn
    _check_words(spec, a, "mont_mul a", contiguous=False)
    _check_words(spec, b, "mont_mul b", contiguous=False)
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError("mont_mul: operands must lie on one CUDA device")
    batch, sizes, (wa, ga), (wb, gb) = lane_layout(a, b)
    if sizes[0] * sizes[1] >= 1 << 31:
        raise ValueError("mont_mul: too many lanes %d" % (sizes[0] * sizes[1]))
    out = torch.empty((spec.n_words,) + batch, dtype=torch.int32, device=dev)
    if _mont_mul_fn is None:
        _mont_mul_fn = _build.load()["field"].dpt_mont_mul
    args = (spec.index, out.data_ptr(), a.data_ptr(), wa, ga[0], ga[1],
            b.data_ptr(), wb, gb[0], gb[1], sizes[0], sizes[1])
    if dev.index == torch.cuda.current_device():
        rc = _mont_mul_fn(*args, _stream(a))
    else:
        with torch.cuda.device(dev):
            rc = _mont_mul_fn(*args, _stream(a))
    _build.check(rc, "mont_mul")
    _build.count("mont_mul")
    return out


def mont_mul(spec, a, b):
    """Montgomery product a*b*R^-1 mod p, inputs/outputs reduced (< p);
    batch shapes broadcast. CUDA tensors launch kernel 1 on the operands as
    they are (strided or broadcast, never copied), CPU tensors run the
    plain version."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_ref(spec, a, b)
    return mont_mul_cuda(spec, a, b)


def to_mont(spec, a):
    return mont_mul(spec, a, const(spec, spec.mont_r2, a.device, a.dim()))


def from_mont(spec, a):
    return mont_mul(spec, a, const(spec, 1, a.device, a.dim()))


def one_like(spec, a):
    """1 (Montgomery form) broadcast to a's shape."""
    return const(spec, spec.mont_r, a.device, a.dim()).expand(a.shape)


def cumprod(spec, v, reverse=False):
    """Inclusive prefix (or suffix) Montgomery products along axis 1 of an
    (L, n) tensor: the Hillis-Steele shift-multiply ladder of
    field_jax.cumprod_mont (log2 n full-width products)."""
    L, n = v.shape
    one = const(spec, spec.mont_r, v.device)
    k = 1
    while k < n:
        ones = one.expand(L, k)
        if reverse:
            shifted = torch.cat([v[:, k:], ones], dim=1)
        else:
            shifted = torch.cat([ones, v[:, :-k]], dim=1)
        v = mont_mul(spec, v, shifted)
        k *= 2
    return v


def cumsum(spec, v, reverse=False):
    """Inclusive prefix (or suffix) modular sums along axis 1 of (L, n)."""
    L, n = v.shape
    k = 1
    while k < n:
        zeros = torch.zeros((L, k), dtype=v.dtype, device=v.device)
        if reverse:
            shifted = torch.cat([v[:, k:], zeros], dim=1)
        else:
            shifted = torch.cat([zeros, v[:, :-k]], dim=1)
        v = add(spec, v, shifted)
        k *= 2
    return v


def is_zero(a):
    return (a == 0).all(dim=0)


def select(cond, a, b):
    """cond: (*batch,) bool; a, b: (L, *batch) -> where(cond, a, b)."""
    return torch.where(cond[None], a, b)
