"""Port field arithmetic (backend/field_torch.py) vs the JAX package's
field_jax, exactly (tolerance 0: every value is a canonical integer).

Inputs are seeded with numpy and include the corners 0, 1 and p - 1. The
JAX side runs its XLA path on the CPU (pinned bit for bit to the Pallas
kernel by tests/test_field_pallas.py) plus one interpret-mode call of the
Pallas multiplier itself; the port side runs kernel 1's plain version.
Handles cross between the two layouts with from_jax_limbs /
to_jax_limbs, a pure bit reshuffle.
"""

import os
import re

import numpy as np
import pytest
import jax
import torch

from distributed_plonk_tpu.backend import field_jax as FJ
from distributed_plonk_tpu.backend import field_pallas as FP
from distributed_plonk_tpu.backend import prover_jax as PJ
from distributed_plonk_tpu.backend.limbs import ints_to_limbs
from distributed_plonk_tpu_torch import constants as TC
from distributed_plonk_tpu_torch.backend import field_torch as F
from distributed_plonk_tpu_torch.backend import limbs as TL

# the plain versions run many small ops: one intra-op thread per test
# process beats oversubscribing the cores the other test workers share
torch.set_num_threads(1)

SPECS = {"fr": (FJ.FR, F.FR), "fq": (FJ.FQ, F.FQ)}


def _values(mod, n, seed):
    rng = np.random.default_rng(seed)
    nbytes = (mod.bit_length() + 7) // 8 + 8
    vals = [int.from_bytes(rng.bytes(nbytes), "little") % mod
            for _ in range(n - 3)]
    return [0, 1, mod - 1] + vals


def _pair(spec_j, n, seed):
    xs = _values(spec_j.mod, n, seed)
    ys = list(reversed(_values(spec_j.mod, n, seed + 1)))
    return (ints_to_limbs(xs, spec_j.n_limbs),
            ints_to_limbs(ys, spec_j.n_limbs))


def _port(fn, spec_t, *jax_arrays):
    return TL.to_jax_limbs(fn(spec_t, *[TL.from_jax_limbs(a, "cpu")
                                        for a in jax_arrays]))


@pytest.mark.parametrize("lanes", [96, 1100])    # narrow and wide batches
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul_matches_field_jax(field, lanes):
    spec_j, spec_t = SPECS[field]
    a, b = _pair(spec_j, lanes, 11)
    want = np.asarray(jax.jit(lambda x, y: FJ.mont_mul(spec_j, x, y))(a, b))
    assert np.array_equal(_port(F.mont_mul, spec_t, a, b), want)
    # broadcast of a (L, 1) constant, as the prover's scalars use it
    want = np.asarray(jax.jit(lambda x, y: FJ.mont_mul(spec_j, x, y))(
        a, b[:, :1]))
    assert np.array_equal(_port(F.mont_mul, spec_t, a, b[:, :1]), want)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_add_sub_neg_match_field_jax(field):
    spec_j, spec_t = SPECS[field]
    a, b = _pair(spec_j, 96, 23)
    fns = jax.jit(lambda x, y: (FJ.add(spec_j, x, y), FJ.sub(spec_j, x, y),
                                FJ.neg(spec_j, x)))
    add, sub, neg = (np.asarray(v) for v in fns(a, b))
    assert np.array_equal(_port(F.add, spec_t, a, b), add)
    assert np.array_equal(_port(F.sub, spec_t, a, b), sub)
    assert np.array_equal(_port(F.sub, spec_t, b, a),
                          np.asarray(jax.jit(
                              lambda x, y: FJ.sub(spec_j, x, y))(b, a)))
    assert np.array_equal(_port(F.neg, spec_t, a), neg)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_to_from_mont_and_cumprod_match_field_jax(field):
    spec_j, spec_t = SPECS[field]
    a, _ = _pair(spec_j, 64, 37)
    fns = jax.jit(lambda x: (FJ.to_mont(spec_j, x), FJ.from_mont(spec_j, x),
                             FJ.cumprod_mont(spec_j, x),
                             FJ.cumsum_mont(spec_j, x, reverse=True)))
    to_m, from_m, cp, cs = (np.asarray(v) for v in fns(a))
    assert np.array_equal(_port(F.to_mont, spec_t, a), to_m)
    assert np.array_equal(_port(F.from_mont, spec_t, a), from_m)
    assert np.array_equal(_port(F.cumprod, spec_t, a), cp)
    assert np.array_equal(
        _port(lambda s, x: F.cumsum(s, x, reverse=True), spec_t, a), cs)


def _operands(spec, shape, seed):
    count = int(np.prod(shape))
    vals = _values(spec.mod, max(count, 3), seed)[-count:]
    return TL.to_tensor(TL.ints_to_words(vals, spec.n_words),
                        "cpu").reshape((spec.n_words,) + shape)


def _layout_cases(spec):
    """(a, b) pairs as the prover hands them to mont_mul: broadcast
    scalars, strided slices of stacked tensors, two lane axes."""
    stacked = _operands(spec, (13, 64), 61)
    other = _operands(spec, (64,), 62)
    return [
        (_operands(spec, (1,), 63), _operands(spec, (330,), 64)),
        (stacked[:, 4], other),                        # x[:, i]
        (other, stacked[:, 12]),
        (stacked[:, 2:5], _operands(spec, (3, 64), 65)),
        (_operands(spec, (3, 5), 66), _operands(spec, (3, 1), 67)),
        (_operands(spec, (1, 1), 68), _operands(spec, (5, 64), 69)),
        (_operands(spec, (4, 32), 70), _operands(spec, (4, 1), 71)),
        (stacked.transpose(1, 2), _operands(spec, (64, 13), 72)),
        (_operands(spec, (1,), 73), _operands(spec, (1,), 74)),  # one lane
    ]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul_broadcast_and_strided_operands(field):
    """mont_mul on broadcast and strided operands equals its result on
    contiguous copies, and kernel 1's lane layout (two lane axes, a word
    stride and two lane strides per operand) addresses exactly the
    broadcast operands, without a copy."""
    spec = SPECS[field][1]
    for a, b in _layout_cases(spec):
        batch, sizes, (wa, ga), (wb, gb) = F.lane_layout(a, b)
        L = spec.n_words
        for x, w, g in ((a, wa, ga), (b, wb, gb)):
            view = x.as_strided((L, sizes[0], sizes[1]), (w, g[0], g[1]),
                                x.storage_offset())
            assert torch.equal(view.reshape((L,) + batch),
                               x.expand((L,) + batch))
        full = [x.expand((L,) + batch).contiguous() for x in (a, b)]
        assert torch.equal(F.mont_mul(spec, a, b),
                           F.mont_mul(spec, *full))
    # three lane axes that no two strides can express: refused, not copied
    a, b = _operands(spec, (2, 3, 4), 75), _operands(spec, (1, 3, 1), 76)
    with pytest.raises(ValueError):
        F.lane_layout(a, b)


def test_mont_mul_matches_pallas_kernel_interpret():
    """One interpret-mode call of the TPU kernel (field_pallas.mont_mul at
    512 lanes, one lane tile) against the port's multiplier."""
    spec_j, spec_t = SPECS["fr"]
    a, b = _pair(spec_j, FP.LANE_TILE, 41)
    want = np.asarray(FP.mont_mul(spec_j, a, b))
    assert np.array_equal(_port(F.mont_mul, spec_t, a, b), want)


def test_jax_layout_round_trip_and_lift_lower():
    vals = _values(TC.R_MOD, 40, 5)
    h_j = PJ.lift(vals)                                  # (16, n) numpy
    h_t = TL.lift(vals, "cpu")                           # (8, n) int32
    assert h_t.dtype == torch.int32 and tuple(h_t.shape) == (8, 40)
    assert np.array_equal(TL.to_jax_limbs(h_t), h_j)
    assert torch.equal(TL.from_jax_limbs(h_j, "cpu"), h_t)
    assert TL.lower(h_t) == vals
    fq = ints_to_limbs(_values(TC.Q_MOD, 8, 6), 24).reshape(24, 2, 4)
    assert np.array_equal(TL.to_jax_limbs(TL.from_jax_limbs(fq, "cpu")), fq)


def test_cuda_header_constants_match_constants_py():
    """csrc/field.cuh hard-codes the moduli, R mod q and -p^-1 mod 2^32;
    nvcc is not available here, so check the literals against constants.py
    (a typo would otherwise only show on the card)."""
    path = os.path.join(os.path.dirname(F.__file__), "..", "csrc",
                        "field.cuh")
    with open(path) as f:
        src = f.read()

    def words(name):
        body = re.search(r"%s\[\d+\] = \{([^}]*)\}" % name, src).group(1)
        ws = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(w << (32 * i) for i, w in enumerate(ws))

    assert words("kFrP") == TC.R_MOD
    assert words("kFqP") == TC.Q_MOD
    assert words("kFqOne") == TC.FQ_MONT_R
    n0 = dict(re.findall(r"#define DPT_(F[RQ])_N0 (0x[0-9a-f]+)u", src))
    assert int(n0["FR"], 16) == TC.FR_MONT_INV32 == F.FR.n0
    assert int(n0["FQ"], 16) == TC.FQ_MONT_INV32 == F.FQ.n0
    # the word counts the carry-chain core is instantiated with
    counts = dict(re.findall(r"struct (F[rq]) \{\s*enum \{ N = (\d+) \}",
                             src))
    assert int(counts["Fr"]) == TC.FR_WORDS == F.FR.n_words
    assert int(counts["Fq"]) == TC.FQ_WORDS == F.FQ.n_words


# --- word-level model of csrc/field.cuh's carry-chain core -------------------

_M32 = 0xFFFFFFFF


class _Flag:
    """One thread's carry flag and the PTX instructions field.cuh uses, bit
    for bit. A form without .cc (addc, madc.hi) has no carry out: the model
    asserts that it never needed one. `dropped()` marks where the CUDA code
    lets a chain's carry out be overwritten: the model asserts it is 0."""

    def __init__(self):
        self.cf = 0

    def _set(self, s):
        self.cf = s >> 32
        return s & _M32

    def add_cc(self, a, b):
        return self._set(a + b)

    def addc_cc(self, a, b):
        return self._set(a + b + self.cf)

    def addc(self, a, b):
        s = a + b + self.cf
        assert s <= _M32, "addc.u32 lost a carry"
        return s

    def sub_cc(self, a, b):
        d = a - b
        self.cf = int(d < 0)
        return d & _M32

    def subc_cc(self, a, b):
        d = a - b - self.cf
        self.cf = int(d < 0)
        return d & _M32

    def subc(self, a, b):
        return (a - b - self.cf) & _M32

    def mad_lo_cc(self, a, b, c):
        return self._set((a * b & _M32) + c)

    def madc_lo_cc(self, a, b, c):
        return self._set((a * b & _M32) + c + self.cf)

    def madc_hi_cc(self, a, b, c):
        return self._set((a * b >> 32) + c + self.cf)

    def madc_hi(self, a, b, c):
        s = (a * b >> 32) + c + self.cf
        assert s <= _M32, "madc.hi.u32 lost a carry"
        return s

    def dropped(self):
        assert self.cf == 0, "a dropped carry out was 1"


def _mul_row(acc, a, b):
    for j in range(0, len(acc), 2):
        acc[j], acc[j + 1] = a[j] * b & _M32, a[j] * b >> 32


def _mad_row(f, acc, a, b):
    acc[0] = f.mad_lo_cc(a[0], b, acc[0])
    acc[1] = f.madc_hi_cc(a[0], b, acc[1])
    for j in range(2, len(acc), 2):
        acc[j] = f.madc_lo_cc(a[j], b, acc[j])
        acc[j + 1] = f.madc_hi_cc(a[j], b, acc[j + 1])


def _mad_row_shift(f, acc, a, b):
    n = len(acc)
    for j in range(0, n - 2, 2):
        acc[j] = f.madc_lo_cc(a[j], b, acc[j + 2])
        acc[j + 1] = f.madc_hi_cc(a[j], b, acc[j + 3])
    acc[n - 2] = f.madc_lo_cc(a[n - 2], b, 0)
    acc[n - 1] = f.madc_hi(a[n - 2], b, 0)


def _cios_row(f, spec, lo, hi, a, bi, first):
    n = spec.n_words
    if first:
        _mul_row(hi, a[1:], bi)
        _mul_row(lo, a, bi)
    else:
        lo[0] = f.add_cc(lo[0], hi[1])
        _mad_row_shift(f, hi, a[1:], bi)
        _mad_row(f, lo, a, bi)
        hi[n - 1] = f.addc(hi[n - 1], 0)
    m = lo[0] * spec.n0 & _M32
    _mad_row(f, hi, spec.mod_words[1:], m)
    f.dropped()
    _mad_row(f, lo, spec.mod_words, m)
    hi[n - 1] = f.addc(hi[n - 1], 0)
    assert lo[0] == 0


def _reduce_once(f, spec, t):
    d = [f.sub_cc(t[0], spec.mod_words[0])]
    d += [f.subc_cc(t[j], spec.mod_words[j])
          for j in range(1, spec.n_words)]
    return list(t) if f.subc(0, 0) else d


def _words(spec, x):
    return [(x >> (32 * j)) & _M32 for j in range(spec.n_words)]


def _value(ws):
    return sum(w << (32 * j) for j, w in enumerate(ws))


def model_mont_mul(spec, x, y):
    """fe_mont_mul of csrc/field.cuh on ints, instruction for instruction."""
    n, f = spec.n_words, _Flag()
    a, b = _words(spec, x), _words(spec, y)
    even, odd = [0] * n, [0] * n
    for i in range(0, n, 2):
        _cios_row(f, spec, even, odd, a, b[i], i == 0)
        _cios_row(f, spec, odd, even, a, b[i + 1], False)
    even[0] = f.add_cc(even[0], odd[1])
    for j in range(1, n - 1):
        even[j] = f.addc_cc(even[j], odd[j + 1])
    even[n - 1] = f.addc(even[n - 1], 0)
    assert _value(even) < 2 * spec.mod
    return _value(_reduce_once(f, spec, even))


def model_add(spec, x, y):
    n, f = spec.n_words, _Flag()
    a, b = _words(spec, x), _words(spec, y)
    s = [f.add_cc(a[0], b[0])]
    s += [f.addc_cc(a[j], b[j]) for j in range(1, n - 1)]
    s.append(f.addc(a[n - 1], b[n - 1]))
    return _value(_reduce_once(f, spec, s))


def model_sub(spec, x, y):
    n, f = spec.n_words, _Flag()
    a, b = _words(spec, x), _words(spec, y)
    d = [f.sub_cc(a[0], b[0])]
    d += [f.subc_cc(a[j], b[j]) for j in range(1, n)]
    mask = f.subc(0, 0)
    p = [w & mask for w in spec.mod_words]
    d[0] = f.add_cc(d[0], p[0])
    for j in range(1, n - 1):
        d[j] = f.addc_cc(d[j], p[j])
    d[n - 1] = (d[n - 1] + p[n - 1] + f.cf) & _M32   # the wrap back
    return _value(d)


def _model_inputs(spec, seed):
    p, bits = spec.mod, spec.mod.bit_length()
    top = [p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, 1 << (bits - 1),
           (1 << (bits - 1)) + 1, (1 << (bits - 1)) - 1]
    words = [(1 << 32) - 1, 1 << 32, (1 << (32 * (spec.n_words - 1))) - 1]
    return [0, 1, 2] + top + words + _values(p, 40, seed)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_carry_chain_model_matches_montgomery_product(field):
    """The carry-chain core (modelled word by word, every carry and every
    dropped word asserted) gives a * b * R^-1 mod p, canonical, and its add
    and sub give a + b and a - b mod p, on 0, 1, p - 1, values near the top
    of the range and seeded random values."""
    spec = SPECS[field][1]
    r_inv = pow(1 << (32 * spec.n_words), -1, spec.mod)
    xs = _model_inputs(spec, 51)
    ys = list(reversed(_model_inputs(spec, 52)))
    for x in xs:
        for y in (ys if x in xs[:10] else ys[:6]):
            assert model_mont_mul(spec, x, y) == x * y * r_inv % spec.mod
            assert model_add(spec, x, y) == (x + y) % spec.mod
            assert model_sub(spec, x, y) == (x - y) % spec.mod


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_carry_chain_no_final_carry_condition(field):
    """The moduli leave the spare bits the core relies on: the top word is
    under (2^32 - 1) / 2 - 1, so 2p < 2^(32N) and the running sum of a row
    stays under 2^(32N + 32)."""
    spec = SPECS[field][1]
    assert spec.mod_words[-1] < (_M32 >> 1) - 1
    assert 2 * spec.mod < 1 << (32 * spec.n_words)
    # the largest sum a row can reach: 2p + (2^32 - 1)(p - 1) + (2^32 - 1)p
    assert 2 * spec.mod + _M32 * (2 * spec.mod - 1) < 1 << (32 * spec.n_words
                                                            + 32)
