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
