"""Round 4's batched evaluation on the CPU: prover_torch.poly_eval's plain
version (poly_eval_ref, what a CPU tensor runs) and the split of kernel 8
(csrc/eval.cu), which runs only on the card. Tolerance 0 throughout:
every value is a canonical field element.

- poly_eval_many equals the JAX package's prover_jax.poly_eval_many_jit
  (jit on the CPU, as tests/test_prover_jax.py runs it) on the same seeded
  inputs, word for word: one polynomial of 1 and of 255 coefficients, and
  ten of uneven lengths padded as TorchBackend.eval_many_async pads them,
  at points that include 0 and 1.
- poly_eval_ref equals the port's host Horner, poly.poly_eval.
- split_eval, a Python mirror of the kernel's split (which coefficients
  each lane takes, the Horner in base z^32, the power warp's powers, the
  shuffle tree and the tree over a CTA's warps, each CTA's weight, and
  the in-launch combine of the CTAs' partials through the ticket),
  equals poly_eval_ref for one CTA, several, a ragged last CTA, warp and
  lane, L below the lanes, and at the kernel's own geometry for 132 SMs
  (eval_geometry) at B = 1 and B = 10.
- eval_geometry's constants are eval.cu's, and each stream of a device
  keeps one workspace lane of its own.
- poly_eval_cuda refuses CPU tensors and words that are not int32.

The kernel against the plain version on the card: tests/test_torch_cuda.py
(test_poly_eval_matches_plain).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_plonk_tpu.backend import prover_jax as PJ
from distributed_plonk_tpu_torch import poly as P
from distributed_plonk_tpu_torch.backend import field_torch as F
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend import prover_torch as PT
from distributed_plonk_tpu_torch.backend.torch_backend import TorchBackend
from distributed_plonk_tpu_torch.constants import R_MOD

torch.set_num_threads(1)


def _ints(rng, count):
    """Seeded canonical Fr ints, the corners 0, 1 and r - 1 first."""
    vals = [int.from_bytes(rng.bytes(40), "little") % R_MOD
            for _ in range(count)]
    return ([0, 1, R_MOD - 1] + vals)[:count]


def _pairs(seed, lengths, points):
    rng = np.random.default_rng(seed)
    return [(_ints(rng, L), z) for L, z in zip(lengths, points)]


def _port_operands(pairs):
    """(8, B, L) and (8, B, 1) Montgomery words on the CPU, each polynomial
    padded with zeros to the longest, as eval_many_async pads them."""
    L = max(len(cs) for cs, _ in pairs)
    polys = torch.stack([F.pad_words(TL.lift(cs, "cpu"), L)
                         for cs, _ in pairs], dim=1)
    zs = TL.lift([z for _, z in pairs], "cpu").reshape(8, len(pairs), 1)
    return polys, zs


# (seed, coefficient counts, points): B = 1 at L = 1 and 255; ten uneven
# polynomials at points 0, 1, r - 1 and seeded ones (B * L <= 3,000)
CASES = [
    (1, [1], [12345]),
    (2, [255], [0x1234567890abcdef << 128 | 99]),
    (3, [300, 299, 298, 1, 300, 17, 256, 255, 299, 300],
     [0, 1, R_MOD - 1, 5, 7 << 200, 11, 13, 2**128 + 3, 19, 23]),
]


@pytest.mark.parametrize("seed,lengths,points", CASES,
                         ids=["B1_L1", "B1_L255", "B10_uneven"])
def test_plain_equals_the_jax_poly_eval_many(seed, lengths, points):
    """TorchBackend(cpu).eval_many_h (eval_many_async: pad, stack, then
    poly_eval_many) against the JAX function on the same padded words."""
    pairs = _pairs(seed, lengths, points)
    polys, zs = _port_operands(pairs)
    jpolys = jnp.asarray(np.moveaxis(TL.to_jax_limbs(polys), 1, 0))
    jzs = jnp.asarray(np.moveaxis(TL.to_jax_limbs(zs), 1, 0))
    want = np.asarray(PJ.poly_eval_many_jit(jpolys, jzs))  # (16, B)
    be = TorchBackend(device="cpu")
    got = be.eval_many_h([(TL.lift(cs, "cpu"), z) for cs, z in pairs])
    assert got == TL.words_to_ints(TL.to_numpy(
        TL.from_jax_limbs(want, "cpu")))
    assert got == [P.poly_eval(cs, z) for cs, z in pairs]


@pytest.mark.parametrize("L,chunk", [(1, 256), (7, 256), (300, 8),
                                     (1030, 64)])
def test_plain_equals_the_host_horner(L, chunk):
    (cs, z), = _pairs(L, [L], [0x5eed << 100 | L])
    polys, zs = _port_operands([(cs, z)])
    got = PT.poly_eval_ref(polys, zs, chunk)
    assert TL.lower(got) == [P.poly_eval(cs, z)]
    # poly_eval on CPU tensors is the plain version
    assert torch.equal(PT.poly_eval(polys, zs, chunk), got)


def _power(z, e):
    """A lane of eval.cu's power warp: z^e, the exponent's bits from the
    lowest; lane 31's square z^(2^k) of step k is multiplied in at each
    set bit k, the first one taken as it is."""
    x, square, have = z, z, False
    while e:
        if e & 1:
            x = x * square % R_MOD if have else square
            have = True
        e >>= 1
        square = square * square % R_MOD
    return x


def _shuffle_tree(v, powers):
    """Shuffle levels over a warp's lanes: at stride d = 2^i, lane l adds
    lane (l + d)'s value times powers[i] (a lane past the end reads its
    own); lane 0's value."""
    for i, P in enumerate(powers):
        d = 1 << i
        v = [(v[l] + (v[l + d] if l + d < len(v) else v[l]) * P) % R_MOD
             for l in range(len(v))]
    return v[0]


def split_eval(cs, z, ctas, run, warp=32, warps=8):
    """csrc/eval.cu's arithmetic on Python ints: `ctas` CTAs of `warps`
    Horner warps of `warp` lanes (the kernel's are 32 and 8); warp w of
    CTA r owns the `warp * run` coefficients from (r * warps + w) * warp *
    run, lane l taking every warp-th of them from its own (zeros past L)
    and evaluating them by Horner in base z^warp; the shuffle tree in a
    warp with z^(2^i), then over the warps' sums in warp 0 with
    z^(warp * run * 2^i), every power as the power warp builds it; each
    CTA's partial times its weight z^(run * warp * warps * r); then, above
    one CTA, the ticket: lane q of the last CTA's warp 0 adds slots q,
    q + warp, ..., then shuffle adds."""
    L = len(cs)
    lanes = warp * warps
    assert warps <= warp and (ctas - 1) * run * lanes < L <= ctas * run * lanes
    base = _power(z, warp)
    in_warp = [_power(z, 1 << i) for i in range(warp.bit_length() - 1)]
    over_warps = [_power(z, warp * run << i)
                  for i in range(warps.bit_length() - 1)]
    partials = []
    for r in range(ctas):
        sums = []
        for w in range(warps):
            s_w = (r * warps + w) * warp * run
            steps = min(run, -(-(L - s_w) // warp)) if L > s_w else 0
            v = [0] * warp
            for j in reversed(range(steps)):
                c = [cs[p] if p < L else 0
                     for p in range(s_w + warp * j, s_w + warp * (j + 1))]
                v = [(v[l] * base + c[l]) % R_MOD if j < steps - 1 else c[l]
                     for l in range(warp)]
            sums.append(_shuffle_tree(v, in_warp))
        part = _shuffle_tree(sums + [0] * (warp - warps), over_warps)
        if r:
            part = part * _power(z, r * run * lanes) % R_MOD
        partials.append(part)
    if ctas == 1:
        return partials[0]
    s = [sum(partials[q::warp]) % R_MOD for q in range(warp)]
    d = warp // 2
    while d:
        s = [(s[l] + (s[l + d] if l + d < warp else s[l])) % R_MOD
             for l in range(warp)]
        d //= 2
    return s[0]


# (L, warp, warps, run): one CTA with L below the lanes, equal to them and
# with one coefficient a lane; several CTAs with the last one ragged, a
# last warp and lane with fewer steps than the others, 8 CTAs and 25 (more
# CTAs than a warp's lanes: the ticket adds several slots a lane)
SPLITS = [(5, 2, 2, 1), (1, 2, 2, 1), (8, 2, 2, 1), (8, 4, 2, 1),
          (13, 2, 1, 1), (13, 2, 2, 2), (37, 4, 2, 3), (100, 4, 4, 5),
          (300, 4, 2, 9), (250, 4, 2, 4), (400, 4, 2, 2), (3, 8, 4, 1),
          (30, 4, 2, 5)]


@pytest.mark.parametrize("L,warp,warps,run", SPLITS)
def test_the_kernels_split_equals_the_plain_version(L, warp, warps, run):
    ctas = -(-L // (run * warp * warps))
    (cs, _), = _pairs(L + warp, [L], [0])
    points = (0, 1, 0xabcdef << 180 | L)
    polys, zs = _port_operands([(cs, z) for z in points])
    want = TL.lower(PT.poly_eval_ref(polys, zs))
    for z, value in zip(points, want):
        assert split_eval(cs, z, ctas, run, warp, warps) == value, z


@pytest.mark.parametrize("B,L", [(1, 2049), (10, 8195)],
                         ids=["fleet_eval_B1", "v1_B10"])
def test_the_split_at_the_geometry_for_132_sms(B, L):
    """The kernel's own split (32 lanes, 8 warps) at eval_geometry(B, L,
    132): a fleet worker's EVAL and v1's round 4."""
    ctas, run = PT.eval_geometry(B, L, 132)
    pairs = _pairs(B + L, [L] * B, [0xfeed << 150 | b for b in range(B)])
    polys, zs = _port_operands(pairs)
    want = TL.lower(PT.poly_eval_ref(polys, zs))
    assert [split_eval(cs, z, ctas, run) for cs, z in pairs] == want


def test_the_kernels_geometry():
    """eval_geometry on 132 SMs: one CTA an SM while a lane's run is no
    longer than bitlength(L) (v1's ten polynomials on 11 CTAs each, 110
    SMs; a B = 1 EVAL of 2,049 on 9), else four an SM (v2 and 2^20 on 52
    CTAs each with long runs); ctas is the fewest that cover L, and the
    ticket's slots, B * ctas above one CTA, stay within 4 * 132."""
    sms, lanes = 132, PT.EVAL_THREADS
    assert [PT.eval_geometry(B, L, sms) for B, L in (
        (10, 8195), (10, 262147), (10, 1048579), (1, 2049), (10, 300),
        (1, 257), (4, 66), (2, 40000), (1, 1))] == [
        (11, 3), (52, 20), (52, 79), (9, 1), (2, 1), (2, 1), (1, 1),
        (53, 3), (1, 1)]
    assert 10 * 11 >= 100
    for B in (1, 2, 3, 10, 13, 40, 131, 400, 65535):
        for L in (1, 255, 256, 257, 2049, 8195, 40000, 262147, (1 << 31) - 1):
            ctas, run = PT.eval_geometry(B, L, sms)
            assert (ctas - 1) * run * lanes < L <= ctas * run * lanes
            assert ctas == 1 or B * ctas <= PT.EVAL_CTAS_PER_SM * sms
            width = 1 if -(-L // (max(1, sms // B) * lanes)) \
                <= L.bit_length() else PT.EVAL_CTAS_PER_SM
            assert run == -(-L // (max(1, width * sms // B) * lanes))


def test_the_geometry_constants_are_the_kernels():
    """prover_torch's EVAL_* constants equal csrc/eval.cu's: the Horner
    lanes of a CTA, the CTAs an SM (its launch bounds) and the workspace
    lanes; the ticket's slots a lane hold B * ctas on a card of up to 256
    SMs."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "distributed_plonk_tpu_torch", "csrc",
                           "eval.cu")) as f:
        defs = dict(re.findall(r"^#define DPT_EVAL_(\w+) (\d+)", f.read(),
                               re.M))
    assert 32 * int(defs["WARPS"]) == PT.EVAL_THREADS
    assert int(defs["CTAS_PER_SM"]) == PT.EVAL_CTAS_PER_SM
    assert int(defs["LANES"]) == PT.EVAL_LANES
    assert int(defs["SLOTS"]) >= PT.EVAL_CTAS_PER_SM * 256


def test_each_stream_keeps_its_own_workspace_lane(monkeypatch):
    """_eval_lane: a stream keeps the lane it was first given, another
    stream of the device takes the next, each device counts its own, and a
    device's stream past EVAL_LANES is refused."""
    monkeypatch.setattr(PT, "_eval_streams", {})
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert [PT._eval_lane(d0, 100), PT._eval_lane(d0, 200),
            PT._eval_lane(d0, 100), PT._eval_lane(d1, 100),
            PT._eval_lane(d1, 300)] == [0, 1, 0, 0, 1]
    for s in range(PT.EVAL_LANES - 2):
        PT._eval_lane(d0, 1000 + s)
    assert PT._eval_lane(d0, 1000) == 2
    with pytest.raises(RuntimeError, match="streams"):
        PT._eval_lane(d0, 5)
    assert PT._eval_lane(d1, 5) == 2


def test_poly_eval_cuda_refuses_cpu_tensors():
    polys, zs = _port_operands(_pairs(5, [3, 3], [2, 3]))
    with pytest.raises(ValueError, match="CUDA"):
        PT.poly_eval_cuda(polys, zs)
    with pytest.raises(TypeError, match="int32"):
        PT.poly_eval_cuda(polys.to(torch.int64), zs)
