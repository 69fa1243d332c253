"""The port's sharded prover state on four CPU shards of one repeated
device (parallel/sharded.py, MeshBackend with min_local 2): every
round-math method on sharded handles against TorchBackend's on the
gathered handle, word for word (lengths that divide by 4 and lengths that
leave a tail, a degree index on a shard boundary, split pieces that
straddle shards), the mesh NTT in its four modes on sharded handles
against the JAX package's poly functions, the mesh MSM over sharded
handles against the JAX package's curve.g1_msm, the checkpoint dump
against the whole tensor's bytes, and the handle counters. Sizes are the
conftest circuit's (n = 16, m = 128); inputs come from
numpy.random.default_rng seeds; every comparison is exact.
"""

import random

import numpy as np
import pytest
import torch

from distributed_plonk_tpu import curve as JC
from distributed_plonk_tpu import poly as JP
from distributed_plonk_tpu.constants import R_MOD
from distributed_plonk_tpu_torch.backend.limbs import lift, lower
from distributed_plonk_tpu_torch.backend.torch_backend import TorchBackend
from distributed_plonk_tpu_torch.parallel import sharded as S
from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
from distributed_plonk_tpu_torch.parallel.mesh_backend import MeshBackend
from distributed_plonk_tpu_torch.poly import Domain

from test_torch_prove import _port_test_circuit

torch.set_num_threads(1)

N, M = 16, 128          # the conftest circuit's domain and quotient domain
MIN_LOCAL = 2           # lanes a shard needs: 8 lanes shard over 4
MODES = [(False, False), (False, True), (True, False), (True, True)]
MODE_IDS = ["fwd", "coset", "inv", "coset_inv"]


def _fr(seed, count):
    """count canonical Fr ints from numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD
            for _ in range(count)]


@pytest.fixture
def be():
    return MeshBackend(make_mesh(4, device="cpu"), min_local=MIN_LOCAL)


@pytest.fixture(scope="module")
def ref():
    return TorchBackend(device="cpu")


def _whole(h):
    return S.gather(h)


def _equal(got, want):
    """A handle (whole or Sharded) holds exactly want's words."""
    return tuple(got.shape) == tuple(want.shape) and \
        torch.equal(_whole(got), want)


@pytest.mark.parametrize("length", [16, 18, 19, 7, 8, 128])
def test_lift_places_by_the_rule(be, length):
    """L lanes shard when L // 4 >= min_local: blocks of L // 4 and a tail
    of L % 4 lanes; shorter handles stay whole. gather gives the lifted
    words back."""
    vals = _fr(length, length)
    h = be.lift(vals)
    block = length // 4 if length // 4 >= MIN_LOCAL else None
    if block is None:
        assert isinstance(h, torch.Tensor)
    else:
        assert isinstance(h, S.Sharded)
        assert (h.block, h.tail.shape[1]) == (block, length % 4)
        assert [tuple(p.shape) for p in h.pieces] == [(8, block)] * 4
    assert _equal(h, lift(vals, "cpu"))
    assert lower(_whole(h)) == vals


@pytest.mark.parametrize("lengths", [(16,), (16, 18, 19), (19, 7, 16),
                                     (128, 18)],
                         ids=["n", "n_n2_n3", "tail_whole_n", "m_n2"])
def test_lin_comb_matches_torch_backend(be, ref, lengths):
    polys = [_fr(100 + i, L) for i, L in enumerate(lengths)]
    coeffs = _fr(99, len(lengths))
    got = be.lin_comb_h([be.lift(p) for p in polys], coeffs)
    want = ref.lin_comb_h([ref.lift(p) for p in polys], coeffs)
    assert _equal(got, want)


@pytest.mark.parametrize("n,count", [(16, 2), (16, 3), (6, 2)],
                         ids=["wires", "z", "whole"])
def test_blind_matches_torch_backend(be, ref, n, count):
    """Only lanes [0, count) and [n, n + count) change: the blocks stay,
    the tail takes the new lanes."""
    vals, blinds = _fr(200 + n, n), _fr(201 + count, count)
    got = be.blind(be.lift(vals), blinds, n)
    assert _equal(got, ref.blind(ref.lift(vals), blinds, n))
    if n == 16:
        assert got.block == 4 and got.tail.shape[1] == count


def test_perm_product_and_wire_values_match_torch_backend(be, ref):
    """The circuit tables lifted per shard; z's shard-local prefix
    products carried across the shard boundaries."""
    ckt = _port_test_circuit()
    assert ckt.n == N
    beta, gamma = _fr(300, 2)
    got = be.perm_product(ckt, beta, gamma, N)
    assert isinstance(got, S.Sharded)
    assert _equal(got, ref.perm_product(ckt, beta, gamma, N))
    for a, b in zip(be.wire_values(ckt), ref.wire_values(ckt)):
        assert _equal(a, b)


def test_quotient_matches_torch_backend(be, ref):
    """Round 3's evaluation on sharded coset planes, each shard with its
    own lanes' domain tables and the next shard's first m / n lanes of z
    (the roll)."""
    domain = Domain(M)
    k = _fr(400, 5)
    scal = _fr(401, 4)
    planes = [_fr(410 + i, M) for i in range(13 + 5 + 5 + 2)]
    args = (N, M, domain, k, *scal)

    def run(backend):
        hs = [backend.lift(p) for p in planes]
        return backend.quotient(*args, hs[:13], hs[13:18], hs[18:23],
                                hs[23], hs[24])
    got = run(be)
    assert isinstance(got, S.Sharded) and got.block == M // 4
    assert _equal(got, run(ref))


@pytest.mark.parametrize("d", [31, 32, 33, 64, 100, 127, 3])
@pytest.mark.parametrize("lane_d", ["nonzero", "zero"])
def test_degree_is_on_and_off_shard_boundaries(be, ref, d, lane_d):
    """A handle of 128 lanes (blocks of 32) with nothing above lane d:
    lanes 31 and 32 sit on the boundary of shards 0 and 1."""
    vals = _fr(500 + d, d + 1) + [0] * (M - d - 1)
    if lane_d == "zero":
        vals[d] = 0
    h = be.lift(vals)
    for deg in (d, d - 1, d + 1, M, M + 5):
        assert be.degree_is(h, deg) == ref.degree_is(ref.lift(vals), deg)
    assert be.degree_is(h, d) == (lane_d == "nonzero")


@pytest.mark.parametrize("size,count", [(18, 5), (34, 3), (5, 4)],
                         ids=["n2_pieces", "straddling", "whole_pieces"])
def test_split_matches_torch_backend(be, ref, size, count):
    """Pieces of `size` lanes of a 128-lane handle: they straddle the
    shard boundaries at 32, 64 and 96, and each is laid out by its own
    length (5 lanes: whole)."""
    vals = _fr(600 + size, M)
    got = be.split(be.lift(vals), size, count, size * count - 1)
    want = ref.split(ref.lift(vals), size, count, size * count - 1)
    assert len(got) == len(want) == count
    for a, b in zip(got, want):
        assert _equal(a, b)
        assert isinstance(a, S.Sharded) == (size // 4 >= MIN_LOCAL)


@pytest.mark.parametrize("length", [19, 18, 16, 128, 9, 7])
def test_synth_div_matches_torch_backend(be, ref, length):
    """The suffix sums carried from each shard to the one before it; the
    quotient's length L - 1 may have other blocks than L (16 -> 15)."""
    vals = _fr(700 + length, length)
    point = _fr(701, 1)[0]
    got = be.synth_div_h(be.lift(vals), point)
    assert _equal(got, ref.synth_div_h(ref.lift(vals), point))


def test_evaluations_match_torch_backend(be, ref):
    """eval_many_h over sharded handles of several blocks and a whole one
    (each shard's partial sum times z^(s b), in shard order), eval_h and
    eval_many_async."""
    lengths = [19, 18, 16, 7, 128, 40]
    polys = [_fr(800 + L, L) for L in lengths]
    points = _fr(801, len(lengths))
    hs = [be.lift(p) for p in polys]
    want = ref.eval_many_h([(ref.lift(p), z)
                            for p, z in zip(polys, points)])
    assert be.eval_many_h(list(zip(hs, points))) == want
    assert be.eval_many_async(list(zip(hs, points))).force() == want
    assert be.eval_h(hs[0], points[0]) == want[0]


@pytest.mark.parametrize("inverse,coset", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("size,length", [(64, 64), (64, 50), (8, 8)],
                         ids=["full", "padded", "unsplit_domain"])
def test_mesh_ntt_on_sharded_handles_matches_jax_poly(be, inverse, coset,
                                                      size, length):
    """Lane blocks in, lane blocks out (the entry and exit tile
    exchanges); a 50-lane handle is relaid to the domain's blocks first;
    n = 8 splits 2 x 4, which 4 shards do not divide: the single-device
    NTT on the gathered handle."""
    vals = _fr(900 + size + length, length)
    out = be._ntt_many(Domain(size), [be.lift(vals)], inverse, coset)[0]
    fn = {(False, False): JP.fft, (False, True): JP.coset_fft,
          (True, False): JP.ifft, (True, True): JP.coset_ifft}
    assert lower(_whole(out)) == fn[inverse, coset](JP.Domain(size), vals)
    assert isinstance(out, S.Sharded)
    if size == 8:
        assert be.replicated_ntt_calls == {8: 1}
    else:
        assert be.mesh_ntt_calls == {size: 1}


def test_mesh_msm_over_sharded_handles_matches_jax_g1_msm(be):
    """A 64-point key (40 bases, 24 identities) over 4 shards: blocks of
    8 points (a 32-lane handle's) and 8 of the 32 past them; handles of
    32 to 35 lanes feed their pieces as they are, the others (16, 19, 40
    lanes, and a whole 7-lane one) are relaid to the key's blocks."""
    rng = np.random.default_rng(1000)
    bases = [JC.g1_mul(JC.G1_GEN, int(rng.integers(1, 1 << 62)))
             for _ in range(40)] + [None] * 24
    lengths = [32, 35, 16, 19, 40, 7]
    scalars = [_fr(1001 + L, L) for L in lengths]
    got = be.commit_many_h(bases, [be.lift(s) for s in scalars])
    assert got == [JC.g1_msm(bases[:len(s)], s) for s in scalars]
    assert be.mesh_msm_calls == len(lengths)


@pytest.mark.parametrize("length", [19, 16, 7])
def test_dump_load_round_trip_gives_the_whole_bytes(be, ref, length):
    vals = _fr(1100 + length, length)
    h = be.lift(vals)
    arr = be.dump_h(h)
    assert np.array_equal(arr, ref.dump_h(ref.lift(vals)))
    back = be.load_h(arr)
    assert type(back) is type(h) and _equal(back, lift(vals, "cpu"))


def test_counters_show_the_state_sharded(be):
    """sharded_handles / replicated_handles count every handle the
    backend hands out, by length."""
    h = be.lift(_fr(1200, 19))
    small = be.lift(_fr(1201, 7))
    be.blind(be.ifft_h(Domain(N), be.lift(_fr(1202, N))), [1, 2], N)
    be.split(h, 5, 4, 19)
    be.lin_comb_h([h, small], [3, 4])
    assert be.sharded_handles == {19: 2, N: 2, N + 2: 1}
    assert be.replicated_handles == {7: 1, 5: 4}
    assert be.mesh_ntt_calls == {N: 1}


def test_multi_shard_handle_survives_a_prove_of_random_blinds(be, ref):
    """blind then synth_div then degree_is on one chain, as round 1 and
    round 5 use them, equal to TorchBackend's chain."""
    rng = random.Random(1300)
    vals = [rng.randrange(R_MOD) for _ in range(N)]
    blinds = [rng.randrange(R_MOD) for _ in range(3)]
    point = rng.randrange(R_MOD)
    got = be.synth_div_h(be.blind(be.lift(vals), blinds, N), point)
    want = ref.synth_div_h(ref.blind(ref.lift(vals), blinds, N), point)
    assert _equal(got, want)
    assert be.degree_is(got, N + 1) == ref.degree_is(want, N + 1)
