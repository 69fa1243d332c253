"""The port's mesh pieces on CPU shards (parallel/): the 4-step mesh NTT
against the JAX package's MeshNttPlan and the poly oracle, the small-domain
path's counters, the range-sharded MSM against curve.g1_msm, the split of
MsmContext into bucket planes and tail (launches per commitment batch),
and the memory plan against numbers worked out by hand. Inputs come from
numpy.random.default_rng(seed); every comparison is exact.
"""

import numpy as np
import pytest
import torch

from distributed_plonk_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distributed_plonk_tpu.parallel.ntt_mesh import \
    MeshNttPlan as JaxMeshNttPlan
from distributed_plonk_tpu_torch import curve as C, kzg
from distributed_plonk_tpu_torch import poly as P
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.backend import msm_torch as M
from distributed_plonk_tpu_torch.backend import curve_torch as CT
from distributed_plonk_tpu_torch.backend.limbs import lift, lower
from distributed_plonk_tpu_torch.parallel import memory_plan
from distributed_plonk_tpu_torch.parallel.mesh import (
    Mesh, init_multihost, make_mesh, make_submesh)
from distributed_plonk_tpu_torch.parallel.mesh_backend import MeshBackend
from distributed_plonk_tpu_torch.parallel.msm_mesh import MeshMsmContext
from distributed_plonk_tpu_torch.parallel.ntt_mesh import MeshNttPlan

torch.set_num_threads(1)

MODES = [(False, False), (False, True), (True, False), (True, True)]
MODE_IDS = ["fwd", "coset", "inv", "coset_inv"]


def _fr_values(seed, count):
    """count canonical Fr ints from numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R_MOD
            for _ in range(count)]


def _oracle(n, values, inverse, coset):
    domain = P.Domain(n)
    fn = {(False, False): P.fft, (False, True): P.coset_fft,
          (True, False): P.ifft, (True, True): P.coset_ifft}
    return fn[(inverse, coset)](domain, values)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def jax_plan256():
    return JaxMeshNttPlan(jax_make_mesh(8, platform="cpu"), 256)


@pytest.mark.parametrize("inverse,coset", MODES, ids=MODE_IDS)
def test_mesh_ntt_matches_jax_mesh_and_oracle(mesh8, jax_plan256, inverse,
                                              coset):
    values = _fr_values(256 + 2 * inverse + coset, 256)
    got = MeshNttPlan(mesh8, 256).run_ints(values, inverse, coset)
    assert got == jax_plan256.run_ints(values, inverse=inverse, coset=coset)
    assert got == _oracle(256, values, inverse, coset)


@pytest.mark.parametrize("inverse,coset", MODES, ids=MODE_IDS)
def test_mesh_ntt_uneven_rc_batched(mesh8, inverse, coset):
    """n = 512: r = 16 != c = 32 (the all-to-all's tiles are not square),
    three polynomials in one batch."""
    plan = MeshNttPlan(mesh8, 512)
    vals = [_fr_values(512 + 3 * k, 512) for k in range(3)]
    h = lift([v for vs in vals for v in vs], "cpu").reshape(8, 3, 512)
    out = plan.ntt(h, inverse, coset)
    for k in range(3):
        assert lower(out[:, k].contiguous()) == \
            _oracle(512, vals[k], inverse, coset)


def test_mesh_of_one_repeated_device():
    """Four shards on one device run the 4-way sharded code; the mesh API
    (size, lead, submesh; one process: no transport, every shard held)
    and the refusals, init_multihost's argument check among them."""
    mesh = make_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.lead == torch.device("cpu")
    assert mesh.transport is None and (mesh.world, mesh.first) == (1, 0)
    assert [s for s, _ in mesh.shards()] == [0, 1, 2, 3]
    assert make_submesh(mesh.devices[:2]).size == 2
    values = _fr_values(64, 64)
    plan = MeshNttPlan(mesh, 64)
    assert plan.run_ints(values, coset=True) == \
        _oracle(64, values, False, True)
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        MeshNttPlan(mesh, 8)            # 8 = 2 x 4: 2 rows for 4 shards
    with pytest.raises(ValueError, match="process_id"):
        init_multihost("localhost:1", 2, 2, device="cpu")


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshBackend(make_mesh())


def test_small_domain_path_is_counted_replicated(mesh8):
    """n = 32 splits 4 x 8: not divisible by 8 shards, so the single-device
    NTT runs (the JAX backend's own fallback) and is counted; n = 256
    takes the mesh."""
    be = MeshBackend(mesh8)
    small = _fr_values(32, 32)
    assert be.ifft(P.Domain(32), small) == _oracle(32, small, True, False)
    big = _fr_values(2561, 256)
    assert be.coset_fft(P.Domain(256), big) == _oracle(256, big, False,
                                                       True)
    h = be.lift(big)
    assert be.ifft_h(P.Domain(256), h).shape == (8, 256)
    assert be.replicated_ntt_calls == {32: 1}
    assert be.mesh_ntt_calls == {256: 2}


def _check_msm(ctx, bases, scalars):
    assert ctx.msm(scalars) == C.g1_msm(bases, scalars)


def test_mesh_msm_matches_oracle_host_bases(mesh8):
    """test_mesh_parallel.py::test_mesh_msm_matches_oracle's shape: 64
    bases (two at infinity), scalars 0, 1 and r - 1 among them, 8 shards
    of 16 (identity-padded to 128)."""
    rng = np.random.default_rng(64)
    bases = [C.g1_mul(C.G1_GEN, int(rng.integers(1, 1 << 62)))
             for _ in range(62)] + [None, None]
    scalars = _fr_values(65, 61) + [0, 1, R_MOD - 1]
    ctx = MeshMsmContext(mesh8, bases)
    assert (ctx.padded_n, ctx.local_n) == (128, 16)
    _check_msm(ctx, bases, scalars)


@pytest.fixture(scope="module")
def device_key_msm():
    """A device-built key (Jacobian, arbitrary Z) of 64 powers, normalized
    once and split over 4 shards; its affine powers."""
    srs = kzg.universal_setup_device(63, tau=0xDEADBEEF, device="cpu")
    key = M.DeviceCommitKey(*srs.jac_powers)
    return MeshMsmContext(make_mesh(4, device="cpu"), key), \
        srs.powers_affine()


def test_mesh_msm_matches_oracle_device_key(device_key_msm):
    ctx, bases = device_key_msm
    assert (ctx.padded_n, ctx.local_n) == (64, 16)
    _check_msm(ctx, bases, _fr_values(66, 64))
    short = _fr_values(67, 40)      # fewer scalars: zero-padded on device
    assert ctx.msm(short) == C.g1_msm(bases[:40], short)


def test_commit_launches_per_batch(device_key_msm, monkeypatch):
    """MsmContext's split into bucket planes and tail keeps one msm_digits,
    one bucket_sums and one msm_tail per commitment batch (BATCH_CHUNK
    handles, cut to 2 here); the mesh runs the first two once per shard
    and folds the planes with D - 1 adds before one tail."""
    ctx, bases = device_key_msm
    calls = {"msm_digits_ref": 0, "bucket_sums_ref": 0, "msm_tail_ref": 0,
             "proj_add": 0}
    for name in calls:
        mod = CT if name == "proj_add" else M
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(M.MsmContext, "BATCH_CHUNK", 2)
    hs = [lift(_fr_values(70 + k, 16), "cpu") for k in range(3)]
    single = ctx.shards[1]                  # an MsmContext, the card's path
    got = single.msm_mont_limbs_many(hs)
    assert calls == {"msm_digits_ref": 2, "bucket_sums_ref": 2,
                     "msm_tail_ref": 2, "proj_add": 0}
    assert got[2] == C.g1_msm(bases[16:32], _fr_values(72, 16))
    for k in calls:
        calls[k] = 0
    monkeypatch.setattr(MeshMsmContext, "BATCH_CHUNK", 2)
    got = ctx.msm_mont_limbs_many(hs)
    assert calls == {"msm_digits_ref": 8, "bucket_sums_ref": 8,
                     "msm_tail_ref": 2, "proj_add": 6}
    assert got[2] == C.g1_msm(bases[:16], _fr_values(72, 16))


def test_memory_plan_v2_over_four_shards():
    """2^21 over 4 shards, worked by hand: 2^19 elements a shard of 32 B
    (16 MiB), two tables of the same size, three blocks in flight."""
    plan = memory_plan.ntt_mesh_plan(1 << 21, 4)
    assert (plan["r"], plan["c"], plan["local_elems"]) == (1024, 2048,
                                                           1 << 19)
    assert plan["data"] == 16 << 20 and plan["tables"] == 32 << 20
    assert plan["total"] == 80 << 20
    r3 = memory_plan.round3_mesh_plan(1 << 18, 1 << 21, 4)
    assert r3["planes"] == 1600 << 20           # 25 x 64 MiB on the lead
    assert r3["lead"] == (25 + 23 + 3) * (64 << 20) + 28 * (8 << 20)
    assert r3["shard"] == 3 * 25 * (16 << 20) + (32 << 20)
    # v2's commit key: 2^18 + 3 powers padded to 262,176 (a multiple of
    # 32), then to 64 | 262,208: 65,552 points a shard, c = 7, 37 windows
    msm = memory_plan.msm_mesh_plan(262176, 4, batch=5)
    assert (msm["local_points"], msm["c"], msm["windows"]) == (65552, 7, 37)
    assert msm["key"] == 37 * 65552 * 96
    assert msm["digits"] == 8 * 5 * 37 * 65552
