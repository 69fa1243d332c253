"""Port curve adds and MSM (backend/curve_torch.py, backend/msm_torch.py)
vs the JAX package's curve_jax / msm_jax and the host curve.py oracle,
exactly.

- proj_add / proj_add_mixed (kernel 4's plain versions) give the same
  projective coordinates as curve_jax, edge cases included;
- the c = 7 bucket planes (kernel 3's plain version) equal
  msm_jax._bucket_scan_signed's at the same group count G;
- MsmContext results equal curve.g1_msm and msm_jax.MsmContext at the
  prover's blinded widths n + 2 and n + 3 over an identity-padded key.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributed_plonk_tpu import curve as C
from distributed_plonk_tpu.backend import curve_jax as CJ
from distributed_plonk_tpu.backend import msm_jax as MJ
from distributed_plonk_tpu.backend import prover_jax as PJ
from distributed_plonk_tpu.constants import R_MOD, FQ_MONT_R, Q_MOD
from distributed_plonk_tpu_torch.backend import curve_torch as CT
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend import msm_torch as M

# the plain versions run many small ops: one intra-op thread per test
# process beats oversubscribing the cores the other test workers share
torch.set_num_threads(1)


def _points(count, seed):
    rng = random.Random(seed)
    return [C.g1_mul(C.G1_GEN, rng.randrange(1, R_MOD))
            for _ in range(count)]


def _scalars(count, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % R_MOD
            for _ in range(count)]
    vals[:3] = [0, 1, R_MOD - 1]
    return vals


def _jax_proj(points):
    """Affine host points -> JAX (24, n) projective limbs (numpy)."""
    x, y, inf = MJ.points_to_device(points, 0)
    one = np.asarray(CJ._MONT_ONE, np.uint32)[:, None]
    y = np.where(inf[None], one, y).astype(np.uint32)   # identity (0:1:0)
    z = np.where(inf[None], np.uint32(0), one).astype(np.uint32)
    return x, y, z, inf


def _to_port(arrs):
    return tuple(TL.from_jax_limbs(a, "cpu") for a in arrs)


def _to_jax(ts):
    return tuple(TL.to_jax_limbs(t) for t in ts)


def test_proj_add_and_mixed_match_curve_jax():
    ps = _points(6, 1)
    qs = _points(6, 2)
    # edge cases: P + P, P + (-P), identity on either side
    lhs = ps + [ps[0], ps[1], None, ps[2]]
    rhs = qs + [ps[0], C.g1_neg(ps[1]), qs[0], None]
    px, py, pz, _ = _jax_proj(lhs)
    qx, qy, qz, qinf = _jax_proj(rhs)
    want = jax.jit(CJ.proj_add)((px, py, pz), (qx, qy, qz))
    got = CT.proj_add(_to_port((px, py, pz)), _to_port((qx, qy, qz)))
    assert all(np.array_equal(g, np.asarray(w))
               for g, w in zip(_to_jax(got), want))
    assert CT.proj_to_affine(got) == [C.g1_add_affine(a, b)
                                      for a, b in zip(lhs, rhs)]

    want = jax.jit(CJ.proj_add_mixed)((px, py, pz), (qx, qy),
                                      jnp.asarray(qinf))
    got = CT.proj_add_mixed(_to_port((px, py, pz)), _to_port((qx, qy)),
                            torch.from_numpy(qinf))
    assert all(np.array_equal(g, np.asarray(w))
               for g, w in zip(_to_jax(got), want))
    # affine -> projective with the identity for flagged points
    _, _, z_j = jax.jit(CJ.from_affine)(qx, qy, jnp.asarray(qinf))
    _, _, z_t = CT.from_affine(*_to_port((qx, qy)), torch.from_numpy(qinf))
    assert np.array_equal(TL.to_jax_limbs(z_t), np.asarray(z_j))


def test_bucket_planes_c7_match_msm_jax_scan():
    """Kernel 3's plain version vs msm_jax._bucket_scan_signed (the XLA
    scan the Pallas kernel is pinned to): same G, identical planes."""
    n, group = 256, 2
    points = _points(n - 3, 3) + [None] * 3
    x, y, inf = MJ.points_to_device(points, 0)
    packed = MJ.signed_digits7_of_scalars(_scalars(n - 6, 4), n)  # (37, n)
    want = jax.jit(MJ._bucket_scan_signed, static_argnums=(4, 5, 6))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf),
        jnp.asarray(packed), group, 64, "xla")
    ops = M.signed_ops(torch.from_numpy(packed.astype(np.int64)),
                       torch.from_numpy(inf), 64)
    got = M.bucket_accumulate(TL.from_jax_limbs(x, "cpu"),
                              TL.from_jax_limbs(y, "cpu"),
                              ops, group, 64)
    assert all(np.array_equal(TL.to_jax_limbs(g), np.asarray(w))
               for g, w in zip(got, want))


def test_signed_digits7_match_msm_jax():
    n = 300
    vals = _scalars(n - 5, 5)
    want = jax.jit(MJ.signed_digits7_from_mont, static_argnums=1)(
        PJ.lift(vals), n)
    got = M.signed_digits7_from_mont(TL.lift(vals, "cpu"), n)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert np.array_equal(M.digits_from_mont(TL.lift(vals, "cpu"), 4, n).numpy(),
                          MJ.digits_of_scalars(vals, n, 4).astype(np.int64))


def test_msm_context_matches_oracle_and_msm_jax_at_blinded_widths():
    """A 259-point key padded to 288 with identities (kzg.pad_commit_key's
    layout), committed at widths n + 2 = 258 and n + 3 = 259: the signed
    c = 7 path."""
    n = 256
    points = _points(n + 3, 6)
    ck = points + [None] * ((-(n + 3)) % 32)
    widths = (n + 2, n + 3)
    scalars = [_scalars(w, 10 + w) for w in widths]
    ctx = M.MsmContext(ck, "cpu")
    assert ctx.signed and ctx.c == 7
    got = ctx.msm_many(scalars)
    assert got == [C.g1_msm(points[:len(s)], s) for s in scalars]
    assert got == MJ.MsmContext(ck).msm_many(scalars)
    # the handle path: on-device digits from Montgomery coefficients
    assert ctx.msm_mont_limbs_many([TL.lift(s, "cpu") for s in scalars]) == got


def test_small_key_unsigned_path_and_device_commit_key():
    points = _points(30, 7) + [None, None]
    scalars = _scalars(30, 8)
    want = C.g1_msm(points[:30], scalars)
    ctx = M.MsmContext(points, "cpu")
    assert not ctx.signed and ctx.c == M.window_bits(32)
    assert ctx.msm(scalars) == want
    # a Jacobian device key with arbitrary Z normalizes to the same bases
    rng = random.Random(9)
    xs, ys, zs = [], [], []
    for p in points:
        if p is None:
            xs.append(0), ys.append(0), zs.append(0)
            continue
        z = rng.randrange(1, Q_MOD)
        xs.append(p[0] * z * z % Q_MOD * FQ_MONT_R % Q_MOD)
        ys.append(p[1] * pow(z, 3, Q_MOD) % Q_MOD * FQ_MONT_R % Q_MOD)
        zs.append(z * FQ_MONT_R % Q_MOD)
    key = M.DeviceCommitKey(*(TL.to_tensor(TL.ints_to_words(v, 12), "cpu")
                              for v in (xs, ys, zs)))
    assert M.MsmContext(key, "cpu").msm(scalars) == want
