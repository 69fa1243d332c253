"""Port curve adds and MSM (backend/curve_torch.py, backend/msm_torch.py)
vs the JAX package's curve_jax / msm_jax and the host curve.py oracle,
exactly.

- proj_add / proj_add_mixed (kernel 4's plain versions) give the same
  projective coordinates as curve_jax, edge cases included;
- msm_digits_ref's op words and sort keys are msm_jax's digits, encoded;
- bucket_sums_ref (kernel 3's plain version) on the base layout equals
  msm_jax's folded c = 7 planes as points, and adds in chunk order;
- msm_tail_ref (kernel 4's tail) equals sum_i weight(i) * S_i on the host;
- the window-shifted key holds 2^(c*w) P_j;
- MsmContext results equal curve.g1_msm and msm_jax.MsmContext at the
  prover's blinded widths n + 2 and n + 3 over an identity-padded key.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_plonk_tpu import curve as C
from distributed_plonk_tpu.backend import curve_jax as CJ
from distributed_plonk_tpu.backend import msm_jax as MJ
from distributed_plonk_tpu.backend import prover_jax as PJ
from distributed_plonk_tpu.constants import R_MOD, FQ_MONT_R, Q_MOD
from distributed_plonk_tpu_torch.backend import curve_torch as CT
from distributed_plonk_tpu_torch.backend import field_torch as F
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


def _from_mont_q(words):
    """(12, k) Montgomery Fq words -> k canonical ints."""
    r_inv = pow(FQ_MONT_R, -1, Q_MOD)
    return [v * r_inv % Q_MOD for v in TL.words_to_ints(TL.to_numpy(words))]


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


def test_bucket_planes_c7_match_msm_jax_scan(monkeypatch):
    """Kernel 3's plain version on the base layout (37 window lanes over
    the n key points) vs msm_jax.bucket_planes_batch_signed at G = 2 (the
    XLA scan the Pallas kernel is pinned to, folded): the same bucket sums
    as points at the default chunk and at chunk 2 (a deeper tree); and
    chunk 2's coordinates against a direct evaluation in chunk order."""
    n = 256
    points = _points(n - 3, 3) + [None] * 3
    x, y, inf = MJ.points_to_device(points, 0)
    scalars = _scalars(n - 6, 4) + [0] * 6
    packed = MJ.signed_digits7_of_scalars(scalars, n)               # (37, n)
    want = jax.jit(MJ.bucket_planes_batch_signed, static_argnums=(4, 5))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(inf),
        jnp.asarray(packed[None]), 2, "xla")                  # (24, 37, 64)
    want_pts = CT.proj_to_affine(tuple(
        TL.from_jax_limbs(np.asarray(w).reshape(24, -1), "cpu")
        for w in want))
    key = M.point_major(TL.from_jax_limbs(x, "cpu"),
                        TL.from_jax_limbs(y, "cpu"))
    ops, keys = M.msm_digits_ref(TL.lift(scalars, "cpu")[:, None, :],
                                 torch.from_numpy(inf), 7, True, False)
    for chunk in (M.CHUNK, 2):
        monkeypatch.setattr(M, "CHUNK", chunk)
        got = M.bucket_sums_ref(key, ops, keys, 37, 64)
        assert CT.proj_to_affine(tuple(g.reshape(12, -1)
                                       for g in got)) == want_pts

    # direct evaluation of the fullest buckets: chunks of 2 points in point
    # order from the identity, then p[i] += p[i + s] for s = 1, 2, 4, ...
    flat_keys, flat_ops = keys.reshape(-1), ops.reshape(-1).long()
    counts = torch.bincount(flat_keys.long(), minlength=37 * 64 + 1)[:-1]
    fullest = counts.argsort(descending=True)[:3].tolist()
    assert counts[fullest[0]] >= 9          # a tree of 3 or more levels
    for b in fullest:
        members = (flat_keys == b).nonzero()[:, 0].tolist()
        parts = []
        for i in range(0, len(members), 2):
            acc = CT.proj_inf((1,), "cpu")
            for e in members[i:i + 2]:
                p = e % n
                px, py = key[p:p + 1, :12].t(), key[p:p + 1, 12:].t()
                if (flat_ops[e] >> M.NEG_BIT) & 1:
                    py = F.neg(F.FQ, py)
                acc = CT.proj_add_mixed_ref(acc, (px, py))
            parts.append(acc)
        s = 1
        while s < len(parts):
            for i in range(0, len(parts) - s, 2 * s):
                parts[i] = CT.proj_add_ref(parts[i], parts[i + s])
            s *= 2
        lane, bucket = divmod(b, 64)
        assert all(torch.equal(g[:, lane, bucket], p[:, 0])
                   for g, p in zip(got, parts[0]))


@pytest.mark.parametrize("signed", [True, False])
def test_msm_digits_ref_ops_and_keys_feed_the_sort(signed):
    """msm_digits_ref's op words are msm_jax's digits encoded as in
    msm_pallas, its keys are lane * nb + bucket (sentinel for skips) in
    both layouts, and the sort orders them stably by key."""
    n, B = 300, 2
    c, W, nb = (7, 37, 64) if signed else (4, 64, 16)
    vals = [_scalars(n - 5, 20 + b) + [0] * 5 for b in range(B)]
    inf = np.zeros(n, bool)
    inf[[3, 17, 299]] = True
    if signed:
        off = np.stack([MJ.signed_digits7_of_scalars(s, n)
                        for s in vals]).astype(np.int64) - 64
        neg, mag = off < 0, np.abs(off)
        bucket = np.maximum(mag, 1) - 1
        skip = (mag == 0) | inf
    else:
        bucket = np.stack([MJ.digits_of_scalars(s, n, c)
                           for s in vals]).astype(np.int64)
        neg = np.zeros_like(bucket, bool)
        skip = (bucket == 0) | inf
    want_ops = bucket | neg << M.NEG_BIT | skip << M.SKIP_BIT
    v = torch.stack([TL.lift(s, "cpu") for s in vals], dim=1)    # (8, B, n)
    for shifted in (True, False):
        ops, keys = M.msm_digits_ref(v, torch.from_numpy(inf), c, signed,
                                     shifted)
        assert ops.dtype == keys.dtype == torch.int32
        assert np.array_equal(ops.numpy(), want_ops)
        lanes = B if shifted else B * W
        lane = (np.arange(B).reshape(B, 1, 1) if shifted
                else np.arange(B * W).reshape(B, W, 1))
        want_keys = np.where(skip, lanes * nb, lane * nb + bucket)
        assert np.array_equal(keys.numpy(), want_keys)
        order, count_start, chunk_start = M._plan(keys, lanes, nb)
        flat = want_keys.reshape(-1)
        assert np.array_equal(order.numpy(),
                              np.argsort(flat, kind="stable"))
        assert np.array_equal(count_start.numpy(), np.searchsorted(
            np.sort(flat), np.arange(lanes * nb + 1)))
        runs = np.diff(count_start.numpy())
        assert np.array_equal(np.diff(chunk_start.numpy()),
                              -(-runs // M.CHUNK))


@pytest.mark.parametrize("signed,nb", [(True, 64), (False, 16), (False, 4),
                                       (False, 2)])
def test_msm_tail_ref_matches_host_weighted_sum(signed, nb):
    """Kernel 4's tail, plain: sum_i weight(i) * S_i per handle, weight
    i + 1 signed and i unsigned, from homogeneous bucket sums with random
    Z and some identities."""
    B = 2
    rng = random.Random(nb)
    sums = [[None if rng.random() < 0.15 else
             C.g1_mul(C.G1_GEN, rng.randrange(1, 1 << 40))
             for _ in range(nb)] for _ in range(B)]
    cols = ([], [], [])
    for row in sums:
        for p in row:
            if p is None:
                xyz = (0, 1, 0)
            else:
                z = rng.randrange(1, Q_MOD)
                xyz = (p[0] * z % Q_MOD, p[1] * z % Q_MOD, z)
            for col, v in zip(cols, xyz):
                col.append(v * FQ_MONT_R % Q_MOD)
    planes = tuple(TL.to_tensor(TL.ints_to_words(col, 12), "cpu")
                   .reshape(12, B, nb) for col in cols)
    got = CT.proj_to_affine(M.msm_tail_ref(*planes, signed=signed))
    weight = (lambda i: i + 1) if signed else (lambda i: i)
    want = [C.g1_msm(row, [weight(i) for i in range(nb)]) for row in sums]
    assert got == want


def test_signed_digits7_match_msm_jax():
    n = 300
    vals = _scalars(n - 5, 5)
    want = jax.jit(MJ.signed_digits7_from_mont, static_argnums=1)(
        PJ.lift(vals), n)
    got = M.signed_digits7_from_mont(TL.lift(vals, "cpu"), n)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert np.array_equal(M.digits_from_mont(TL.lift(vals, "cpu"), 4, n).numpy(),
                          MJ.digits_of_scalars(vals, n, 4).astype(np.int64))


@pytest.fixture(scope="module")
def signed_key():
    """A 259-point key padded to 288 with identities (kzg.pad_commit_key's
    layout) and its context: the signed c = 7 path."""
    points = _points(256 + 3, 6)
    ck = points + [None] * ((-(256 + 3)) % 32)
    return points, ck, M.MsmContext(ck, "cpu")


def test_shifted_key_holds_window_multiples(signed_key):
    """Row w * n + j of the key is 2^(7w) P_j in affine Montgomery words;
    identity padding rows hold (0, 0)."""
    points, ck, ctx = signed_key
    n = len(ck)
    assert ctx.signed and ctx.c == 7 and ctx.key.shape == (37 * n, 24)
    for w, j in ((0, 0), (1, 5), (17, 100), (36, 258), (20, 260)):
        row = ctx.key[w * n + j]
        x, y = _from_mont_q(row[:12, None])[0], _from_mont_q(row[12:, None])[0]
        want = C.g1_mul(ck[j], 1 << (7 * w)) if ck[j] is not None else None
        assert (x, y) == (want or (0, 0))


def test_msm_context_matches_oracle_and_msm_jax_at_blinded_widths(
        signed_key):
    """Commitments at widths n + 2 = 258 and n + 3 = 259 over the padded
    key."""
    points, ck, ctx = signed_key
    widths = (256 + 2, 256 + 3)
    scalars = [_scalars(w, 10 + w) for w in widths]
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
