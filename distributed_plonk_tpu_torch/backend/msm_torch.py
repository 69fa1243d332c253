"""Variable-base MSM on word tensors: the port of backend/msm_jax.py.

Sort-free Pippenger as in the JAX package: scalars split into W windows of
c bits; the n points split into G contiguous groups, each (group, window
lane) owning private buckets that a walk over the group's points fills;
the group planes then fold bucketwise, and `finish` turns each window's
buckets into one point and the windows into the total.

  - keys of >= 256 points: SIGNED c = 7 digits (37 windows x 64 buckets,
    digit d in [-64, 63] stored as d + 64; bucket |d| - 1, sign on y);
  - smaller keys: UNSIGNED c = window_bits(n) digits (bucket 0 ignored).

Bucket accumulation is kernel 3 (csrc/msm_bucket.cu); `bucket_accumulate_ref`
is its plain version, mirroring msm_jax._bucket_scan_signed step for step.
The fold and finish tails are batches of complete projective adds —
kernel 4 (curve_torch.proj_add). Digit extraction is plain torch over the
field module (from_mont is kernel 1), as the JAX package leaves it to XLA.

Accumulators are homogeneous projective (X : Y : Z), identity (0 : 1 : 0);
results decode on the host as x = X/Z, y = Y/Z.
"""

import torch

from ..constants import FQ_MONT_R, FQ_WORDS, FR_WORDS, Q_MOD, R_MOD
from . import _build
from . import curve_torch as CT
from . import field_torch as F
from .field_torch import FQ, FR
from .limbs import ints_to_words, to_tensor

SCALAR_BITS = 256
W7 = 37                 # ceil(256 / 7)
NEG_BIT = 8             # op word: bits [0, 8) bucket, bit 8 negate y,
SKIP_BIT = 9            # bit 9 skip (msm_pallas's encoding)


def window_bits(n):
    """Unsigned window size for an n-point MSM (divides 16, so no digit
    straddles a 32-bit word either): msm_jax.window_bits."""
    if n >= 4096:
        return 8
    if n >= 64:
        return 4
    if n >= 8:
        return 2
    return 1


def group_size(n, device):
    """Number of point groups G (G | n, n / G >= 2).

    On the card each (group, lane) pair is one thread walking n / G points
    in order, so G trades thread count against the O(G * lanes * buckets)
    fold: G ~ n / 256 keeps the fold a fraction of the walk. Elsewhere
    msm_jax._group_size's rule (G <= n / 1024, capped at 512)."""
    if torch.device(device).type == "cuda":
        g = 1
        while n % (2 * g) == 0 and 2 * g * 256 <= n:
            g *= 2
        return g
    g = 512
    while g > 1 and (n % g != 0 or n // g < 2 or g * 1024 > n):
        g //= 2
    return g


# --- digits -----------------------------------------------------------------

def _canon_words(v, padded_n):
    """(8, ..., L) Montgomery handles -> (8, ..., padded_n) canonical int64
    words (zero coefficients pad the tail)."""
    v = torch.nn.functional.pad(v, (0, padded_n - v.shape[-1]))
    return F._wide(F.from_mont(FR, v))


def _digit_rows(words, c, count):
    """(8, *b) canonical int64 words -> (count, *b) c-bit windows
    (window k = bits [c*k, c*k + c), reading across word boundaries)."""
    rows = []
    mask = (1 << c) - 1
    for k in range(count):
        bit = c * k
        i, off = bit >> 5, bit & 31
        lo = words[i] >> off
        if off + c > 32 and i + 1 < FR_WORDS:
            lo = lo | (words[i + 1] << (32 - off))
        rows.append(lo & mask)
    return torch.stack(rows)


def digits_from_canon(words, c):
    """Unsigned radix-2^c digits (256/c, *b) of canonical words."""
    assert 16 % c == 0
    return _digit_rows(words, c, SCALAR_BITS // c)


def _signed_recode(u, bias):
    """Windowed unsigned digits -> packed signed digits (d + bias, d in
    [-bias, bias - 1]); returns (rows, final carry) — msm_jax's loop."""
    outs = []
    carry = torch.zeros_like(u[0])
    for w in range(u.shape[0]):
        t = u[w] + carry
        carry = (t >= bias).to(torch.int64)
        outs.append((t + bias) & (2 * bias - 1))
    return torch.stack(outs), carry


def signed_digits7_from_canon(words):
    """Canonical words -> (37, *b) packed signed base-128 digits. Scalars
    are < r < 2^255, so the top window (bits 252..258) is <= 7 and the
    recode never carries out of the 37th window."""
    return _signed_recode(_digit_rows(words, 7, W7), 64)[0]


def digits_from_mont(v, c, padded_n):
    """(8, L) Montgomery Fr handle -> (256/c, padded_n) unsigned digits."""
    return digits_from_canon(_canon_words(v, padded_n), c)


def signed_digits7_from_mont(v, padded_n):
    """(8, L) Montgomery Fr handle -> (37, padded_n) packed signed digits."""
    return signed_digits7_from_canon(_canon_words(v, padded_n))


def signed_ops(packed, inf, n_buckets):
    """Packed signed digits (M, n) + point-at-infinity mask (n,) -> op
    words: |d| - 1 | neg << 8 | skip << 9 (msm_pallas.bucket_scan_signed)."""
    off = packed - n_buckets
    neg = off < 0
    mag = off.abs()
    skip = (mag == 0) | inf[None, :]
    idx = mag.clamp(min=1) - 1
    return (idx | (neg.to(torch.int64) << NEG_BIT)
            | (skip.to(torch.int64) << SKIP_BIT)).to(torch.int32)


def unsigned_ops(digits, inf):
    """Unsigned digits (M, n) + inf mask -> op words (digit | inf << 9)."""
    return (digits | (inf[None, :].to(torch.int64) << SKIP_BIT)).to(
        torch.int32)


# --- kernel 3: bucket accumulation ------------------------------------------

def bucket_accumulate_ref(px, py, ops, group, n_buckets):
    """Plain version of kernel 3: msm_jax._bucket_scan(_signed)'s scan, step
    by step. px/py (12, n) affine Montgomery; ops (M, n) op words. Returns
    ((12, G, M, n_buckets),)*3 projective planes; bucket b of (group g,
    lane m) = the sum of g's points whose op selects b."""
    M, n = ops.shape
    steps = n // group
    planes = CT.proj_inf((group, M, n_buckets), px.device)
    sx_all = px.reshape(FQ_WORDS, group, steps)
    sy_all = py.reshape(FQ_WORDS, group, steps)
    sops = ops.to(torch.int64).reshape(M, group, steps)
    for s in range(steps):
        op = sops[:, :, s].transpose(0, 1)              # (G, M)
        idx = op & (n_buckets - 1)
        neg = ((op >> NEG_BIT) & 1) != 0
        skip = ((op >> SKIP_BIT) & 1) != 0
        gidx = idx[None, :, :, None].expand(FQ_WORDS, group, M, 1)
        cur = tuple(torch.gather(p, 3, gidx)[..., 0] for p in planes)
        sx, sy = sx_all[:, :, s], sy_all[:, :, s]       # (12, G)
        qy = torch.where(neg[None], F.neg(FQ, sy)[:, :, None],
                         sy[:, :, None])
        sxb = sx[:, :, None].expand(cur[0].shape)
        nv = CT.proj_add_mixed_ref(cur, (sxb, qy))
        nv = tuple(torch.where(skip[None], c, v) for c, v in zip(cur, nv))
        planes = tuple(p.scatter(3, gidx, v[..., None])
                       for p, v in zip(planes, nv))
    return planes


def bucket_accumulate_cuda(px, py, ops, group, n_buckets):
    """Kernel 3 launch (see bucket_accumulate_ref for the contract)."""
    for t in (px, py):
        F._check_words(FQ, t, "bucket_accumulate points")
    M, n = ops.shape
    if px.shape != (FQ_WORDS, n) or py.shape != (FQ_WORDS, n):
        raise ValueError("bucket_accumulate: points must be (12, %d)" % n)
    if ops.dtype != torch.int32 or not ops.is_contiguous():
        raise ValueError("bucket_accumulate: ops must be contiguous int32")
    if len({px.device, py.device, ops.device}) != 1 \
            or px.device.type != "cuda":
        raise ValueError("bucket_accumulate: expected one CUDA device")
    if n % group or n_buckets & (n_buckets - 1) or n_buckets > 256:
        raise ValueError("bucket_accumulate: bad group/bucket count")
    planes = tuple(torch.empty((FQ_WORDS, group, M, n_buckets),
                               dtype=torch.int32, device=px.device)
                   for _ in range(3))
    lib = _build.load()["msm"]
    with torch.cuda.device(px.device):
        rc = lib.dpt_bucket_accumulate(
            planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(),
            px.data_ptr(), py.data_ptr(), ops.data_ptr(), group, M,
            n_buckets, n, F._stream(px))
    _build.check(rc, "bucket_accumulate")
    _build.LAUNCHES["bucket_accumulate"] += 1
    return planes


def bucket_accumulate(px, py, ops, group, n_buckets):
    if px.device.type == "cpu":
        return bucket_accumulate_ref(px, py, ops, group, n_buckets)
    return bucket_accumulate_cuda(px.contiguous(), py.contiguous(),
                                  ops.contiguous(), group, n_buckets)


# --- fold and finish (kernel 4 batches) -------------------------------------

def fold_planes(bx, by, bz):
    """((12, G, *rest),)*3 projective planes -> ((12, *rest),)*3, the
    bucketwise sum over G as a pairwise tree of complete adds (the point
    equals msm_jax.fold_planes' sequential sum; only the projective
    representative may differ)."""
    planes = (bx, by, bz)
    while planes[0].shape[1] > 1:
        G = planes[0].shape[1]
        if G % 2:
            inf = CT.proj_inf((1,) + tuple(planes[0].shape[2:]),
                              planes[0].device)
            planes = tuple(torch.cat([p, i], dim=1)
                           for p, i in zip(planes, inf))
            G += 1
        h = G // 2
        planes = CT.proj_add(tuple(p[:, :h] for p in planes),
                             tuple(p[:, h:] for p in planes))
    return tuple(p[:, 0] for p in planes)


def finish(bx, by, bz, c, signed):
    """(12, ..., W, B) folded buckets -> (12, ...) totals.

    Running-sum aggregation per window (columns high weight first, one
    add of stacked (run, acc) lanes per column, then one flush), then the
    windows by Horner: total = sum_w 2^(c*w) * A_w. signed: B = 2^(c-1)
    columns, column i of weight i + 1; unsigned: column 0 dropped."""
    wins = bz.shape[-2]
    cols = range(bz.shape[-1] - 1, -1 if signed else 0, -1)
    inf = CT.proj_inf(tuple(bz.shape[1:-1]), bz.device)
    run, acc = inf, inf
    for j in list(cols) + [None]:
        col = inf if j is None else tuple(p[..., j] for p in (bx, by, bz))
        left = tuple(torch.stack([r, a], dim=1) for r, a in zip(run, acc))
        right = tuple(torch.stack([x, r], dim=1) for x, r in zip(col, run))
        out = CT.proj_add(left, right)
        run = tuple(o[:, 0] for o in out)
        acc = tuple(o[:, 1] for o in out)
    total = tuple(a[..., wins - 1] for a in acc)
    for w in range(wins - 2, -1, -1):
        for _ in range(c):
            total = CT.proj_add(total, total)
        total = CT.proj_add(total, tuple(a[..., w] for a in acc))
    return total


# --- contexts ---------------------------------------------------------------

def points_to_device(bases_affine, pad, device):
    """list[(x, y) | None] + pad -> ((12, n+pad) x, (12, n+pad) y, inf)."""
    xs, ys, infs = [], [], []
    for p in bases_affine:
        if p is None:
            xs.append(0)
            ys.append(0)
            infs.append(True)
        else:
            xs.append(p[0] * FQ_MONT_R % Q_MOD)
            ys.append(p[1] * FQ_MONT_R % Q_MOD)
            infs.append(False)
    xs += [0] * pad
    ys += [0] * pad
    infs += [True] * pad
    return (to_tensor(ints_to_words(xs, FQ_WORDS), device),
            to_tensor(ints_to_words(ys, FQ_WORDS), device),
            torch.tensor(infs, device=device))


class DeviceCommitKey:
    """A commit key held on device as Jacobian (12, n) Montgomery tensors;
    identity padding columns (z == 0) are part of the key."""

    def __init__(self, px, py, pz):
        assert px.shape == py.shape == pz.shape == (FQ_WORDS, px.shape[1])
        self.point = (px, py, pz)

    def __len__(self):
        return self.point[0].shape[1]


class MsmContext:
    """Device-resident base set, reused across commitments (device None:
    the card)."""

    # handles committed per bucket-accumulation launch: every lane of the
    # batch shares the point walk, and the card wants the threads
    BATCH_CHUNK = 32

    def __init__(self, bases, device=None):
        self.device = F.resolve_device(device, "MsmContext")
        n = len(bases)
        self.n = n
        pad = n % 2  # groups need >= 2 steps
        self.padded_n = n + pad
        self.signed = self.padded_n >= 256
        self.c = 7 if self.signed else window_bits(self.padded_n)
        self.windows = W7 if self.signed else SCALAR_BITS // self.c
        self.n_buckets = 1 << (self.c - 1) if self.signed else 1 << self.c
        self.group = group_size(self.padded_n, self.device)
        if isinstance(bases, DeviceCommitKey):
            point = bases.point
            if pad:
                point = tuple(torch.nn.functional.pad(p, (0, pad))
                              for p in point)
            self.point = CT.batch_to_affine(point)
        else:
            self.point = points_to_device(bases, pad, self.device)

    def _ops(self, words):
        """(8, B, padded_n) canonical int64 words -> (B * W, n) op words."""
        B = words.shape[1]
        if self.signed:
            digits = signed_digits7_from_canon(words)    # (W, B, n)
        else:
            digits = digits_from_canon(words, self.c)
        flat = digits.transpose(0, 1).reshape(B * self.windows,
                                              self.padded_n)
        inf = self.point[2]
        if self.signed:
            return signed_ops(flat, inf, self.n_buckets)
        return unsigned_ops(flat, inf)

    def _totals(self, words):
        """(8, B, padded_n) canonical words -> B affine host points."""
        B = words.shape[1]
        ax, ay, _ = self.point
        planes = bucket_accumulate(ax, ay, self._ops(words), self.group,
                                   self.n_buckets)
        folded = fold_planes(*planes)                    # (12, B*W, nb)
        folded = tuple(p.reshape(FQ_WORDS, B, self.windows, self.n_buckets)
                       for p in folded)
        return CT.proj_to_affine(finish(*folded, c=self.c,
                                        signed=self.signed))

    def msm_mont_limbs_many(self, hs):
        """Commit (8, L <= n) Montgomery Fr coefficient handles -> affine
        host points; digit extraction runs on device."""
        out = []
        for i in range(0, len(hs), self.BATCH_CHUNK):
            part = hs[i:i + self.BATCH_CHUNK]
            for h in part:
                assert h.shape[1] <= self.n, (tuple(h.shape), self.n)
            stacked = torch.stack([torch.nn.functional.pad(
                h.to(self.device), (0, self.padded_n - h.shape[1]))
                for h in part], dim=1)
            out.extend(self._totals(_canon_words(stacked, self.padded_n)))
        return out

    def msm_many(self, scalar_lists):
        """B MSMs over host int scalar lists."""
        out = []
        for i in range(0, len(scalar_lists), self.BATCH_CHUNK):
            words = []
            for s in scalar_lists[i:i + self.BATCH_CHUNK]:
                assert len(s) <= self.n
                s = [x % R_MOD for x in s] + [0] * (self.padded_n - len(s))
                words.append(F._wide(to_tensor(ints_to_words(s, FR_WORDS),
                                               self.device)))
            out.extend(self._totals(torch.stack(words, dim=1)))
        return out

    def msm(self, scalars):
        return self.msm_many([scalars])[0]
