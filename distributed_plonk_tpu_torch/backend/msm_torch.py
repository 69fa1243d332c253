"""Variable-base MSM on word tensors: the port of backend/msm_jax.py.

Pippenger over the commit key in one of two layouts (`MsmContext`'s
`layout`; "auto" picks by `shifted_build_bytes`):

  - shifted (the default up to SHIFTED_BUILD_MAX_BYTES): a commitment is
    sum_j s_j P_j = sum_w sum_j d_wj (2^(c*w) P_j); the key is fixed across
    proofs, so the context builds the W shifted copies of its n bases once
    (c * (W - 1) doublings on all n points, kernel 4's elementwise add,
    then one batch inversion to affine) and stores them point-major, one
    96-byte row per point. An MSM is then ONE bucket accumulation over
    W * n points with one lane per handle, and no Horner over windows is
    left;
  - base (keys whose shifted build would not fit the card, msm_jax's
    un-shifted pipeline): only the n affine bases, one lane per (handle,
    window), then the window finish (kernel 4's msm_finish: the weighted
    bucket sums and the Horner acc = 2^c acc + T_w over the windows).
    Batches and point ranges are cut so that no launch sequence passes
    ELEMS_MAX elements or LAUNCH_BYTES_MAX bytes (`launch_cut`); the
    planes of a point range's launches merge by kernel 4's proj_add.

Windows:

  - keys of >= 256 points: SIGNED c = 7 digits (37 windows, 64 buckets;
    digit d in [-64, 63], bucket |d| - 1, sign on y);
  - smaller keys: UNSIGNED c = window_bits(n) digits (256 / c windows,
    2^c buckets, digit 0 skipped).

A commit batch of B handles runs four steps, each a kernel with its plain
version beside it (CUDA tensors launch the kernel or raise; CPU tensors
run the plain version):

  1. `msm_digits` (kernel 3, csrc/msm_bucket.cu): canonical form and the
     recode of every window in one thread per (handle, point); op words
     and sort keys lane * nb + bucket (sentinel for skips).
  2. a stable torch sort of the keys and the chunk boundaries (`_plan`):
     index bookkeeping, the same for the kernel and its plain version.
  3. `bucket_sums` (kernel 3): chunks of `chunk` points per thread (a
     runtime argument: resolve_chunk, default CHUNK), then a pairwise tree
     of the chunk partials per bucket.
  4. `msm_tail` (kernel 4, csrc/curve_add.cu): sum_i weight(i) * S_i per
     handle in one launch, by segment running sums; on the base layout
     `msm_finish` (kernel 4, csrc/msm_finish.cu): the same per (handle,
     window) lane, then the Horner over the windows.

The TPU walked its points in a sequential grid with bucket planes in VMEM;
the card has no sequential grid, and one thread walking a group of points
(the port's first version) left most of the card idle. Sorting turns the
walk into independent chunks that fill the card. Every addition happens
in a fixed order, so each kernel equals its plain version coordinate for
coordinate; the bucket sums equal msm_jax's folded planes as points.

Accumulators are homogeneous projective (X : Y : Z), identity (0 : 1 : 0);
results decode on the host as x = X/Z, y = Y/Z.
"""

import copy
import threading

import torch

from ..constants import FQ_MONT_R, FQ_WORDS, Q_MOD
from . import _build
from . import curve_torch as CT
from .autotune import resolve
from . import field_torch as F
from .field_torch import FQ, FR
from .limbs import ints_to_words, lift, to_tensor

SCALAR_BITS = 256
W7 = 37                 # ceil(256 / 7)
NEG_BIT = 8             # op word: bits [0, 8) bucket, bit 8 negate y,
SKIP_BIT = 9            # bit 9 skip (msm_pallas's encoding)
CHUNK = 32              # sorted points per bucket_sums thread
TAIL_SEGMENTS = 8       # msm_tail's segments per handle (at most)
LAYOUTS = ("shifted", "base")
# bucket_sums' sorted order holds int32 element indices e = lane * P +
# point (csrc/msm_bucket.cu), so no launch sequence holds more elements
ELEMS_MAX = (1 << 31) - 1
# device bytes of one launch sequence per (lane, point) element: the op
# word and sort key (8), torch.sort's sorted keys, int64 order and its
# radix double buffers (about 24), the int32 order (4) and the chunk
# partials (144 bytes per CHUNK elements, 4.5); a 2^24-point base-layout
# MSM of one handle peaked at 41 bytes an element above its key and
# scalars on the H100 (26,312.7 MiB in all, scripts/torch_kernel_bench.py
# msm24)
LAUNCH_BYTES_PER_ELEM = 48
# the bytes one launch sequence may take: 32 GiB of the 80 GB card holds a
# 2^24-point base-layout MSM of one handle (37 x 2^24 elements) in one
# sequence beside its key (1.6 GB) and scalars; a larger batch or key is
# cut into handle batches, then point ranges (launch_cut)
LAUNCH_BYTES_MAX = 32 << 30
# the shifted key's build peak per shifted point (window x base): the W
# projective planes and their concatenation, batch_to_affine's prefix and
# suffix products and the point-major copy. Measured at 2^20 bases on the
# H100: 30,668.5 MiB over 37 x 2^20 shifted points, 829 bytes a point
# (scripts/torch_kernel_bench.py msm, msm_2p20's key_peak_mib)
SHIFTED_BUILD_BYTES_PER_POINT = 832
# the shifted layout is built while its build's peak stays within half of
# the 80 GB card, the other half left to the prove that uses the key: the
# keys of v1 (2^13), v2 (2^18) and the 2^20 circuit (32.3 GB) are shifted;
# 2^21 bases (64.5 GB) and more take the base layout
SHIFTED_BUILD_MAX_BYTES = 40 * 10**9


def resolve_chunk(chunk, n):
    """bucket_sums' chunk for an n-point key: `chunk` when given, else the
    active kernel plan's cell nearest n (backend/autotune.py), else
    CHUNK."""
    return resolve(chunk, "msm", "chunk", n, CHUNK)


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


# --- digits (plain torch) ---------------------------------------------------

def _canon_words(v, padded_n):
    """(8, ..., L) Montgomery handles -> (8, ..., padded_n) canonical int64
    words (zero coefficients pad the tail); plain multiply by 1."""
    v = F.pad_words(v, padded_n)
    return F._wide(F.mont_mul_ref(FR, v, F.const(FR, 1, v.device, v.dim())))


def _digit_rows(words, c, count):
    """(8, *b) canonical int64 words -> (count, *b) c-bit windows
    (window k = bits [c*k, c*k + c), reading across word boundaries)."""
    rows = []
    mask = (1 << c) - 1
    for k in range(count):
        bit = c * k
        i, off = bit >> 5, bit & 31
        lo = words[i] >> off
        if off + c > 32 and i + 1 < len(words):
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
    """Packed signed digits (..., n) + point-at-infinity mask (n,) -> op
    words: |d| - 1 | neg << 8 | skip << 9 (msm_pallas.bucket_scan_signed)."""
    off = packed - n_buckets
    neg = off < 0
    mag = off.abs()
    skip = (mag == 0) | inf
    idx = mag.clamp(min=1) - 1
    return (idx | (neg.to(torch.int64) << NEG_BIT)
            | (skip.to(torch.int64) << SKIP_BIT)).to(torch.int32)


def unsigned_ops(digits, inf):
    """Unsigned digits (..., n) + inf mask (n,) -> op words: the digit is
    the bucket, and digit 0 (weight 0) skips like a point at infinity."""
    skip = (digits == 0) | inf
    return (digits | (skip.to(torch.int64) << SKIP_BIT)).to(torch.int32)


def op_keys(ops, n_buckets, shifted):
    """(B, W, n) op words -> (B, W, n) int32 sort keys lane * nb + bucket,
    the sentinel lanes * nb for a skip. The lane is the handle over the
    shifted key, (handle, window) over the base key."""
    B, W, _ = ops.shape
    lanes = B if shifted else B * W
    lane = torch.arange(lanes, device=ops.device)
    lane = lane.reshape(B, 1, 1) if shifted else lane.reshape(B, W, 1)
    o = ops.to(torch.int64)
    skip = ((o >> SKIP_BIT) & 1) != 0
    return torch.where(skip, lanes * n_buckets,
                       lane * n_buckets + (o & 0xFF)).to(torch.int32)


# --- kernel 3, step 1: digit decode -----------------------------------------

def msm_digits_ref(v, inf, c, signed, shifted):
    """Plain version of msm_digits: (8, B, n) Montgomery Fr handles + (n,)
    bool inf mask -> ((B, W, n) op words, (B, W, n) sort keys)."""
    words = _canon_words(v, v.shape[-1])
    if signed:
        ops = signed_ops(signed_digits7_from_canon(words), inf, 1 << (c - 1))
    else:
        ops = unsigned_ops(digits_from_canon(words, c), inf)
    ops = ops.transpose(0, 1).contiguous()
    return ops, op_keys(ops, 1 << (c - 1) if signed else 1 << c, shifted)


def msm_digits_cuda(v, inf, c, signed, shifted):
    """Kernel 3's digit-decode launch (see msm_digits_ref)."""
    F._check_words(FR, v, "msm_digits scalars")
    if v.dim() != 3 or inf.shape != (v.shape[2],) or inf.dtype != torch.bool:
        raise ValueError("msm_digits: expected (8, B, n) scalars and an "
                         "(n,) bool mask")
    if v.device.type != "cuda" or inf.device != v.device:
        raise ValueError("msm_digits: expected one CUDA device")
    if signed and c != 7:
        raise ValueError("msm_digits: signed digits are c = 7")
    _, B, n = v.shape
    W = W7 if signed else SCALAR_BITS // c
    nb = 1 << (c - 1) if signed else 1 << c
    ops = torch.empty((B, W, n), dtype=torch.int32, device=v.device)
    keys = torch.empty_like(ops)
    flags = inf.contiguous().view(torch.uint8)   # same bytes, no kernel
    lib = _build.load()["msm"]
    with torch.cuda.device(v.device):
        rc = lib.dpt_msm_digits(ops.data_ptr(), keys.data_ptr(),
                                v.data_ptr(), flags.data_ptr(), B, n, c, W,
                                nb, int(signed), int(shifted), F._stream(v))
    _build.check(rc, "msm_digits")
    _build.count("msm_digits")
    return ops, keys


def msm_digits(v, inf, c, signed, shifted):
    if v.device.type == "cpu":
        return msm_digits_ref(v, inf, c, signed, shifted)
    return msm_digits_cuda(v.contiguous(), inf.contiguous(), c, signed,
                           shifted)


# --- kernel 3, steps 2 and 3: sort and chunked accumulation -----------------

def point_major(x, y):
    """(12, P) affine x, y -> the (P, 24) point-major key: one point's x and
    y words contiguous, 96 bytes a row (six 16-byte loads)."""
    return torch.cat([x, y]).t().contiguous()


def _plan(keys, n_lanes, n_buckets, chunk=None):
    """The stable sort of the keys and the run and chunk boundaries:
    (order (N,) int32, count_start (nbk + 1,), chunk_start (nbk + 1,))
    with nbk = n_lanes * n_buckets; bucket k's points are
    order[count_start[k]:count_start[k + 1]], in point order, cut into
    chunks of `chunk` chunk_start[k]:chunk_start[k + 1]. No host
    synchronisation. chunk: see resolve_chunk."""
    chunk = resolve_chunk(chunk, keys.numel() // n_lanes)
    sorted_keys, order = torch.sort(keys.reshape(-1), stable=True)
    nbk = n_lanes * n_buckets
    edges = torch.arange(nbk + 1, dtype=torch.int32, device=keys.device)
    count_start = torch.searchsorted(sorted_keys, edges, out_int32=True)
    chunks = (count_start[1:] - count_start[:-1] + chunk - 1) // chunk
    chunk_start = torch.cat([torch.zeros(1, dtype=torch.int32,
                                         device=keys.device),
                             torch.cumsum(chunks, 0, dtype=torch.int32)])
    return order.to(torch.int32), count_start, chunk_start


def bucket_sums_ref(key, ops, keys, n_lanes, n_buckets, chunk=None):
    """Plain version of bucket_sums. key: (P, 24) point-major affine
    Montgomery points; ops / keys: (n_lanes * P) elements, element
    e = lane * P + point. Returns ((12, n_lanes, n_buckets),)*3: bucket b
    of lane m = the sum of the points whose op in lane m selects b, added
    in the kernel's order (chunks of `chunk` sorted points from the
    identity, then the pairwise tree over each bucket's chunks). chunk:
    see resolve_chunk."""
    dev = key.device
    P = key.shape[0]
    chunk = resolve_chunk(chunk, P)
    nbk = n_lanes * n_buckets
    order, count_start, chunk_start = _plan(keys, n_lanes, n_buckets, chunk)
    cs, ks = count_start.long(), chunk_start.long()
    n_valid, n_chunks = int(cs[-1]), int(ks[-1])
    e = order[:n_valid].long()
    bucket = keys.reshape(-1).long()[e]
    rank = torch.arange(n_valid, device=dev) - cs[bucket]
    chunk_id = ks[bucket] + rank // chunk
    step = rank % chunk
    pts = key[e % P]
    px, py = pts[:, :FQ_WORDS].t(), pts[:, FQ_WORDS:].t()
    neg = ((ops.reshape(-1)[e].long() >> NEG_BIT) & 1) != 0
    py = torch.where(neg[None], F.neg(FQ, py), py)

    acc = CT.proj_inf((n_chunks,), dev)
    for t in range(chunk):
        sel = (step == t).nonzero()[:, 0]
        if sel.numel() == 0:
            break
        at = chunk_id[sel]
        cur = tuple(a[:, at] for a in acc)
        new = CT.proj_add_mixed_ref(cur, (px[:, sel], py[:, sel]))
        for a, v in zip(acc, new):
            a[:, at] = v

    counts = ks[1:] - ks[:-1]
    owner = torch.repeat_interleave(torch.arange(nbk, device=dev), counts)
    local = torch.arange(n_chunks, device=dev) - ks[owner]
    size = counts[owner]
    s = 1
    while n_chunks and s < int(counts.max()):
        at = ((local % (2 * s) == 0) & (local + s < size)).nonzero()[:, 0]
        new = CT.proj_add_ref(tuple(a[:, at] for a in acc),
                              tuple(a[:, at + s] for a in acc))
        for a, v in zip(acc, new):
            a[:, at] = v
        s *= 2

    out = CT.proj_inf((nbk,), dev)
    full = (counts > 0).nonzero()[:, 0]
    for o, a in zip(out, acc):
        o[:, full] = a[:, ks[full]]
    return tuple(o.reshape(FQ_WORDS, n_lanes, n_buckets) for o in out)


def bucket_sums_cuda(key, ops, keys, n_lanes, n_buckets, chunk=None):
    """Kernel 3's accumulation launch (see bucket_sums_ref): the sort and
    boundaries in torch, then the chunk and tree kernels."""
    if key.dtype != torch.int32 or key.dim() != 2 or key.shape[1] != 24 \
            or not key.is_contiguous():
        raise ValueError("bucket_sums: key must be contiguous (P, 24) int32")
    P = key.shape[0]
    for t in (ops, keys):
        if t.dtype != torch.int32 or t.numel() != n_lanes * P \
                or not t.is_contiguous():
            raise ValueError("bucket_sums: ops and keys must be contiguous "
                             "int32 of %d elements" % (n_lanes * P))
    if len({key.device, ops.device, keys.device}) != 1 \
            or key.device.type != "cuda":
        raise ValueError("bucket_sums: expected one CUDA device")
    if n_buckets > 256:
        raise ValueError("bucket_sums: at most 256 buckets")
    chunk = resolve_chunk(chunk, P)
    if chunk < 1:
        raise ValueError("bucket_sums: chunk must be positive")
    nbk = n_lanes * n_buckets
    order, count_start, chunk_start = _plan(keys, n_lanes, n_buckets, chunk)
    cmax = ops.numel() // chunk + nbk          # >= chunk_start[nbk]
    partials = torch.empty((cmax, 36), dtype=torch.int32, device=key.device)
    out = tuple(torch.empty((FQ_WORDS, n_lanes, n_buckets), dtype=torch.int32,
                            device=key.device) for _ in range(3))
    lib = _build.load()["msm"]
    with torch.cuda.device(key.device):
        rc = lib.dpt_bucket_sums(
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            partials.data_ptr(), key.data_ptr(), ops.data_ptr(),
            order.data_ptr(), count_start.data_ptr(), chunk_start.data_ptr(),
            P, nbk, cmax, chunk, F._stream(key))
    _build.check(rc, "bucket_sums")
    _build.count("bucket_sums")
    return out


def check_elems(n_lanes, points):
    """Raise unless n_lanes x points (lane, point) elements fit
    bucket_sums' int32 element indices (ELEMS_MAX): a launch sequence past
    it would wrap. Checks sizes only, before anything is allocated."""
    if n_lanes * points > ELEMS_MAX:
        raise ValueError("bucket_sums: %d lanes x %d points = %d elements "
                         "> %d (int32 element indices); cut the batch or "
                         "the points (launch_cut)"
                         % (n_lanes, points, n_lanes * points, ELEMS_MAX))


def bucket_sums(key, ops, keys, n_lanes, n_buckets, chunk=None):
    check_elems(n_lanes, key.shape[0])
    if key.device.type == "cpu":
        return bucket_sums_ref(key, ops, keys, n_lanes, n_buckets, chunk)
    return bucket_sums_cuda(key, ops.contiguous(), keys.contiguous(),
                            n_lanes, n_buckets, chunk)


# --- kernel 4: the MSM tail -------------------------------------------------

def tail_shape(n_buckets):
    """(segments S, columns per segment L) of msm_tail: S = min(8, nb)."""
    S = min(TAIL_SEGMENTS, n_buckets)
    return S, n_buckets // S


def msm_tail_ref(bx, by, bz, signed):
    """Plain version of msm_tail: ((12, B, nb),)*3 bucket sums -> ((12,
    B),)*3 totals sum_i weight(i) * S_i, weight i + 1 signed and i
    unsigned, in the kernel's order: segment running sums, the running sum
    over segment totals and its doublings, the pairwise tree."""
    add = CT.proj_add_ref
    B, nb = bz.shape[1:]
    S, L = tail_shape(nb)
    cols = (bx, by, bz)
    if not signed:      # column j = bucket j + 1, weight j + 1
        inf = CT.proj_inf((B, 1), bz.device)
        cols = tuple(torch.cat([c[..., 1:], i], dim=-1)
                     for c, i in zip(cols, inf))
    seg = tuple(c.reshape(FQ_WORDS, B, S, L) for c in cols)
    run = tuple(c[..., L - 1] for c in seg)
    acc = run
    for k in range(L - 2, -1, -1):
        run = add(run, tuple(c[..., k] for c in seg))
        acc = add(acc, run)
    # sum_{s >= 1} s * T_s, then times L
    lrun = tuple(r[..., S - 1] for r in run)
    lacc = lrun
    for s in range(S - 2, 0, -1):
        lrun = add(lrun, tuple(r[..., s] for r in run))
        lacc = add(lacc, lrun)
    for _ in range(L.bit_length() - 1):
        lacc = add(lacc, lacc)
    # pairwise tree over the segments' weighted sums
    acc = tuple(a.clone() for a in acc)
    h = 1
    while h < S:
        at = torch.arange(0, S - h, 2 * h, device=bz.device)
        new = add(tuple(a[..., at] for a in acc),
                  tuple(a[..., at + h] for a in acc))
        for a, v in zip(acc, new):
            a[..., at] = v
        h *= 2
    return add(tuple(a[..., 0] for a in acc), lacc)


def msm_tail_cuda(bx, by, bz, signed):
    """Kernel 4's tail launch, one block per handle (see msm_tail_ref)."""
    CT._check_point((bx, by, bz), tuple(bz.shape), bz.device, "msm_tail")
    if bz.dim() != 3 or bz.device.type != "cuda":
        raise ValueError("msm_tail: expected (12, B, nb) CUDA bucket sums")
    B, nb = bz.shape[1:]
    S, L = tail_shape(nb)
    if nb & (nb - 1) or S < 2:
        raise ValueError("msm_tail: nb must be a power of two >= 2")
    out = tuple(torch.empty((FQ_WORDS, B), dtype=torch.int32,
                            device=bz.device) for _ in range(3))
    lib = _build.load()["curve"]
    with torch.cuda.device(bz.device):
        rc = lib.dpt_msm_tail(out[0].data_ptr(), out[1].data_ptr(),
                              out[2].data_ptr(), bx.data_ptr(),
                              by.data_ptr(), bz.data_ptr(), B, nb, S, L,
                              int(signed), F._stream(bz))
    _build.check(rc, "msm_tail")
    _build.count("msm_tail")
    return out


def msm_tail(bx, by, bz, signed):
    if bz.device.type == "cpu":
        return msm_tail_ref(bx, by, bz, signed)
    return msm_tail_cuda(bx.contiguous(), by.contiguous(), bz.contiguous(),
                         signed)


# --- kernel 4: the base layout's window finish -------------------------------

def msm_finish_ref(bx, by, bz, windows, c, signed):
    """Plain version of msm_finish: ((12, B * W, nb),)*3 bucket sums, lane
    b * W + w, -> ((12, B),)*3 totals sum_w 2^(c*w) T_(b, w), where T is
    msm_tail_ref's weighted sum of each lane; in the kernel's order: acc =
    T_(b, W-1), then for w = W-2 down to 0, c doublings and acc += T_(b, w)
    (msm_jax.finish's weighting, as a Horner)."""
    lanes = bz.shape[1]
    if lanes % windows:
        raise ValueError("msm_finish: %d lanes are not handles x %d windows"
                         % (lanes, windows))
    B = lanes // windows
    t = tuple(v.reshape(FQ_WORDS, B, windows)
              for v in msm_tail_ref(bx, by, bz, signed))
    acc = tuple(v[..., windows - 1] for v in t)
    for w in range(windows - 2, -1, -1):
        for _ in range(c):
            acc = CT.proj_add_ref(acc, acc)
        acc = CT.proj_add_ref(acc, tuple(v[..., w] for v in t))
    return acc


def msm_finish_cuda(bx, by, bz, windows, c, signed):
    """Kernel 4's window-finish launch (see msm_finish_ref): the weighted
    sum of each (handle, window) lane, then one Horner warp per handle,
    each complete add spread over the lanes of a warp (csrc/
    curve_coop.cuh). One launch in the counts for the two kernels."""
    CT._check_point((bx, by, bz), tuple(bz.shape), bz.device, "msm_finish")
    if bz.dim() != 3:
        raise ValueError("msm_finish: expected (12, B * W, nb) bucket sums")
    lanes, nb = bz.shape[1:]
    S, L = tail_shape(nb)
    if nb & (nb - 1) or S < 2:
        raise ValueError("msm_finish: nb must be a power of two >= 2")
    if windows < 1 or c < 1 or lanes % windows:
        raise ValueError("msm_finish: %d lanes are not handles x %d windows"
                         % (lanes, windows))
    if bz.device.type != "cuda":
        raise ValueError("msm_finish: expected CUDA bucket sums")
    B = lanes // windows
    sums = tuple(torch.empty((FQ_WORDS, lanes), dtype=torch.int32,
                             device=bz.device) for _ in range(3))
    out = tuple(torch.empty((FQ_WORDS, B), dtype=torch.int32,
                            device=bz.device) for _ in range(3))
    lib = _build.load()["finish"]
    with torch.cuda.device(bz.device):
        rc = lib.dpt_msm_finish(
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(), sums[2].data_ptr(),
            bx.data_ptr(), by.data_ptr(), bz.data_ptr(), B, windows, c, nb,
            S, L, int(signed), F._stream(bz))
    _build.check(rc, "msm_finish")
    _build.count("msm_finish")
    return out


def msm_finish(bx, by, bz, windows, c, signed):
    if bz.device.type == "cpu":
        return msm_finish_ref(bx, by, bz, windows, c, signed)
    return msm_finish_cuda(bx.contiguous(), by.contiguous(),
                           bz.contiguous(), windows, c, signed)


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


def window_of(n):
    """(signed, c, windows, buckets) of an n-point key: signed c = 7 from
    256 points, else unsigned c = window_bits(n)."""
    if n >= 256:
        return True, 7, W7, 1 << 6
    c = window_bits(n)
    return False, c, SCALAR_BITS // c, 1 << c


def shifted_key(x, y, inf, c, windows):
    """(12, n) affine bases -> the (windows * n, 24) point-major key of
    2^(c*w) P_j at row w * n + j: c doublings (P + P, kernel 4) per window
    on all n points, one proj_dbl launch a window, then ONE homogeneous
    batch inversion to affine. Rows of points at infinity hold (0, 0);
    their ops always skip."""
    one = F.one_like(FQ, x)
    p = (x, F.select(inf, one, y), F.select(inf, torch.zeros_like(x), one))
    planes = [p]
    for _ in range(windows - 1):
        p = CT.proj_dbl(p, c)
        planes.append(p)
    stacked = tuple(torch.cat([q[i] for q in planes], dim=1)
                    for i in range(3))
    ax, ay, _ = CT.batch_to_affine(stacked, jacobian=False)
    return point_major(ax, ay)


def shifted_build_bytes(n, windows):
    """The shifted key's build peak for an n-point key of `windows`
    windows, in bytes (SHIFTED_BUILD_BYTES_PER_POINT per shifted point)."""
    return SHIFTED_BUILD_BYTES_PER_POINT * windows * n


def resolve_layout(layout, n):
    """"shifted" or "base" for an n-point key: `layout` itself, or for
    "auto" shifted while its build's peak stays within
    SHIFTED_BUILD_MAX_BYTES."""
    if layout == "auto":
        windows = window_of(n)[2]
        return "shifted" if shifted_build_bytes(n, windows) \
            <= SHIFTED_BUILD_MAX_BYTES else "base"
    if layout not in LAYOUTS:
        raise ValueError("MSM layout %r: expected auto, shifted or base"
                         % (layout,))
    return layout


def launch_cut(handles, lanes, points, point_chunk=None):
    """(handles per launch sequence, points per launch) for a commit batch
    of `handles` handles of `lanes` lanes each over a key of `points`
    points: as many handles as BATCH_CHUNK, ELEMS_MAX and LAUNCH_BYTES_MAX
    allow (at least one), over all points while one handle's lanes fit
    those limits, else over ranges of the points that do (point_chunk
    forces the range). Raises, before anything is allocated, where even
    one handle over one range would pass ELEMS_MAX."""
    cap = min(ELEMS_MAX, LAUNCH_BYTES_MAX // LAUNCH_BYTES_PER_ELEM)
    if point_chunk is None:
        point_chunk = points if lanes * points <= cap else cap // lanes
    point_chunk = min(point_chunk, points)
    if point_chunk < 1:
        raise ValueError("launch_cut: %d lanes a handle leave no point "
                         "range under %d elements" % (lanes, cap))
    check_elems(lanes, point_chunk)
    per = lanes * point_chunk
    return (max(1, min(handles, MsmContext.BATCH_CHUNK, cap // per)),
            point_chunk)


class DeviceCommitKey:
    """A commit key held on device as Jacobian (12, n) Montgomery tensors;
    identity padding columns (z == 0) are part of the key. The key carries
    its MsmContext per (device, layout), built once: every backend on that
    device (a service's key build and its pool workers) commits through the
    one key copy, which is read-only after its build."""

    def __init__(self, px, py, pz):
        assert px.shape == py.shape == pz.shape == (FQ_WORDS, px.shape[1])
        self.point = (px, py, pz)
        self._contexts = {}
        self._lock = threading.Lock()

    def __len__(self):
        return self.point[0].shape[1]

    def context(self, device, layout="auto"):
        """The MsmContext of this key on `device` in `layout` (built on
        first use, under the key's lock), at the chunk resolve_chunk gives
        now: a reloaded kernel plan gets a view at its chunk, sharing the
        one key copy."""
        layout = resolve_layout(layout, len(self))
        with self._lock:
            ctx = self._contexts.get((device, layout))
            if ctx is None:
                ctx = self._contexts[(device, layout)] = MsmContext(
                    self, device, layout=layout)
        return ctx.at_chunk(resolve_chunk(None, ctx.n))


class MsmContext:
    """Device-resident commit key in its layout, reused across commitments
    (device None: the card)."""

    # handles committed per launch sequence at most: the sort, chunks and
    # tail of a batch are shared by its handles (launch_cut may take fewer)
    BATCH_CHUNK = 32

    def __init__(self, bases, device=None, chunk=None, layout="auto",
                 point_chunk=None):
        device = F.resolve_device(device, "MsmContext")
        if isinstance(bases, DeviceCommitKey):
            ax, ay, inf = CT.batch_to_affine(bases.point)
        else:
            ax, ay, inf = points_to_device(bases, 0, device)
        self._build(ax, ay, inf, chunk=chunk, layout=layout,
                    point_chunk=point_chunk)

    @classmethod
    def from_affine(cls, ax, ay, inf, key=None, chunk=None, layout="auto",
                    point_chunk=None):
        """A context over (12, n) affine Montgomery bases already on a
        device, (n,) inf marking points at infinity, and their key when
        the caller built it: the window-shifted key (shifted_key with
        window_of(n)'s c and windows) unless layout is "base"."""
        if key is not None and layout == "auto":
            layout = "shifted"
        ctx = cls.__new__(cls)
        ctx._build(ax, ay, inf, key, chunk, layout, point_chunk)
        return ctx

    def _build(self, ax, ay, inf, key=None, chunk=None, layout="auto",
               point_chunk=None):
        self.device = ax.device
        self.n = ax.shape[1]
        self.signed, self.c, self.windows, self.n_buckets = \
            window_of(self.n)
        self.layout = resolve_layout(layout, self.n)
        # base layout: one lane per (handle, window) over the n points
        self.lanes = 1 if self.layout == "shifted" else self.windows
        self.inf = inf
        self.point_chunk = point_chunk
        # the key's rows; one handle's launches cut them only on the base
        # layout (checked before the key is built)
        rows = self.n * (self.windows if self.layout == "shifted" else 1)
        cut = launch_cut(1, self.lanes, rows, point_chunk)[1]
        if self.layout == "shifted" and cut < rows:
            raise ValueError("MsmContext: one handle over the %d-row "
                             "shifted key passes the launch limits; use "
                             "the base layout" % rows)
        if key is None:
            key = shifted_key(ax, ay, inf, self.c, self.windows) \
                if self.layout == "shifted" else point_major(ax, ay)
        self.key = key
        # bucket_sums' chunk, resolved once (resolve_chunk)
        self.chunk = resolve_chunk(chunk, self.n)
        self._views = {self.chunk: self}
        self._views_lock = threading.Lock()

    def at_chunk(self, chunk):
        """This context at another chunk: a view sharing the key (built
        once per chunk), or self at its own chunk."""
        with self._views_lock:
            view = self._views.get(chunk)
            if view is None:
                view = self._views[chunk] = copy.copy(self)
                view.chunk = chunk
            return view

    def stack(self, hs):
        """(8, L <= n) handles -> one (8, B, n) zero-padded batch."""
        for h in hs:
            assert h.shape[1] <= self.n, (tuple(h.shape), self.n)
        return torch.stack([F.pad_words(h.to(self.device), self.n)
                            for h in hs], dim=1)

    def bucket_planes(self, v):
        """(8, B, n) Montgomery Fr scalars on this context's device -> the
        bucket sums (kernel 3: msm_digits, then bucket_sums): ((12, B,
        n_buckets),)*3 on the shifted layout; ((12, B * windows,
        n_buckets),)*3, lane b * windows + w, on the base layout, where
        the planes of each point range (launch_cut) merge by kernel 4's
        proj_add in range order."""
        B = v.shape[1]
        if self.layout == "shifted":
            ops, keys = msm_digits(v, self.inf, self.c, self.signed, True)
            return bucket_sums(self.key, ops, keys, B, self.n_buckets,
                               self.chunk)
        # the batch's B * windows lanes over ranges of the points
        step = launch_cut(1, B * self.lanes, self.n, self.point_chunk)[1]
        acc = None
        for p0 in range(0, self.n, step):
            p1 = min(p0 + step, self.n)
            ops, keys = msm_digits(v[:, :, p0:p1], self.inf[p0:p1], self.c,
                                   self.signed, False)
            part = bucket_sums(self.key[p0:p1], ops, keys, B * self.lanes,
                               self.n_buckets, self.chunk)
            del ops, keys
            acc = part if acc is None else CT.proj_add(acc, part)
        return acc

    def tail(self, planes):
        """Bucket sums -> ((12, B),)*3 projective totals (kernel 4's
        msm_tail on the shifted layout, msm_finish on the base one)."""
        if self.layout == "shifted":
            return msm_tail(*planes, self.signed)
        return msm_finish(*planes, self.windows, self.c, self.signed)

    def msm_mont_limbs_many_async(self, hs):
        """Enqueue the commitments of (8, L <= n) Montgomery Fr coefficient
        handles, as many per launch sequence as launch_cut allows; returns
        force() -> affine host points, which does the transfers and the
        host decode. Nothing here waits on the device."""
        step = launch_cut(self.BATCH_CHUNK, self.lanes, self.key.shape[0],
                          self.point_chunk)[0]
        totals = [self.tail(self.bucket_planes(self.stack(hs[i:i + step])))
                  for i in range(0, len(hs), step)]

        def force():
            return [p for t in totals for p in CT.proj_to_affine(t)]
        return force

    def msm_mont_limbs_many(self, hs):
        """Commit (8, L <= n) Montgomery Fr coefficient handles -> affine
        host points."""
        return self.msm_mont_limbs_many_async(hs)()

    def msm_many(self, scalar_lists):
        """B MSMs over host int scalar lists."""
        return self.msm_mont_limbs_many([lift(s, self.device)
                                         for s in scalar_lists])

    def msm(self, scalars):
        return self.msm_many([scalars])[0]
