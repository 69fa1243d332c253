"""BLS12-381 G1 arithmetic on word tensors: the port of backend/curve_jax.py.

Points are tuples of (12, *batch) int32 Montgomery Fq word tensors.
Homogeneous projective (X : Y : Z) with identity (0 : 1 : 0) for the
complete RCB15 adds of the MSM; Jacobian (x = X/Z^2, y = Y/Z^3) only where
a device-built key arrives (`batch_to_affine` normalizes either).

`proj_add` / `proj_add_mixed` are kernel 4 (csrc/curve_add.cu): on CUDA
tensors they launch the kernel, on CPU tensors they run
`proj_add_ref` / `proj_add_mixed_ref`, the plain versions, which stage
their independent products as stacked-lane multiplies like curve_jax.
"""

import torch

from ..constants import FQ_MONT_R, FQ_WORDS, Q_MOD
from . import _build
from . import field_torch as F
from .field_torch import FQ
from .limbs import ints_to_words, to_tensor, to_numpy, words_to_ints

_MONT_R_INV = pow(FQ_MONT_R, Q_MOD - 2, Q_MOD)


def proj_inf(batch_shape, device):
    """Identity in homogeneous projective coordinates: (0 : 1 : 0)."""
    shape = (FQ_WORDS,) + tuple(batch_shape)
    zero = torch.zeros(shape, dtype=torch.int32, device=device)
    # clone, not contiguous(): the callers write into these in place, and
    # functionalization (torch.func, the static verifier's trace) takes
    # contiguous() of an expanded tensor for the expand view itself
    one = F.const(FQ, FQ_MONT_R, device, len(shape)).expand(shape)
    return (zero, one.clone(), zero.clone())


def from_affine(x, y, inf_mask):
    """(12, *b) affine Montgomery coords + bool mask -> projective."""
    one = F.one_like(FQ, x)
    z = torch.where(inf_mask[None], torch.zeros_like(x), one)
    return (x, y, z)


def _lanes(op, pairs):
    """k independent Fq ops as ONE call on a stacked lane axis."""
    a = torch.stack([x for x, _ in pairs], dim=1)
    b = torch.stack([y for _, y in pairs], dim=1)
    r = op(FQ, a, b)
    return [r[:, i] for i in range(len(pairs))]


def _rcb15_tail(t0, t1, m, u, t2):
    """Shared tail of the plain adds: t3, t4, ym = m - u lanewise; the b3
    terms 12*t2 and 12*ym (= 8a + 4a); the second product stage. Field ops
    of one dependency level run as one stacked call."""
    t3, t4, ym = _lanes(F.sub, list(zip(m, u)))
    t0_2, t2_2, ym_2 = _lanes(F.add, [(t0, t0), (t2, t2), (ym, ym)])
    t0x3, t2_4, ym_4 = _lanes(F.add, [(t0_2, t0), (t2_2, t2_2),
                                      (ym_2, ym_2)])
    t2_8, ym_8 = _lanes(F.add, [(t2_4, t2_4), (ym_4, ym_4)])
    t2b, y3b = _lanes(F.add, [(t2_8, t2_4), (ym_8, ym_4)])   # 12*t2, 12*ym
    z3a = F.add(FQ, t1, t2b)
    t1a = F.sub(FQ, t1, t2b)
    x3a, t2c, y3c, t1b, t0c, z3b = _lanes(F.mont_mul_ref, [
        (t4, y3b), (t3, t1a), (y3b, t0x3),
        (t1a, z3a), (t0x3, t3), (z3a, t4)])
    y3, z3 = _lanes(F.add, [(t1b, y3c), (z3b, t0c)])
    return (F.sub(FQ, t2c, x3a), y3, z3)


def proj_add_ref(p, q):
    """Plain complete projective P + Q (RCB15 algorithm 7, a = 0, b3 = 12):
    curve_jax.proj_add's formula, value for value."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    s1 = _lanes(F.add, [(x1, y1), (y1, z1), (x1, z1),
                        (x2, y2), (y2, z2), (x2, z2)])
    t0, t1, t2, m3, m4, m5 = _lanes(F.mont_mul_ref, [
        (x1, x2), (y1, y2), (z1, z2),
        (s1[0], s1[3]), (s1[1], s1[4]), (s1[2], s1[5])])
    u = _lanes(F.add, [(t0, t1), (t1, t2), (t0, t2)])
    return _rcb15_tail(t0, t1, (m3, m4, m5), u, t2)


def proj_add_mixed_ref(p, q_affine):
    """Plain complete projective P + affine Q (RCB15 algorithm 8): the
    formula of curve_jax.proj_add_mixed without its q_inf select."""
    x1, y1, z1 = p
    x2, y2 = q_affine
    s1 = _lanes(F.add, [(x1, y1), (x2, y2)])
    t0, t1, m3, t4a, y3a = _lanes(F.mont_mul_ref, [
        (x1, x2), (y1, y2), (s1[0], s1[1]), (y2, z1), (x2, z1)])
    # t4 = y2*z1 + y1 and ym = x2*z1 + x1 enter the shared tail as
    # "m - u" with u = 0
    t01, t4, ym = _lanes(F.add, [(t0, t1), (t4a, y1), (y3a, x1)])
    zero = torch.zeros_like(t0)
    return _rcb15_tail(t0, t1, (m3, t4, ym), (t01, zero, zero), z1)


def _check_point(coords, shape, device, what):
    for c in coords:
        F._check_words(FQ, c, what)
        if c.device != device or tuple(c.shape) != shape:
            raise ValueError("%s: coordinates must share device and shape"
                             % what)


def _add_cuda(p, q):
    """Kernel 4 launch: q of 3 coords -> full add, of 2 -> mixed add."""
    x1 = p[0]
    if x1.device.type != "cuda":
        raise ValueError("proj_add: expected CUDA tensors")
    _check_point(tuple(p) + tuple(q), tuple(x1.shape), x1.device,
                 "proj_add")
    out = tuple(torch.empty_like(x1) for _ in range(3))
    z2 = q[2].data_ptr() if len(q) == 3 else None
    lib = _build.load()["curve"]
    with torch.cuda.device(x1.device):
        rc = lib.dpt_proj_add(
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            p[0].data_ptr(), p[1].data_ptr(), p[2].data_ptr(),
            q[0].data_ptr(), q[1].data_ptr(), z2,
            x1.numel() // FQ_WORDS, F._stream(x1))
    _build.check(rc, "proj_add")
    _build.count("proj_add" if z2 is not None else "proj_add_mixed")
    return out


def _same_shape(coords):
    coords = torch.broadcast_tensors(*coords)
    return tuple(c.contiguous() for c in coords)


def proj_add(p, q):
    """Complete projective P + Q; batch shapes broadcast."""
    coords = _same_shape(tuple(p) + tuple(q))
    if coords[0].device.type == "cpu":
        return proj_add_ref(coords[:3], coords[3:])
    return _add_cuda(coords[:3], coords[3:])


def proj_add_mixed(p, q_affine, q_inf=None):
    """Complete projective P + affine Q; where q_inf is set, P."""
    coords = _same_shape(tuple(p) + tuple(q_affine))
    if coords[0].device.type == "cpu":
        res = proj_add_mixed_ref(coords[:3], coords[3:])
    else:
        res = _add_cuda(coords[:3], coords[3:])
    if q_inf is None:
        return res
    return tuple(F.select(q_inf, a, b) for a, b in zip(coords[:3], res))


def batch_to_affine(p, jacobian=True):
    """(12, n) Montgomery points -> (x, y, inf_mask) affine, on device:
    Jacobian (x = X/Z^2, y = Y/Z^3) by default, homogeneous projective
    (x = X/Z, y = Y/Z) with jacobian=False. One Montgomery batch inversion
    of the Z column (prefix/suffix product ladders and ONE host inverse),
    as curve_jax.batch_to_affine."""
    px, py, pz = p
    inf = F.is_zero(pz)
    z = F.select(inf, F.one_like(FQ, pz), pz)
    pre = F.cumprod(FQ, z)
    suf = F.cumprod(FQ, z, reverse=True)
    total = words_to_ints(to_numpy(pre[:, -1:]))[0]    # T*R, one element
    # (T*R)^-1 * R^2 = T^-1 * R: the Montgomery form of T^-1
    inv = FQ_MONT_R * FQ_MONT_R % Q_MOD * pow(total, Q_MOD - 2, Q_MOD) \
        % Q_MOD
    tinv = to_tensor(ints_to_words([inv], FQ_WORDS), pz.device)
    one = F.one_like(FQ, pz[:, :1])
    pre_im1 = torch.cat([one, pre[:, :-1]], dim=1)
    suf_ip1 = torch.cat([suf[:, 1:], one], dim=1)
    zx = zy = F.mont_mul(FQ, F.mont_mul(FQ, pre_im1, suf_ip1), tinv)
    if jacobian:
        zx = F.mont_mul(FQ, zy, zy)
        zy = F.mont_mul(FQ, zx, zy)
    ax = F.mont_mul(FQ, px, zx)
    ay = F.mont_mul(FQ, py, zy)
    zero = torch.zeros_like(ax)
    return F.select(inf, zero, ax), F.select(inf, zero, ay), inf


def affine_to_host(ax, ay, inf):
    """batch_to_affine's output -> list[(x, y) | None] of canonical host
    ints (one transfer per coordinate)."""
    xs, ys = (words_to_ints(to_numpy(c)) for c in (ax, ay))
    flags = inf.to("cpu").tolist()
    return [None if f else (x * _MONT_R_INV % Q_MOD, y * _MONT_R_INV % Q_MOD)
            for x, y, f in zip(xs, ys, flags)]


def proj_to_affine(p):
    """Projective (12, n) Montgomery tensors -> list[(x, y) | None] (host
    decode x = X/Z, y = Y/Z: one host inverse per point)."""
    cols = [words_to_ints(to_numpy(c)) for c in p]
    out = []
    for X, Y, Z in zip(*cols):
        z = Z * _MONT_R_INV % Q_MOD
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, Q_MOD - 2, Q_MOD)
        out.append((X * _MONT_R_INV % Q_MOD * zi % Q_MOD,
                    Y * _MONT_R_INV % Q_MOD * zi % Q_MOD))
    return out
