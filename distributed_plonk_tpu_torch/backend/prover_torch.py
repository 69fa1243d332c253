"""The prover's per-round vector math on Fr word tensors: the port of
backend/prover_jax.py.

Plain torch on top of the field module (every product is a
`field_torch.mont_mul`, i.e. kernel 1 on the card): the JAX package
computes all of this in XLA, outside any Pallas kernel. Round 3's three
folds (`gate_fold`, `sigma_fold`, `quotient_combine`) are one hand-written
kernel each on the card (csrc/round3.cu), their plain versions beside
them. Handles are (8, n) Montgomery words; scalars broadcast as (8, 1).
Sequential recurrences keep prover_jax's log-depth shapes (Hillis-Steele
product and sum ladders), except that the one field inversion of a batch
inverse runs on the host (a single element crosses, as in
curve_jax.batch_to_affine).
"""

import ctypes

import torch

from ..constants import R_MOD, FR_MONT_R, FR_WORDS, WORD_MASK
from . import _build
from . import field_torch as F
from .field_torch import FR
from .limbs import lift, lift_scalar, to_numpy, words_to_ints

_R_INV = pow(FR_MONT_R, -1, R_MOD)


def _mm(a, b):
    return F.mont_mul(FR, a, b)


def _add(a, b):
    return F.add(FR, a, b)


def _sub(a, b):
    return F.sub(FR, a, b)


def _one_like(v):
    return F.one_like(FR, v)


def cumprod(v, reverse=False):
    """Inclusive prefix (or suffix) products along axis 1 of (8, n)."""
    return F.cumprod(FR, v, reverse=reverse)


def fr_pow(base, exp):
    """base^exp for a public int exponent, square-and-multiply MSB first."""
    acc = _one_like(base)
    for bit in bin(exp)[2:]:
        acc = _mm(acc, acc)
        if bit == "1":
            acc = _mm(acc, base)
    return acc


def inverse_scalar(x):
    """(8, 1) nonzero Montgomery element -> its inverse (host pow)."""
    v = words_to_ints(to_numpy(x.reshape(FR_WORDS, 1)))[0] * _R_INV % R_MOD
    return lift_scalar(pow(v, R_MOD - 2, R_MOD), x.device)


def batch_inverse(v):
    """Elementwise inverse of (8, n) nonzero Montgomery values: Montgomery's
    trick, v_j^-1 = P_{j-1} * S_{j+1} * P_n^-1 with prefix/suffix product
    ladders and one field inversion."""
    pre = cumprod(v)
    suf = cumprod(v, reverse=True)
    total_inv = inverse_scalar(pre[:, -1:])
    one = _one_like(v[:, :1])
    p_shift = torch.cat([one, pre[:, :-1]], dim=1)
    s_shift = torch.cat([suf[:, 1:], one], dim=1)
    return _mm(_mm(p_shift, s_shift), total_inv)


# --- round 2: permutation running product -----------------------------------

def perm_product(wires, id_tab, sig_tab, beta, gamma):
    """z(w^j) running-product evaluations. wires/id_tab/sig_tab: (8, w, n)
    (witness values, identity-permutation values k_i*w^j, sigma-mapped
    identity values); beta/gamma: (8, 1, 1). Returns (8, n):
    [1, prod_{t<j} num_t/den_t ...]."""
    n = wires.shape[2]
    t = _add(wires, gamma)
    num_f = _add(t, _mm(beta, id_tab))
    den_f = _add(t, _mm(beta, sig_tab))

    def wire_reduce(f):
        acc = f[:, 0]
        for i in range(1, f.shape[1]):
            acc = _mm(acc, f[:, i])
        return acc

    ratio = _mm(wire_reduce(num_f), batch_inverse(wire_reduce(den_f)))
    run = cumprod(ratio[:, :n - 1])
    return torch.cat([_one_like(ratio[:, :1]), run], dim=1)


# --- round 3: quotient evaluations ------------------------------------------

def domain_tables(m, n, gen, group_gen, device):
    """Witness-independent quotient-domain tables (8, m): coset points
    ep_i = g*w^i, 1/Z_H(ep) tiled, and 1/(ep - 1)."""
    w_rep = lift_scalar(group_gen, device).expand(FR_WORDS, m)
    pw = cumprod(w_rep.contiguous())                 # w^(i+1)
    g_c = lift_scalar(gen, device)
    ep = torch.cat([g_c, _mm(pw[:, :m - 1], g_c)], dim=1)
    ratio = m // n
    zh = _sub(fr_pow(ep[:, :ratio], n), _one_like(ep[:, :ratio]))
    zh_inv = batch_inverse(zh).repeat(1, m // ratio)
    shifted_inv = batch_inverse(_sub(ep, _one_like(ep)))
    return {"ep": ep, "zh_inv": zh_inv, "shifted_inv": shifted_inv}


def _pow5(x):
    x2 = _mm(x, x)
    return _mm(_mm(x2, x2), x)


def quotient_evals(selectors, sigmas, wires, z, pi, tabs, k, beta, gamma,
                   alpha, alpha_sq_div_n, ratio):
    """Coset evaluations of the quotient polynomial, elementwise on m lanes
    (prover_jax.quotient_evals_core). selectors (8, 13, m); sigmas/wires
    (8, 5, m); z/pi (8, m); k (8, 5, 1); scalars (8, 1). Selector order as
    circuit.py: Q_LC x4, Q_MUL x2, Q_HASH x4, Q_O, Q_C, Q_ECC."""
    z_next = torch.roll(z, -ratio, dims=1)
    a, b, c, d, e = (wires[:, i] for i in range(5))
    ab = _mm(a, b)
    cd = _mm(c, d)
    gate = _add(selectors[:, 11], pi)                 # q_c + pi
    for i, operand in ((0, a), (1, b), (2, c), (3, d)):
        gate = _add(gate, _mm(selectors[:, i], operand))
    gate = _add(gate, _mm(selectors[:, 4], ab))
    gate = _add(gate, _mm(selectors[:, 5], cd))
    for i, operand in ((6, a), (7, b), (8, c), (9, d)):
        gate = _add(gate, _mm(selectors[:, i], _pow5(operand)))
    gate = _add(gate, _mm(selectors[:, 12], _mm(_mm(ab, cd), e)))
    gate = _sub(gate, _mm(selectors[:, 10], e))

    ep = tabs["ep"]
    acc1 = z
    acc2 = z_next
    for j in range(5):
        t = _add(wires[:, j], gamma)
        acc1 = _mm(acc1, _add(t, _mm(_mm(k[:, j], ep), beta)))
        acc2 = _mm(acc2, _add(t, _mm(sigmas[:, j], beta)))
    perm = _mm(alpha, _sub(acc1, acc2))
    l1 = _mm(_mm(alpha_sq_div_n, _sub(z, _one_like(z))),
             tabs["shifted_inv"])
    return _add(_mm(tabs["zh_inv"], _add(gate, perm)), l1)


# --- round 3, streamed: one fold per coset plane ----------------------------
# The quotient formula reads each selector plane once (a gate term) and
# each sigma plane once (an acc2 factor), so each folds into a running
# accumulator right after its coset FFT and is dropped (prover_jax's step
# programs). The port's (8, m) words already are the JAX "packed" layout,
# so no step packs or unpacks. Selector order: circuit.py (Q_LC x4,
# Q_MUL x2, Q_HASH x4, Q_O, Q_C, Q_ECC).

def gate_linear_step(gate, plane, w):
    """gate += sel * w (the four Q_LC selectors)."""
    return _add(gate, _mm(plane, w))


def gate_mul2_step(gate, plane, wa, wb):
    """gate += sel * (wa * wb) (the two Q_MUL selectors)."""
    return _add(gate, _mm(plane, _mm(wa, wb)))


def gate_pow5_step(gate, plane, w):
    """gate += sel * w^5 (the four Q_HASH selectors)."""
    return _add(gate, _mm(plane, _pow5(w)))


def gate_out_step(gate, plane, w):
    """gate -= sel * e (Q_O)."""
    return _sub(gate, _mm(plane, w))


def gate_const_step(gate, plane):
    """gate += sel (Q_C)."""
    return _add(gate, plane)


def gate_ecc_step(gate, plane, w0, w1, w2, w3, w4):
    """gate += sel * a*b*c*d*e (Q_ECC)."""
    abcd = _mm(_mm(w0, w1), _mm(w2, w3))
    return _add(gate, _mm(plane, _mm(abcd, w4)))


# selector index -> (step, wire-plane operand indices), circuit.py order
GATE_STEPS = (
    [(gate_linear_step, (i,)) for i in range(4)]                    # Q_LC
    + [(gate_mul2_step, (0, 1)), (gate_mul2_step, (2, 3))]          # Q_MUL
    + [(gate_pow5_step, (i,)) for i in range(4)]                    # Q_HASH
    + [(gate_out_step, (4,)),                                       # Q_O
       (gate_const_step, ()),                                       # Q_C
       (gate_ecc_step, (0, 1, 2, 3, 4))]                            # Q_ECC
)


def sigma_step(acc2, plane, w, beta, gamma):
    """acc2 *= (w + gamma + beta * sigma): one step per sigma plane. acc2
    starts as the rolled z plane (z_next), so after the five steps it
    equals quotient_evals' acc2 product."""
    return _mm(acc2, _add(_add(w, gamma), _mm(plane, beta)))


def quotient_combine_slice(wires, z, gate, acc2, tabs, k, beta, gamma,
                           alpha, alpha_sq_div_n, j0, chunk):
    """The final combine on lanes [j0, j0 + chunk): acc1 from the resident
    wires and the ep table, then zh_inv * (gate + alpha * (acc1 - acc2))
    + l1. acc2 already includes the z_next factor."""
    def cut(a):
        return a[:, j0:j0 + chunk]

    zs = cut(z)
    ep = cut(tabs["ep"])
    acc1 = zs
    for j in range(5):
        t = _add(cut(wires[j]), gamma)
        acc1 = _mm(acc1, _add(t, _mm(_mm(k[:, j], ep), beta)))
    perm = _mm(alpha, _sub(acc1, cut(acc2)))
    l1 = _mm(_mm(alpha_sq_div_n, _sub(zs, _one_like(zs))),
             cut(tabs["shifted_inv"]))
    return _add(_mm(cut(tabs["zh_inv"]), _add(cut(gate), perm)), l1)


# --- round 3, fused: one launch per fold ------------------------------------
# The JAX package's DPT_R3_FUSE folds (jax_backend._gate_epilogue,
# _sigma_epilogue, _combine_prologue). Each takes a batch of coset planes
# (8, B, m) and the (8, 5, m) wire planes, read through their strides, and
# host ints for the scalars (canonical Fr values: the transcript's
# challenges and the coset constants k). CUDA tensors launch
# csrc/round3.cu, one kernel per call and no host synchronisation (the
# scalars ride the launch's parameters); CPU tensors run the plain
# versions, which are the step functions above, value for value. Each
# returns a fresh contiguous (8, m) tensor.

def gate_fold_ref(gate, planes, wires, start):
    """gate + the terms of selectors start .. start + B - 1 (GATE_STEPS
    order), whose coset planes are planes[:, 0 .. B - 1]."""
    for j in range(planes.shape[1]):
        step, operands = GATE_STEPS[start + j]
        gate = step(gate, planes[:, j], *[wires[:, x] for x in operands])
    return gate


def sigma_fold_ref(acc2, planes, wires, start, beta, gamma):
    """acc2 * prod_j (w_{start+j} + gamma + beta * planes[:, j])."""
    beta_c = lift_scalar(beta, acc2.device)
    gamma_c = lift_scalar(gamma, acc2.device)
    for j in range(planes.shape[1]):
        acc2 = sigma_step(acc2, planes[:, j], wires[:, start + j], beta_c,
                          gamma_c)
    return acc2


def quotient_combine_ref(wires, z, gate, acc2, tabs, k, beta, gamma, alpha,
                         alpha_sq_div_n):
    """quotient_combine_slice over the whole quotient domain [0, m)."""
    dev = z.device
    kc = lift(list(k), dev).reshape(FR_WORDS, len(k), 1)
    sc = [lift_scalar(x, dev) for x in (beta, gamma, alpha, alpha_sq_div_n)]
    return quotient_combine_slice(
        [wires[:, j] for j in range(wires.shape[1])], z, gate, acc2, tabs,
        kc, *sc, 0, z.shape[1])


def _mont_words(values):
    """Canonical Fr ints -> the words of their Montgomery forms, a ctypes
    uint32 array for a launch's parameters."""
    words = [(x % R_MOD * FR_MONT_R % R_MOD) >> (32 * i) & WORD_MASK
             for x in values for i in range(FR_WORDS)]
    return (ctypes.c_uint32 * len(words))(*words)


def _r3_operand(t, what, dims, m, dev):
    """Check a round-3 operand: int32 Fr words of `dims` axes, m lanes
    with unit stride, on `dev`; returns its word stride."""
    F._check_words(FR, t, what, contiguous=False)
    if t.dim() != dims or t.shape[-1] != m or t.stride(-1) != 1:
        raise ValueError("%s: expected %d axes of m = %d unit-stride lanes,"
                         " got shape %s strides %s" % (
                             what, dims, m, tuple(t.shape), t.stride()))
    if t.device != dev:
        raise ValueError("%s: on %s, the fold runs on %s" % (what, t.device,
                                                              dev))
    return t.stride(0)


def _r3_launch(entry, name, dev, args, stream_of):
    """Launch round3.cu's `entry` on dev's current stream; count `name`."""
    fn = getattr(_build.load()["round3"], entry)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, F._stream(stream_of))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, F._stream(stream_of))
    _build.check(rc, name)
    _build.count(name)


def _r3_batch(planes, wires, start, limit, what):
    """(device, m, B) of a fold's batch, checked."""
    dev = planes.device
    if dev.type != "cuda":
        raise ValueError("%s: operands must lie on one CUDA device" % what)
    m, B = planes.shape[-1], planes.shape[1]
    if wires.dim() != 3 or wires.shape[1] != 5:
        raise ValueError("%s: expected the (8, 5, m) wire planes, got %s"
                         % (what, tuple(wires.shape)))
    if start < 0 or start + B > limit:
        raise ValueError("%s: planes %d .. %d outside the %d of the table"
                         % (what, start, start + B - 1, limit))
    if m >= 1 << 31:
        raise ValueError("%s: too many lanes %d" % (what, m))
    return dev, m, B


def gate_fold_cuda(gate, planes, wires, start):
    """r3_gate_fold: one launch over the lanes."""
    dev, m, B = _r3_batch(planes, wires, start, len(GATE_STEPS), "gate_fold")
    pw = _r3_operand(planes, "gate_fold planes", 3, m, dev)
    ww = _r3_operand(wires, "gate_fold wires", 3, m, dev)
    gw = _r3_operand(gate, "gate_fold gate", 2, m, dev)
    out = torch.empty((FR_WORDS, m), dtype=torch.int32, device=dev)
    _r3_launch("dpt_r3_gate_fold", "r3_gate_fold", dev, (
        out.data_ptr(), out.stride(0), gate.data_ptr(), gw,
        planes.data_ptr(), pw, planes.stride(1), wires.data_ptr(), ww,
        wires.stride(1), start, B, m), gate)
    return out


def sigma_fold_cuda(acc2, planes, wires, start, beta, gamma):
    """r3_sigma_fold: one launch over the lanes."""
    dev, m, B = _r3_batch(planes, wires, start, wires.shape[1], "sigma_fold")
    pw = _r3_operand(planes, "sigma_fold planes", 3, m, dev)
    ww = _r3_operand(wires, "sigma_fold wires", 3, m, dev)
    aw = _r3_operand(acc2, "sigma_fold acc2", 2, m, dev)
    out = torch.empty((FR_WORDS, m), dtype=torch.int32, device=dev)
    _r3_launch("dpt_r3_sigma_fold", "r3_sigma_fold", dev, (
        out.data_ptr(), out.stride(0), acc2.data_ptr(), aw,
        planes.data_ptr(), pw, planes.stride(1), wires.data_ptr(), ww,
        wires.stride(1), start, B, m, _mont_words((beta, gamma))), acc2)
    return out


def quotient_combine_cuda(wires, z, gate, acc2, tabs, k, beta, gamma, alpha,
                          alpha_sq_div_n):
    """r3_combine: one launch over the lanes -> a fresh contiguous
    (8, m)."""
    dev, m = z.device, z.shape[-1]
    if dev.type != "cuda":
        raise ValueError("quotient_combine: operands must lie on one CUDA "
                         "device")
    if wires.shape[1] != len(k) or len(k) != 5:
        raise ValueError("quotient_combine: 5 wire planes and 5 coset "
                         "constants, got %d and %d" % (wires.shape[1],
                                                       len(k)))
    if m >= 1 << 31:
        raise ValueError("quotient_combine: too many lanes %d" % m)
    ww = _r3_operand(wires, "quotient_combine wires", 3, m, dev)
    ins = (z, gate, acc2, tabs["ep"], tabs["zh_inv"], tabs["shifted_inv"])
    words = [_r3_operand(t, "quotient_combine input %d" % i, 2, m, dev)
             for i, t in enumerate(ins)]
    out = torch.empty((FR_WORDS, m), dtype=torch.int32, device=dev)
    scal = _mont_words([gamma, alpha, alpha_sq_div_n, 1]
                       + [kj * beta for kj in k])
    _r3_launch("dpt_r3_combine", "r3_combine", dev, (
        out.data_ptr(), wires.data_ptr(), ww, wires.stride(1),
        (ctypes.c_void_p * 6)(*[t.data_ptr() for t in ins]),
        (ctypes.c_longlong * 6)(*words), m, scal), z)
    return out


def _on_cpu(*ts):
    return all(t.device.type == "cpu" for t in ts)


def gate_fold(gate, planes, wires, start):
    """The gate accumulator (8, m) after selectors start .. start + B - 1
    (circuit.py order: Q_LC x4, Q_MUL x2, Q_HASH x4, Q_O, Q_C, Q_ECC; a
    batch may start or end inside a kind), their coset planes (8, B, m)
    folded over the (8, 5, m) wire planes: JAX _gate_epilogue."""
    if _on_cpu(gate, planes, wires):
        return gate_fold_ref(gate, planes, wires, start)
    return gate_fold_cuda(gate, planes, wires, start)


def sigma_fold(acc2, planes, wires, start, beta, gamma):
    """acc2 (8, m) times (w_j + gamma + beta * sigma_j) for the sigma planes
    j = start .. start + B - 1 of the batch (8, B, m): JAX
    _sigma_epilogue."""
    if _on_cpu(acc2, planes, wires):
        return sigma_fold_ref(acc2, planes, wires, start, beta, gamma)
    return sigma_fold_cuda(acc2, planes, wires, start, beta, gamma)


def quotient_combine(wires, z, gate, acc2, tabs, k, beta, gamma, alpha,
                     alpha_sq_div_n):
    """The quotient's coset evaluations (8, m) over the whole quotient
    domain: acc1 from the wires and tabs["ep"], then
    zh_inv * (gate + alpha * (acc1 - acc2)) + l1 (acc2 holds the z_next
    factor): JAX _combine_prologue, equal to quotient_combine_slice over
    [0, m)."""
    if _on_cpu(wires, z, gate, acc2):
        return quotient_combine_ref(wires, z, gate, acc2, tabs, k, beta,
                                    gamma, alpha, alpha_sq_div_n)
    return quotient_combine_cuda(wires, z, gate, acc2, tabs, k, beta, gamma,
                                 alpha, alpha_sq_div_n)


# --- polynomial utilities ---------------------------------------------------

def _sum_axis1(v):
    """Modular sum over axis 1 of (8, k, ...) as a pairwise tree."""
    while v.shape[1] > 1:
        k = v.shape[1]
        half = (k + 1) // 2
        summed = _add(v[:, :k - half], v[:, half:])
        v = torch.cat([summed, v[:, k - half:half]], dim=1)
    return v[:, 0]


def poly_eval(polys, zs, chunk=256):
    """p_b(z_b) for (8, B, L) Montgomery coefficients at (8, B, 1) points ->
    (8, B) Montgomery. Block Horner: `chunk` sequential multiply-adds over
    ceil(L / chunk) lanes, then the lanes combine with powers of z^chunk."""
    L8, B, L = polys.shape
    chunk = max(1, min(chunk, L))
    lanes = -(-L // chunk)
    v = F.pad_words(polys, lanes * chunk)
    v = v.reshape(L8, B, lanes, chunk)
    acc = torch.zeros((L8, B, lanes), dtype=polys.dtype, device=polys.device)
    for j in range(chunk - 1, -1, -1):
        acc = _add(_mm(acc, zs), v[..., j])
    if lanes > 1:
        zk = fr_pow(zs, chunk)                       # (8, B, 1)
        pw = [_one_like(zk)]                         # zk^0 .. zk^(lanes-1)
        for _ in range(lanes - 1):
            pw.append(_mm(pw[-1], zk))
        acc = _mm(acc, torch.cat(pw, dim=2))
    return _sum_axis1(acc.transpose(1, 2))


def poly_eval_many(polys, zs):
    """(8, B, L) polys at (8, B, 1) points -> (8, B) CANONICAL words."""
    return F.from_mont(FR, poly_eval(polys, zs))


def synthetic_divide(poly, zc):
    """Quotient of p(X) / (X - z), remainder dropped, for (8, L) Montgomery
    coefficients and an (8, 1) point: q_j = S_{j+1} z^-(j+1), S the suffix
    sums of c_t z^t (two ladders instead of an O(L) recurrence)."""
    L = poly.shape[1]
    if L <= 1:
        return poly[:, :0]
    zinv = inverse_scalar(zc)
    z_rep = zc.expand(FR_WORDS, L).contiguous()
    pw = torch.cat([_one_like(poly[:, :1]), cumprod(z_rep)[:, :L - 1]],
                   dim=1)                             # z^t
    s = F.cumsum(FR, _mm(poly, pw), reverse=True)
    ipw = cumprod(zinv.expand(FR_WORDS, L - 1).contiguous())  # z^-(j+1)
    return _mm(s[:, 1:], ipw)


def lin_comb(stacked, coeffs):
    """sum_i coeff_i * p_i for (8, k, L) polys and (8, k, 1) coefficients."""
    return _sum_axis1(_mm(stacked, coeffs))


def add_vanishing_blind(coeffs, b, n):
    """coeffs + blind(X) * (X^n - 1) for a small (8, d1) Montgomery blind:
    out has length n + d1; out[n+i] += b_i, out[i] -= b_i."""
    d1 = b.shape[1]
    ext = F.pad_words(coeffs, n + d1)
    head = _sub(ext[:, :d1], b)
    tail = _add(ext[:, n:n + d1], b)
    return torch.cat([head, ext[:, d1:n], tail], dim=1)


def tail_is_zero(poly, degree):
    """True iff every coefficient above `degree` is zero."""
    return bool((poly[:, degree + 1:] == 0).all())

