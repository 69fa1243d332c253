"""Pure-Python reference BLS12-381 curve arithmetic + pairing (CPU oracle).

Replaces the role of `ark-ec`/`ark-bls12-381` in the reference
(reference Cargo.toml:31-37, used at src/worker.rs:122 for MSM and in
jf-plonk's verifier). The device G1 kernels are tested bit-identical against
these ops; the pairing is only used host-side by the verifier.

Point formats:
  G1 affine:   (x, y) ints, or None for the point at infinity.
  G1 jacobian: (X, Y, Z) with x = X/Z^2, y = Y/Z^3; Z == 0 -> infinity.
  G2 affine:   ((x0,x1), (y0,y1)) Fq2 pairs, or None.
"""

from .constants import (
    Q_MOD,
    R_MOD,
    G1_GEN_X,
    G1_GEN_Y,
    G2_GEN_X,
    G2_GEN_Y,
)
from . import fields as F
from .fields import (
    fq_inv,
    fq2_add,
    fq2_sub,
    fq2_mul,
    fq2_sq,
    fq2_inv,
    fq2_neg,
    fq12_mul,
    fq12_sq,
    fq12_inv,
    fq12_pow,
    FQ12_ONE,
)

G1_GEN = (G1_GEN_X, G1_GEN_Y)
G2_GEN = (G2_GEN_X, G2_GEN_Y)

INF = None


# --- G1 affine / jacobian ----------------------------------------------------

def g1_is_on_curve(p):
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x % Q_MOD * x + 4)) % Q_MOD == 0


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % Q_MOD)


def g1_add_affine(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q_MOD == 0:
            return None
        lam = 3 * x1 * x1 % Q_MOD * fq_inv(2 * y1 % Q_MOD) % Q_MOD
    else:
        lam = (y2 - y1) * fq_inv((x2 - x1) % Q_MOD) % Q_MOD
    x3 = (lam * lam - x1 - x2) % Q_MOD
    y3 = (lam * (x1 - x3) - y1) % Q_MOD
    return (x3, y3)


def g1_to_jac(p):
    if p is None:
        return (1, 1, 0)
    return (p[0], p[1], 1)


def g1_from_jac(j):
    X, Y, Z = j
    if Z == 0:
        return None
    zinv = fq_inv(Z)
    z2 = zinv * zinv % Q_MOD
    return (X * z2 % Q_MOD, Y * z2 % Q_MOD * zinv % Q_MOD)


def g1_jac_double(j):
    X1, Y1, Z1 = j
    if Z1 == 0:
        return j
    return _g1_jac_double_nonzero(X1, Y1, Z1)


def _g1_jac_double_nonzero(X1, Y1, Z1):
    # dbl-2009-l (a = 0)
    A = X1 * X1 % Q_MOD
    B = Y1 * Y1 % Q_MOD
    C = B * B % Q_MOD
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % Q_MOD
    E = 3 * A % Q_MOD
    Fv = E * E % Q_MOD
    X3 = (Fv - 2 * D) % Q_MOD
    Y3 = (E * (D - X3) - 8 * C) % Q_MOD
    Z3 = 2 * Y1 * Z1 % Q_MOD
    return (X3, Y3, Z3)


def g1_jac_add(j1, j2):
    X1, Y1, Z1 = j1
    X2, Y2, Z2 = j2
    if Z1 == 0:
        return j2
    if Z2 == 0:
        return j1
    Z1Z1 = Z1 * Z1 % Q_MOD
    Z2Z2 = Z2 * Z2 % Q_MOD
    U1 = X1 * Z2Z2 % Q_MOD
    U2 = X2 * Z1Z1 % Q_MOD
    S1 = Y1 * Z2 % Q_MOD * Z2Z2 % Q_MOD
    S2 = Y2 * Z1 % Q_MOD * Z1Z1 % Q_MOD
    if U1 == U2:
        if S1 != S2:
            return (1, 1, 0)
        return _g1_jac_double_nonzero(X1, Y1, Z1)
    H = (U2 - U1) % Q_MOD
    I = 4 * H * H % Q_MOD
    J = H * I % Q_MOD
    rr = 2 * (S2 - S1) % Q_MOD
    V = U1 * I % Q_MOD
    X3 = (rr * rr - J - 2 * V) % Q_MOD
    Y3 = (rr * (V - X3) - 2 * S1 * J) % Q_MOD
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % Q_MOD * H % Q_MOD
    return (X3, Y3, Z3)


def g1_mul(p, k, reduce=True):
    """Scalar multiplication (double-and-add, jacobian).

    reduce=False keeps k unreduced mod r — needed by subgroup checks
    (r·p = O?), where reducing would turn the check into 0·p."""
    if reduce:
        k %= R_MOD
    acc = (1, 1, 0)
    base = g1_to_jac(p)
    while k > 0:
        if k & 1:
            acc = g1_jac_add(acc, base)
        base = g1_jac_double(base)
        k >>= 1
    return g1_from_jac(acc)


def g1_msm(points, scalars):
    """Reference variable-base MSM (Pippenger, window=8).

    Oracle for the device MSM (reference behavior: src/worker.rs:159-185).
    Accepts affine points (None = infinity, as produced by the reference's
    zero-padding of the SRS at src/dispatcher2.rs:208).
    """
    assert len(points) == len(scalars)
    scalars = [s % R_MOD for s in scalars]
    c = 8
    num_windows = (R_MOD.bit_length() + c - 1) // c
    window_sums = []
    for w in range(num_windows):
        buckets = [(1, 1, 0)] * ((1 << c) - 1)
        shift = w * c
        for p, s in zip(points, scalars):
            if p is None:
                continue
            digit = (s >> shift) & ((1 << c) - 1)
            if digit != 0:
                buckets[digit - 1] = g1_jac_add(buckets[digit - 1], g1_to_jac(p))
        acc = (1, 1, 0)
        running = (1, 1, 0)
        for b in reversed(buckets):
            running = g1_jac_add(running, b)
            acc = g1_jac_add(acc, running)
        window_sums.append(acc)
    total = (1, 1, 0)
    for ws in reversed(window_sums):
        for _ in range(c):
            total = g1_jac_double(total)
        total = g1_jac_add(total, ws)
    return g1_from_jac(total)


# --- G2 affine ---------------------------------------------------------------

def g2_is_on_curve(p):
    if p is None:
        return True
    x, y = p
    rhs = fq2_add(fq2_mul(fq2_sq(x), x), (4, 4))
    return fq2_sub(fq2_sq(y), rhs) == (0, 0)


def g2_neg(p):
    if p is None:
        return None
    return (p[0], fq2_neg(p[1]))


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fq2_add(y1, y2) == (0, 0):
            return None
        lam = fq2_mul(fq2_mul((3, 0), fq2_sq(x1)), fq2_inv(fq2_mul((2, 0), y1)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sq(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(p, k, reduce=True):
    if reduce:
        k %= R_MOD
    acc = None
    base = p
    while k > 0:
        if k & 1:
            acc = g2_add(acc, base)
        base = g2_add(base, base)
        k >>= 1
    return acc


# --- Pairing (Tate, with denominators eliminated by the final exponentiation)

def _fq12_from_fq(a):
    return (((a, 0), (0, 0), (0, 0)), ((0, 0), (0, 0), (0, 0)))


def _fq12_scalar_fq(a, k):
    """Multiply a generic Fq12 element by k in Fq."""
    c0, c1 = a
    return (
        tuple((x[0] * k % Q_MOD, x[1] * k % Q_MOD) for x in c0),
        tuple((x[0] * k % Q_MOD, x[1] * k % Q_MOD) for x in c1),
    )


def _fq12_sub(a, b):
    return (F.fq6_sub(a[0], b[0]), F.fq6_sub(a[1], b[1]))


_W = (F.FQ6_ZERO, F.FQ6_ONE)  # w, with w^2 = v, w^6 = xi = u + 1
_W2_INV = fq12_inv(fq12_sq(_W))
_W3_INV = fq12_inv(fq12_mul(fq12_sq(_W), _W))


def _untwist(q):
    """Map a G2 point on the twist E'/Fq2 into E(Fq12).

    BLS12-381 uses the M-twist y^2 = x^3 + 4(u+1); psi(x, y) =
    (x * w^-2, y * w^-3) lands on y^2 = x^3 + 4 since w^6 = u + 1.
    """
    x, y = q
    return (fq12_mul(_embed_fq2(x), _W2_INV), fq12_mul(_embed_fq2(y), _W3_INV))


def _embed_fq2(a):
    return ((a, F.FQ2_ZERO, F.FQ2_ZERO), F.FQ6_ZERO)


FINAL_EXP = (Q_MOD ** 12 - 1) // R_MOD


def miller_loop(p, q_untwisted):
    """f_{r,P}(Q) with vertical lines dropped (killed by the final exp).

    P is a G1 affine point (coords in Fq); Q is an untwisted G2 point with
    coordinates in Fq12. Line arithmetic stays in Fq; only the evaluation
    accumulator lives in Fq12.
    """
    xq, yq = q_untwisted
    f = FQ12_ONE
    tx, ty = p  # T = P, affine in Fq

    def line_eval(lam, x0, y0):
        # l(Q) = (y_Q - y0) - lam * (x_Q - x0)
        t1 = _fq12_sub(yq, _fq12_from_fq(y0))
        t2 = _fq12_scalar_fq(_fq12_sub(xq, _fq12_from_fq(x0)), lam)
        return _fq12_sub(t1, t2)

    bits = bin(R_MOD)[3:]  # skip leading 1
    T_inf = False
    for b in bits:
        if not T_inf:
            # doubling step
            if ty == 0:
                T_inf = True
            else:
                lam = 3 * tx * tx % Q_MOD * fq_inv(2 * ty % Q_MOD) % Q_MOD
                f = fq12_mul(fq12_sq(f), line_eval(lam, tx, ty))
                nx = (lam * lam - 2 * tx) % Q_MOD
                ny = (lam * (tx - nx) - ty) % Q_MOD
                tx, ty = nx, ny
        else:
            f = fq12_sq(f)
        if b == "1" and not T_inf:
            # addition step T += P
            px, py = p
            if tx == px:
                if (ty + py) % Q_MOD == 0:
                    # vertical line, dropped; T becomes infinity
                    T_inf = True
                else:
                    lam = 3 * tx * tx % Q_MOD * fq_inv(2 * ty % Q_MOD) % Q_MOD
                    f = fq12_mul(f, line_eval(lam, tx, ty))
                    nx = (lam * lam - 2 * tx) % Q_MOD
                    ny = (lam * (tx - nx) - ty) % Q_MOD
                    tx, ty = nx, ny
            else:
                lam = (py - ty) * fq_inv((px - tx) % Q_MOD) % Q_MOD
                f = fq12_mul(f, line_eval(lam, tx, ty))
                nx = (lam * lam - tx - px) % Q_MOD
                ny = (lam * (tx - nx) - ty) % Q_MOD
                tx, ty = nx, ny
    return f


# pairing-cost accounting: aggregation's whole value proposition is
# "N proofs, one 2-pair check", so tests pin the claim against these
# counters instead of trusting the docstring (reset_pairing_counters()
# then assert checks == 1 and pairs == 2 after verify_aggregate).
PAIRING_COUNTERS = {"checks": 0, "pairs": 0}


def reset_pairing_counters():
    PAIRING_COUNTERS["checks"] = 0
    PAIRING_COUNTERS["pairs"] = 0


def pairing_check(pairs):
    """Return True iff prod e(P_i, Q_i) == 1.

    Multi-pairing: one Miller loop per pair, a single shared final
    exponentiation. This is all the verifier needs (KZG check at
    jf-plonk's verify, reference src/dispatcher2.rs:1290-1293).
    """
    PAIRING_COUNTERS["checks"] += 1
    f = FQ12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue
        PAIRING_COUNTERS["pairs"] += 1
        f = fq12_mul(f, miller_loop(p, _untwist(q)))
    return fq12_pow(f, FINAL_EXP) == FQ12_ONE


def pairing(p, q):
    """Full pairing value (slow; used only in tests for bilinearity)."""
    if p is None or q is None:
        return FQ12_ONE
    return fq12_pow(miller_loop(p, _untwist(q)), FINAL_EXP)
