"""Pure-Python reference field arithmetic (the CPU oracle).

This plays the role the `ark-ff` crates play for the reference
(reference Cargo.toml:31-37): a trusted, simple implementation that the
device limb kernels are asserted bit-identical against, and that hosts the cheap
sequential protocol math (challenges, small inversions).

Representation: Fr/Fq elements are plain Python ints in [0, mod).
Extension tower (for the pairing-based verifier):
    Fq2  = Fq[u]/(u^2 + 1)            -> tuple (c0, c1)
    Fq6  = Fq2[v]/(v^3 - (u + 1))     -> tuple of 3 Fq2
    Fq12 = Fq6[w]/(w^2 - v)           -> tuple of 2 Fq6
"""

from .constants import R_MOD, Q_MOD, FR_GENERATOR, FR_ROOT_OF_UNITY, FR_TWO_ADICITY


# --- prime fields ------------------------------------------------------------

def fr_add(a, b):
    return (a + b) % R_MOD


def fr_sub(a, b):
    return (a - b) % R_MOD


def fr_mul(a, b):
    return (a * b) % R_MOD


def fr_neg(a):
    return (-a) % R_MOD


def fr_inv(a):
    if a == 0:
        raise ZeroDivisionError("Fr inverse of zero")
    return pow(a, R_MOD - 2, R_MOD)


def fr_pow(a, e):
    return pow(a, e, R_MOD)


def fq_add(a, b):
    return (a + b) % Q_MOD


def fq_sub(a, b):
    return (a - b) % Q_MOD


def fq_mul(a, b):
    return (a * b) % Q_MOD


def fq_neg(a):
    return (-a) % Q_MOD


def fq_inv(a):
    if a == 0:
        raise ZeroDivisionError("Fq inverse of zero")
    return pow(a, Q_MOD - 2, Q_MOD)


def batch_inverse(vals, mod):
    """Montgomery batch inversion: one modular inverse + 3(n-1) mults."""
    n = len(vals)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        if v == 0:
            raise ZeroDivisionError("batch_inverse of zero")
        prefix[i + 1] = prefix[i] * v % mod
    inv_all = pow(prefix[n], mod - 2, mod)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % mod
        inv_all = inv_all * vals[i] % mod
    return out


def fr_root_of_unity(n):
    """Primitive n-th root of unity in Fr (n a power of two <= 2^32).

    Matches ark-poly's Radix2EvaluationDomain group_gen construction
    (used at reference src/worker.rs:49-54).
    """
    assert n & (n - 1) == 0 and n >= 1
    log_n = n.bit_length() - 1
    assert log_n <= FR_TWO_ADICITY
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - log_n), R_MOD)


# --- Fq2 ---------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q_MOD, (a[1] + b[1]) % Q_MOD)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q_MOD, (a[1] - b[1]) % Q_MOD)


def fq2_neg(a):
    return ((-a[0]) % Q_MOD, (-a[1]) % Q_MOD)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0] % Q_MOD
    t1 = a[1] * b[1] % Q_MOD
    c0 = (t0 - t1) % Q_MOD
    c1 = ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % Q_MOD
    return (c0, c1)


def fq2_sq(a):
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    c0 = (a[0] + a[1]) * (a[0] - a[1]) % Q_MOD
    c1 = 2 * a[0] * a[1] % Q_MOD
    return (c0, c1)


def fq2_scalar(a, k):
    return (a[0] * k % Q_MOD, a[1] * k % Q_MOD)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q_MOD)


def fq2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % Q_MOD
    ninv = fq_inv(norm)
    return (a[0] * ninv % Q_MOD, (-a[1]) * ninv % Q_MOD)


# nonresidue xi = u + 1 (Fq6 = Fq2[v]/(v^3 - xi))
FQ2_XI = (1, 1)


def fq2_mul_by_xi(a):
    # (a0 + a1 u)(1 + u) = (a0 - a1) + (a0 + a1) u
    return ((a[0] - a[1]) % Q_MOD, (a[0] + a[1]) % Q_MOD)


# --- Fq6 ---------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, fq2_mul_by_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), fq2_mul_by_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sq(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    # v * (a0 + a1 v + a2 v^2) = xi a2 + a0 v + a1 v^2
    return (fq2_mul_by_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sq(a0), fq2_mul_by_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_by_xi(fq2_sq(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sq(a1), fq2_mul(a0, a2))
    t = fq2_add(fq2_mul_by_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))), fq2_mul(a0, c0))
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


# --- Fq12 --------------------------------------------------------------------

FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_sq(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    a0, a1 = a
    t = fq6_sub(fq6_sq(a0), fq6_mul_by_v(fq6_sq(a1)))
    tinv = fq6_inv(t)
    return (fq6_mul(a0, tinv), fq6_neg(fq6_mul(a1, tinv)))


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e):
    result = FQ12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sq(base)
        e >>= 1
    return result
