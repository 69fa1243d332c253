"""Host-side polynomial utilities + reference radix-2 NTT (CPU oracle).

Mirrors the semantics of `ark-poly`'s Radix2EvaluationDomain as used by the
reference (fft/ifft/coset at reference src/worker.rs:82-115 and the
4-step decomposition spec at reference src/playground.rs:21-80):

  fft(c)[i]      = sum_j c_j w^{ij}              (evals on H)
  ifft(e)[j]     = 1/n sum_i e_i w^{-ij}
  coset_fft(c)   = fft(c_j * g^j)                (evals on gH, g = 7)
  coset_ifft(e)  = ifft(e)_j * g^{-j}

Everything here is pure Python over int lists - it is the oracle the device
NTT kernels (backend/ntt_torch.py) are asserted bit-identical against.
"""

from .constants import R_MOD, FR_GENERATOR
from .fields import fr_inv, fr_root_of_unity


class Domain:
    """Radix-2 evaluation domain over Fr (size a power of two)."""

    def __init__(self, min_size):
        n = 1
        while n < min_size:
            n <<= 1
        self.size = n
        self.log_size = n.bit_length() - 1
        self.group_gen = fr_root_of_unity(n)
        self.group_gen_inv = fr_inv(self.group_gen) if n > 1 else 1
        self.size_inv = fr_inv(n % R_MOD)
        self.coset_gen = FR_GENERATOR

    def elements(self):
        w = self.group_gen
        cur = 1
        for _ in range(self.size):
            yield cur
            cur = cur * w % R_MOD

    def vanishing_eval(self, tau):
        """Z_H(tau) = tau^n - 1."""
        return (pow(tau, self.size, R_MOD) - 1) % R_MOD


def _bit_reverse_permute(v):
    n = len(v)
    log_n = n.bit_length() - 1
    for i in range(n):
        j = int(bin(i)[2:].zfill(log_n)[::-1], 2) if log_n > 0 else 0
        if j > i:
            v[i], v[j] = v[j], v[i]


def _ntt_in_place(v, omega):
    """Iterative Cooley-Tukey: v[i] <- sum_j v[j] omega^{ij}."""
    n = len(v)
    assert n & (n - 1) == 0
    if n == 1:
        return
    _bit_reverse_permute(v)
    m = 1
    while m < n:
        w_m = pow(omega, n // (2 * m), R_MOD)
        for k in range(0, n, 2 * m):
            w = 1
            for j in range(m):
                t = w * v[k + j + m] % R_MOD
                u = v[k + j]
                v[k + j] = (u + t) % R_MOD
                v[k + j + m] = (u - t) % R_MOD
                w = w * w_m % R_MOD
        m <<= 1


def fft(domain, coeffs):
    assert len(coeffs) <= domain.size, "input longer than domain"
    v = list(coeffs) + [0] * (domain.size - len(coeffs))
    _ntt_in_place(v, domain.group_gen)
    return v


def ifft(domain, evals):
    assert len(evals) <= domain.size, "input longer than domain"
    v = list(evals) + [0] * (domain.size - len(evals))
    _ntt_in_place(v, domain.group_gen_inv)
    s = domain.size_inv
    return [x * s % R_MOD for x in v]


def distribute_powers(coeffs, g):
    out = []
    cur = 1
    for c in coeffs:
        out.append(c * cur % R_MOD)
        cur = cur * g % R_MOD
    return out


def coset_fft(domain, coeffs):
    return fft(domain, distribute_powers(coeffs, domain.coset_gen))


def coset_ifft(domain, evals):
    return distribute_powers(ifft(domain, evals), fr_inv(domain.coset_gen))


# --- dense polynomial helpers (coefficient vectors, low degree first) --------

def poly_eval(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R_MOD
    return acc


def poly_add(a, b):
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % R_MOD for i in range(n)]


def poly_sub(a, b):
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % R_MOD for i in range(n)]


def poly_scale(a, k):
    return [c * k % R_MOD for c in a]


def poly_mul_vanishing(a, n):
    """a(X) * (X^n - 1)."""
    out = [0] * (len(a) + n)
    for i, c in enumerate(a):
        out[i + n] = c
        out[i] = (out[i] - c) % R_MOD
    return out


def poly_degree(a):
    for i in range(len(a) - 1, -1, -1):
        if a[i] % R_MOD != 0:
            return i
    return 0


def synthetic_divide(coeffs, z):
    """Quotient of (p(X) - p(z)) / (X - z).

    Matches the reference's manual synthetic division in round 5
    (reference src/dispatcher2.rs:651-666): returns quotient only,
    the remainder (= p(z)) is discarded.
    """
    n = len(coeffs)
    if n <= 1:
        return []
    q = [0] * (n - 1)
    acc = 0
    for i in range(n - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % R_MOD
        q[i - 1] = acc
    return q
