"""Host (pure-Python) compute backend: the CPU oracle the device backends
are measured against — the analog of the reference's v1 local prover path
(reference src/dispatcher.rs:523-960, its "CPU oracle").

Implements the prover's poly-handle protocol with int-list handles; the
formerly-inline host loops (permutation product, quotient evaluations —
the loops the reference keeps on the dispatcher, dispatcher2.rs:330-345,
434-504) live here as the oracle implementations.
"""

from .. import poly as P
from .. import curve as C
from ..constants import R_MOD, FR_GENERATOR
from ..fields import fr_inv, batch_inverse
from ..circuit import GATE_WIDTH, NUM_WIRE_TYPES, Q_LC, Q_MUL, Q_HASH, Q_O, Q_C, Q_ECC


def _pad(coeffs, size):
    assert len(coeffs) <= size
    return list(coeffs) + [0] * (size - len(coeffs))


class PythonBackend:
    """Reference backend. All ops on host, Python ints; handles are lists.
    A commit key held on a device (a DeviceCommitKey, from a key built on
    TorchBackend) is normalized to host points once per key."""

    name = "python"

    _host_key_cache = None   # (device key, its host affine points)

    def _host_key(self, ck):
        if isinstance(ck, list):
            return ck
        hit = self._host_key_cache
        if hit is None or hit[0] is not ck:
            from .curve_torch import affine_to_host, batch_to_affine
            hit = self._host_key_cache = (
                ck, affine_to_host(*batch_to_affine(ck.point)))
        return hit[1]

    # --- plain int-list compute API (worker daemon / dispatcher surface) ----

    def fft(self, domain, values):
        return P.fft(domain, values)

    def ifft(self, domain, values):
        return P.ifft(domain, values)

    def coset_fft(self, domain, values):
        return P.coset_fft(domain, values)

    def coset_ifft(self, domain, values):
        return P.coset_ifft(domain, values)

    def msm(self, bases, scalars):
        """Variable-base MSM; scalars zero-padded to |bases| by caller."""
        return C.g1_msm(bases[:len(scalars)], scalars)

    def commit(self, ck, coeffs):
        return self.msm(self._host_key(ck), coeffs)

    # --- poly-handle protocol (handles = int lists) --------------------------

    def lift(self, values):
        return list(values)

    def lower(self, h):
        return list(h)

    def wire_values(self, circuit):
        return [circuit.wire_values(i) for i in range(NUM_WIRE_TYPES)]

    def pk_polys(self, pk):
        return pk.selectors, pk.sigmas

    def ifft_h(self, domain, h):
        return self.ifft(domain, h)

    def coset_fft_h(self, domain, h):
        return self.coset_fft(domain, h)

    def coset_ifft_h(self, domain, h):
        return self.coset_ifft(domain, h)

    # batch NTT entry points: sequential here; the fleet backend overrides
    # these with concurrent multi-worker dispatch (the join_all pattern,
    # reference dispatcher2.rs:294-321,382-414)
    def ifft_many(self, domain, handles):
        return [self.ifft_h(domain, h) for h in handles]

    def coset_fft_many(self, domain, handles):
        return [self.coset_fft_h(domain, h) for h in handles]

    def blind(self, h, blinds, n):
        return P.poly_add(P.poly_mul_vanishing(blinds, n), h)

    def commit_h(self, ck, h):
        return self.commit(ck, _pad(h, len(ck)))

    # batch commitment entry points (the reference's join_all commit
    # fan-outs, dispatcher2.rs:316-321,526-533): sequential here; the
    # device backend overrides with one batched multi-poly MSM launch
    def commit_many(self, ck, coeff_lists):
        return [self.commit(ck, s) for s in coeff_lists]

    def commit_many_h(self, ck, hs):
        return [self.commit_h(ck, h) for h in hs]

    def degree_is(self, h, d):
        return P.poly_degree(h) == d

    def split(self, h, size, count, total):
        assert count * size >= total
        padded = _pad(h, max(len(h), count * size))
        return [padded[i:i + size] for i in range(0, count * size, size)]

    def eval_h(self, h, point):
        return P.poly_eval(h, point)

    def eval_many_h(self, pairs):
        return [self.eval_h(h, point) for h, point in pairs]

    def lin_comb_h(self, polys, coeffs):
        out = []
        for h, cf in zip(polys, coeffs):
            out = P.poly_add(out, P.poly_scale(h, cf % R_MOD))
        return out

    def synth_div_h(self, h, point):
        return P.synthetic_divide(h, point)

    def perm_product(self, circuit, beta, gamma, n):
        """z(w^j) running product (reference src/dispatcher2.rs:330-345)."""
        w = NUM_WIRE_TYPES
        product_vec = [1]
        nums = []
        dens = []
        for j in range(n - 1):
            a = 1
            b = 1
            for i in range(w):
                wire_value = circuit.witness[circuit.wire_variables[i][j]]
                t = (wire_value + gamma) % R_MOD
                a = a * ((t + beta * circuit.extended_id_permutation[i][j]) % R_MOD) % R_MOD
                pi, pj = circuit.wire_permutation[i][j]
                b = b * ((t + beta * circuit.extended_id_permutation[pi][pj]) % R_MOD) % R_MOD
            nums.append(a)
            dens.append(b)
        den_invs = batch_inverse(dens, R_MOD)
        for j in range(n - 1):
            product_vec.append(product_vec[j] * nums[j] % R_MOD * den_invs[j] % R_MOD)
        return product_vec

    def quotient(self, n, m, quot_domain, k, beta, gamma, alpha, alpha_sq_div_n,
                 selectors_coset, sigmas_coset, wires_coset, z_coset, pi_coset):
        """Coset evaluations of the quotient polynomial
        (reference src/dispatcher2.rs:434-504)."""
        g = FR_GENERATOR
        wq = quot_domain.group_gen
        eval_points = []
        cur = g
        for _ in range(m):
            eval_points.append(cur)
            cur = cur * wq % R_MOD
        ratio = m // n
        z_h_vals = [(pow(eval_points[i], n, R_MOD) - 1) % R_MOD for i in range(ratio)]
        z_h_inv = batch_inverse(z_h_vals, R_MOD)
        # 1/(eval_point - 1) for the L1 term
        shifted = [(e - 1) % R_MOD for e in eval_points]
        shifted_inv = batch_inverse(shifted, R_MOD)

        q_lc = selectors_coset[Q_LC:Q_LC + GATE_WIDTH]
        q_mul = selectors_coset[Q_MUL:Q_MUL + 2]
        q_hash = selectors_coset[Q_HASH:Q_HASH + GATE_WIDTH]
        q_o = selectors_coset[Q_O]
        q_c = selectors_coset[Q_C]
        q_ecc = selectors_coset[Q_ECC]

        out = []
        for i in range(m):
            a, b, c, d, e = (w[i] for w in wires_coset)
            ab = a * b % R_MOD
            cd = c * d % R_MOD
            gate = (
                q_c[i] + pi_coset[i]
                + q_lc[0][i] * a + q_lc[1][i] * b + q_lc[2][i] * c + q_lc[3][i] * d
                + q_mul[0][i] * ab + q_mul[1][i] * cd
                + q_ecc[i] * ab % R_MOD * cd % R_MOD * e
                + q_hash[0][i] * pow(a, 5, R_MOD)
                + q_hash[1][i] * pow(b, 5, R_MOD)
                + q_hash[2][i] * pow(c, 5, R_MOD)
                + q_hash[3][i] * pow(d, 5, R_MOD)
                - q_o[i] * e
            ) % R_MOD
            acc1 = z_coset[i]
            acc2 = z_coset[(i + ratio) % m]
            ep = eval_points[i]
            for j in range(NUM_WIRE_TYPES):
                t = (wires_coset[j][i] + gamma) % R_MOD
                acc1 = acc1 * ((t + k[j] * ep % R_MOD * beta) % R_MOD) % R_MOD
                acc2 = acc2 * ((t + sigmas_coset[j][i] * beta) % R_MOD) % R_MOD
            perm = alpha * (acc1 - acc2) % R_MOD
            l1_term = alpha_sq_div_n * ((z_coset[i] - 1) % R_MOD) % R_MOD * shifted_inv[i] % R_MOD
            out.append((z_h_inv[i % ratio] * ((gate + perm) % R_MOD) + l1_term) % R_MOD)
        return out
