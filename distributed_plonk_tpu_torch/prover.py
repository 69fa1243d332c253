"""The 5-round TurboPlonk prover.

Round structure and math mirror the reference's fully-distributed v2 prover
(`Prover::prove`, reference src/dispatcher2.rs:192-713). All polynomial
work — NTTs, MSMs, and the per-round vector math (permutation product,
quotient evaluation, blinding, linear combination, evaluation, synthetic
division) — is delegated to a backend through an opaque poly-handle API:
an int list on a host oracle, an (8, L) Montgomery word tensor that stays
on the card between rounds on TorchBackend. Only transcript scalars
(commitments, challenges, evaluations) cross the host boundary mid-prove.

Fiat-Shamir challenge schedule (beta, gamma, alpha, zeta, v) and transcript
bytes match FakeStandardTranscript exactly, so a proof is byte-identical to
the JAX package's for the same rng, circuit and key.

This is the sequential prover of the JAX package's prover.py: each round a
stage (challenges, vector math, the round's commitments), run back to back.
"""

import random

from .constants import R_MOD
from .fields import fr_inv
from .poly import Domain
from .circuit import NUM_WIRE_TYPES, Q_LC, Q_MUL, Q_HASH, Q_O, Q_C, Q_ECC
from .trace import NULL_TRACER
from .transcript import StandardTranscript


class Proof:
    def __init__(self, wires_poly_comms, prod_perm_poly_comm,
                 split_quot_poly_comms, opening_proof, shifted_opening_proof,
                 wires_evals, wire_sigma_evals, perm_next_eval):
        self.wires_poly_comms = wires_poly_comms
        self.prod_perm_poly_comm = prod_perm_poly_comm
        self.split_quot_poly_comms = split_quot_poly_comms
        self.opening_proof = opening_proof
        self.shifted_opening_proof = shifted_opening_proof
        self.wires_evals = wires_evals
        self.wire_sigma_evals = wire_sigma_evals
        self.perm_next_eval = perm_next_eval


def _rand(rng, count):
    return [rng.randrange(R_MOD) for _ in range(count)]


class _ProveCtx:
    """Read-only per-(pk, backend) state shared by the round stages."""

    def __init__(self, pk, backend):
        self.pk = pk
        self.backend = backend
        self.n = pk.domain_size
        self.domain = pk.domain
        self.nw = NUM_WIRE_TYPES
        self.quot_domain = Domain((self.nw + 1) * (self.n + 1) + 1)
        self.m = self.quot_domain.size
        self.ck = pk.ck
        self.sel_h, self.sigma_h = backend.pk_polys(pk)


class _Member:
    """One job's state: rng, transcript, tracer and round outputs."""

    def __init__(self, rng, ckt, tracer):
        self.rng = rng or random.Random()
        self.ckt = ckt
        self.tr = tracer or NULL_TRACER
        self.transcript = StandardTranscript()
        self.pub = ckt.public_input()


def _commit(cx, mb, hs, name):
    with mb.tr.span(name):
        return cx.backend.commit_many_h(cx.ck, hs)


# -- the five round stages ----------------------------------------------------

def _round1(cx, mb):
    # --- Round 1: wire polynomials (reference src/dispatcher2.rs:293-323)
    be, n = cx.backend, cx.n
    with mb.tr.span("ifft_wires"):
        wire_coeffs = be.ifft_many(cx.domain, be.wire_values(mb.ckt))
        mb.wire_polys = [be.blind(coeffs, _rand(mb.rng, 2), n)
                         for coeffs in wire_coeffs]
    mb.wires_poly_comms = list(_commit(cx, mb, mb.wire_polys,
                                       "commit_wires"))
    mb.transcript.append_commitments(b"witness_poly_comms",
                                     mb.wires_poly_comms)


def _round2(cx, mb):
    # --- Round 2: permutation product (reference src/dispatcher2.rs:325-357)
    be, n = cx.backend, cx.n
    mb.beta = mb.transcript.get_and_append_challenge(b"beta")
    mb.gamma = mb.transcript.get_and_append_challenge(b"gamma")
    with mb.tr.span("perm_product"):
        product_h = be.perm_product(mb.ckt, mb.beta, mb.gamma, n)
    with mb.tr.span("ifft_perm"):
        perm_coeffs = be.ifft_h(cx.domain, product_h)
    mb.permutation_poly = be.blind(perm_coeffs, _rand(mb.rng, 3), n)
    mb.prod_perm_poly_comm = _commit(cx, mb, [mb.permutation_poly],
                                     "commit_perm")[0]
    mb.transcript.append_commitment(b"perm_poly_comms",
                                    mb.prod_perm_poly_comm)


def _round3(cx, mb):
    # --- Round 3: quotient polynomial (reference src/dispatcher2.rs:360-533)
    be, n, m, nw = cx.backend, cx.n, cx.m, cx.nw
    mb.alpha = mb.transcript.get_and_append_challenge(b"alpha")
    alpha_sq_div_n = mb.alpha * mb.alpha % R_MOD * fr_inv(n % R_MOD) % R_MOD
    pi_coeffs = be.ifft_h(
        cx.domain, be.lift(mb.pub + [0] * (n - len(mb.pub))))
    with mb.tr.span("coset_ffts"):
        # the 25 coset-FFTs go out as one batch (concurrent across the
        # fleet in the reference, dispatcher2.rs:382-423)
        batch = be.coset_fft_many(
            cx.quot_domain,
            list(cx.sel_h) + list(cx.sigma_h) + mb.wire_polys
            + [mb.permutation_poly, pi_coeffs])
        ns = len(cx.sel_h)
    with mb.tr.span("quotient_evals"):
        quot_evals = be.quotient(
            n, m, cx.quot_domain, cx.pk.vk.k, mb.beta, mb.gamma,
            mb.alpha, alpha_sq_div_n, batch[:ns], batch[ns:ns + nw],
            batch[ns + nw:ns + 2 * nw], batch[ns + 2 * nw],
            batch[ns + 2 * nw + 1])
        del batch
    with mb.tr.span("coset_ifft_quot"):
        quotient_poly = be.coset_ifft_h(cx.quot_domain, quot_evals)

    expected_degree = nw * (n + 1) + 2
    assert be.degree_is(quotient_poly, expected_degree), expected_degree
    # split into num_wire_types chunks of n+2 coefficients
    # (reference src/dispatcher2.rs:511-525)
    mb.split_quot_polys = be.split(quotient_poly, n + 2, nw,
                                   expected_degree + 1)
    mb.split_quot_poly_comms = list(_commit(cx, mb, mb.split_quot_polys,
                                            "commit_quot"))
    mb.transcript.append_commitments(b"quot_poly_comms",
                                     mb.split_quot_poly_comms)


def _round4(cx, mb):
    # --- Round 4: evaluations (reference src/dispatcher2.rs:542-561)
    nw = cx.nw
    mb.zeta = mb.transcript.get_and_append_challenge(b"zeta")
    # all 10 evaluations in one backend call (one device round-trip)
    pairs = ([(w, mb.zeta) for w in mb.wire_polys]
             + [(s, mb.zeta) for s in cx.sigma_h[:nw - 1]]
             + [(mb.permutation_poly,
                 mb.zeta * cx.domain.group_gen % R_MOD)])
    with mb.tr.span("eval_many"):
        evals = cx.backend.eval_many_h(pairs)
    mb.wires_evals = evals[:nw]
    mb.wire_sigma_evals = evals[nw:2 * nw - 1]
    mb.perm_next_eval = evals[-1]
    mb.transcript.append_proof_evaluations(
        mb.wires_evals, mb.wire_sigma_evals, mb.perm_next_eval)


def _round5(cx, mb):
    # --- Round 5: linearization + openings (reference
    # src/dispatcher2.rs:563-692)
    be, n, nw = cx.backend, cx.n, cx.nw
    vanish_eval = (pow(mb.zeta, n, R_MOD) - 1) % R_MOD
    with mb.tr.span("lin_poly"):
        lin_poly = _linearization_poly(
            be, cx.pk, cx.sel_h, cx.sigma_h, n, mb.beta, mb.gamma,
            mb.alpha, mb.zeta, vanish_eval, mb.wires_evals,
            mb.wire_sigma_evals, mb.perm_next_eval, mb.permutation_poly,
            mb.split_quot_polys,
        )
    v = mb.transcript.get_and_append_challenge(b"v")
    # batched opening at zeta: lin + wires + first 4 sigmas, powers of v
    with mb.tr.span("batch_open"):
        polys = [lin_poly] + mb.wire_polys + cx.sigma_h[:nw - 1]
        coeffs = []
        c = 1
        for _ in polys:
            coeffs.append(c)
            c = c * v % R_MOD
        batch_poly = be.lin_comb_h(polys, coeffs)
        witness_poly = be.synth_div_h(batch_poly, mb.zeta)
        shifted_witness_poly = be.synth_div_h(
            mb.permutation_poly, mb.zeta * cx.domain.group_gen % R_MOD)
    mb.opening_proof, mb.shifted_opening_proof = _commit(
        cx, mb, [witness_poly, shifted_witness_poly], "commit_open")
    mb.proof = Proof(
        mb.wires_poly_comms, mb.prod_perm_poly_comm,
        mb.split_quot_poly_comms, mb.opening_proof,
        mb.shifted_opening_proof, mb.wires_evals, mb.wire_sigma_evals,
        mb.perm_next_eval,
    )


_ROUNDS = (("round1", _round1), ("round2", _round2), ("round3", _round3),
           ("round4", _round4), ("round5", _round5))


def prove(rng, circuit, pk, backend, tracer=None):
    """Produce a TurboPlonk proof for a finalized, satisfied circuit.

    tracer: optional trace.Tracer; records per-round and per-kernel-batch
    wall-clock spans."""
    cx = _ProveCtx(pk, backend)
    mb = _Member(rng, circuit, tracer)
    mb.transcript.append_vk_and_pub_input(pk.vk, mb.pub)
    for name, stage in _ROUNDS:
        with mb.tr.span(name):
            stage(cx, mb)
    return mb.proof


def _linearization_poly(backend, pk, sel_h, sigma_h, n, beta, gamma, alpha,
                        zeta, vanish_eval, wires_evals, wire_sigma_evals,
                        perm_next_eval, permutation_poly, split_quot_polys):
    """lin_poly assembly (reference src/dispatcher2.rs:565-633): all scalar
    coefficients computed on host, one backend linear combination."""
    a, b, c, d, e = wires_evals
    ab = a * b % R_MOD
    cd = c * d % R_MOD

    polys = []
    coeffs = []

    def term(h, cf):
        polys.append(h)
        coeffs.append(cf % R_MOD)

    term(sel_h[Q_LC], a)
    term(sel_h[Q_LC + 1], b)
    term(sel_h[Q_LC + 2], c)
    term(sel_h[Q_LC + 3], d)
    term(sel_h[Q_MUL], ab)
    term(sel_h[Q_MUL + 1], cd)
    term(sel_h[Q_HASH], pow(a, 5, R_MOD))
    term(sel_h[Q_HASH + 1], pow(b, 5, R_MOD))
    term(sel_h[Q_HASH + 2], pow(c, 5, R_MOD))
    term(sel_h[Q_HASH + 3], pow(d, 5, R_MOD))
    term(sel_h[Q_ECC], ab * cd % R_MOD * e % R_MOD)
    term(sel_h[Q_O], -e)
    term(sel_h[Q_C], 1)

    lagrange_1_eval = vanish_eval * fr_inv(
        n % R_MOD * ((zeta - 1) % R_MOD) % R_MOD) % R_MOD
    coeff_z = alpha
    for w_eval, ki in zip(wires_evals, pk.vk.k):
        coeff_z = coeff_z * ((w_eval + beta * ki % R_MOD * zeta + gamma) % R_MOD) % R_MOD
    coeff_z = (coeff_z + alpha * alpha % R_MOD * lagrange_1_eval) % R_MOD
    term(permutation_poly, coeff_z)

    coeff_sigma = alpha * beta % R_MOD * perm_next_eval % R_MOD
    for w_eval, s_eval in zip(wires_evals[:NUM_WIRE_TYPES - 1], wire_sigma_evals):
        coeff_sigma = coeff_sigma * ((w_eval + beta * s_eval + gamma) % R_MOD) % R_MOD
    term(sigma_h[NUM_WIRE_TYPES - 1], -coeff_sigma)

    zeta_np2 = (vanish_eval + 1) * zeta % R_MOD * zeta % R_MOD
    cf = (-vanish_eval) % R_MOD
    for poly in split_quot_polys:
        term(poly, cf)
        cf = cf * zeta_np2 % R_MOD

    return backend.lin_comb_h(polys, coeffs)
