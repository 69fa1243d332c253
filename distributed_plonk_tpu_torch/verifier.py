"""TurboPlonk verifier (host-side, pairing-based).

Plays the role of the stock jf-plonk verifier the reference checks its proofs
against (reference src/dispatcher2.rs:1290-1293). Challenges are
re-derived through the same byte-exact transcript as the prover; the
linearization commitment D is reconstructed homomorphically from the vk, and
two KZG openings (zeta and omega*zeta) are checked in one multi-pairing.

The expected evaluation of the linearization polynomial at zeta is derived
from the quotient identity:
    lin(zeta) = alpha^2 L1(zeta) - PI(zeta)
              + alpha * perm_next_eval * (w4 + gamma)
                * prod_{i<4} (w_i + beta sigma_i(zeta) + gamma)
"""

import random

from .constants import R_MOD
from .fields import fr_inv, batch_inverse
from . import curve as C
from . import poly as P
from .circuit import (
    NUM_WIRE_TYPES,
    Q_LC,
    Q_MUL,
    Q_HASH,
    Q_O,
    Q_C,
    Q_ECC,
)
from .transcript import StandardTranscript


def _replay_challenges(vk, pub_input, proof):
    t = StandardTranscript()
    t.append_vk_and_pub_input(vk, pub_input)
    t.append_commitments(b"witness_poly_comms", proof.wires_poly_comms)
    beta = t.get_and_append_challenge(b"beta")
    gamma = t.get_and_append_challenge(b"gamma")
    t.append_commitment(b"perm_poly_comms", proof.prod_perm_poly_comm)
    alpha = t.get_and_append_challenge(b"alpha")
    t.append_commitments(b"quot_poly_comms", proof.split_quot_poly_comms)
    zeta = t.get_and_append_challenge(b"zeta")
    t.append_proof_evaluations(
        proof.wires_evals, proof.wire_sigma_evals, proof.perm_next_eval)
    v = t.get_and_append_challenge(b"v")
    return beta, gamma, alpha, zeta, v


def _g1_in_subgroup(p):
    """On-curve + order-r check (G1 has cofactor > 1; reject small-subgroup
    points, as jf-plonk's deserialization-time validation does)."""
    if p is None:
        return True
    if not C.g1_is_on_curve(p):
        return False
    acc = C.g1_to_jac(p)
    t = (1, 1, 0)
    k = R_MOD
    while k > 0:  # unreduced scalar mul by r
        if k & 1:
            t = C.g1_jac_add(t, acc)
        acc = C.g1_jac_double(acc)
        k >>= 1
    return t[2] == 0


def _validate_proof_shape(proof):
    if len(proof.wires_poly_comms) != NUM_WIRE_TYPES:
        return False
    if len(proof.split_quot_poly_comms) != NUM_WIRE_TYPES:
        return False
    if len(proof.wires_evals) != NUM_WIRE_TYPES:
        return False
    if len(proof.wire_sigma_evals) != NUM_WIRE_TYPES - 1:
        return False
    points = (proof.wires_poly_comms + proof.split_quot_poly_comms
              + [proof.prod_perm_poly_comm, proof.opening_proof,
                 proof.shifted_opening_proof])
    if not all(_g1_in_subgroup(p) for p in points):
        return False
    scalars = list(proof.wires_evals) + list(proof.wire_sigma_evals) + [proof.perm_next_eval]
    return all(isinstance(s, int) and 0 <= s < R_MOD for s in scalars)


def opening_terms(vk, pub_input, proof, u, domain=None):
    """The verifier's final pairing equation, held open as MSM terms.

    Returns (lhs_points, lhs_scalars, rhs_points, rhs_scalars) such that
    the proof verifies iff

        e(MSM(lhs), g2) * e(-MSM(rhs), tau_g2) == 1

    with `u` the opening-fold challenge (verify() draws it from its rng;
    verify_aggregate derives per-member u_j from the aggregation
    transcript). Returns None when the proof fails any of the structural
    validations (malformed shape, non-subgroup point, bad public input,
    zeta landing in the domain) — callers must treat None as REJECT.
    Keeping the terms un-evaluated is what makes batch aggregation a
    one-liner: scale every member's scalars by r_j, concatenate, and the
    N-proof check is still two MSMs and ONE 2-pair pairing_check.
    """
    n = vk.domain_size
    domain = domain or P.Domain(n)

    if not _validate_proof_shape(proof):
        return None
    # Reject length mismatches: extra "public inputs" would land on non-IO
    # rows via L_i(zeta) and let a prover bind arbitrary claimed values.
    if len(pub_input) != vk.num_inputs:
        return None
    if not all(isinstance(x, int) and 0 <= x < R_MOD for x in pub_input):
        return None

    beta, gamma, alpha, zeta, vch = _replay_challenges(vk, pub_input, proof)

    vanish_eval = (pow(zeta, n, R_MOD) - 1) % R_MOD
    if vanish_eval == 0:
        return None  # zeta landed in the domain; reject (prob ~ n/r)
    zeta_minus_1_inv = fr_inv((zeta - 1) % R_MOD)
    n_inv = fr_inv(n % R_MOD)
    lagrange_1_eval = vanish_eval * n_inv % R_MOD * zeta_minus_1_inv % R_MOD

    # PI(zeta) = sum_i pub_i * L_i(zeta), L_i(zeta) = w^i/n * Z_H(zeta)/(zeta-w^i)
    w_pows = []
    w_pow = 1
    for _ in pub_input:
        w_pows.append(w_pow)
        w_pow = w_pow * domain.group_gen % R_MOD
    denom_invs = batch_inverse([(zeta - wp) % R_MOD for wp in w_pows], R_MOD)
    pi_eval = 0
    for x, wp, dinv in zip(pub_input, w_pows, denom_invs):
        li = wp * n_inv % R_MOD * vanish_eval % R_MOD * dinv % R_MOD
        pi_eval = (pi_eval + x * li) % R_MOD

    a, b, c, d, e = proof.wires_evals
    ab = a * b % R_MOD
    cd = c * d % R_MOD

    # expected lin(zeta) from the quotient identity
    sigma_prod = 1
    for w_eval, s_eval in zip(proof.wires_evals[:NUM_WIRE_TYPES - 1],
                              proof.wire_sigma_evals):
        sigma_prod = sigma_prod * ((w_eval + beta * s_eval + gamma) % R_MOD) % R_MOD
    lin_eval = (
        alpha * alpha % R_MOD * lagrange_1_eval
        - pi_eval
        + alpha * proof.perm_next_eval % R_MOD * ((e + gamma) % R_MOD) % R_MOD * sigma_prod
    ) % R_MOD

    # homomorphic linearization commitment D
    scalars = []
    points = []
    gate_terms = [
        (Q_LC, a), (Q_LC + 1, b), (Q_LC + 2, c), (Q_LC + 3, d),
        (Q_MUL, ab), (Q_MUL + 1, cd),
        (Q_HASH, pow(a, 5, R_MOD)), (Q_HASH + 1, pow(b, 5, R_MOD)),
        (Q_HASH + 2, pow(c, 5, R_MOD)), (Q_HASH + 3, pow(d, 5, R_MOD)),
        (Q_O, (-e) % R_MOD), (Q_C, 1),
        (Q_ECC, ab * cd % R_MOD * e % R_MOD),
    ]
    for sel_idx, coeff in gate_terms:
        scalars.append(coeff)
        points.append(vk.selector_comms[sel_idx])

    coeff_z = alpha
    for w_eval, ki in zip(proof.wires_evals, vk.k):
        coeff_z = coeff_z * ((w_eval + beta * ki % R_MOD * zeta + gamma) % R_MOD) % R_MOD
    coeff_z = (coeff_z + alpha * alpha % R_MOD * lagrange_1_eval) % R_MOD
    scalars.append(coeff_z)
    points.append(proof.prod_perm_poly_comm)

    coeff_sigma = alpha * beta % R_MOD * proof.perm_next_eval % R_MOD * sigma_prod % R_MOD
    scalars.append((-coeff_sigma) % R_MOD)
    points.append(vk.sigma_comms[NUM_WIRE_TYPES - 1])

    zeta_np2 = (vanish_eval + 1) * zeta % R_MOD * zeta % R_MOD
    coeff = (-vanish_eval) % R_MOD
    for t_comm in proof.split_quot_poly_comms:
        scalars.append(coeff)
        points.append(t_comm)
        coeff = coeff * zeta_np2 % R_MOD

    # batch commitment and batch evaluation (powers of v)
    batch_eval = lin_eval
    vpow = vch
    for comm, ev in zip(proof.wires_poly_comms, proof.wires_evals):
        scalars.append(vpow)
        points.append(comm)
        batch_eval = (batch_eval + vpow * ev) % R_MOD
        vpow = vpow * vch % R_MOD
    for comm, ev in zip(vk.sigma_comms[:NUM_WIRE_TYPES - 1], proof.wire_sigma_evals):
        scalars.append(vpow)
        points.append(comm)
        batch_eval = (batch_eval + vpow * ev) % R_MOD
        vpow = vpow * vch % R_MOD

    # fold the shifted opening in with the challenge u:
    #   e(C_batch - [batch_eval] + zeta W1
    #     + u (z_comm - [perm_next_eval] + omega zeta W2), g2)
    #   == e(W1 + u W2, tau g2)
    omega_zeta = domain.group_gen * zeta % R_MOD

    scalars.append((-batch_eval - u * proof.perm_next_eval) % R_MOD)
    points.append(vk.g1)
    scalars.append(zeta)
    points.append(proof.opening_proof)
    scalars.append(u)
    points.append(proof.prod_perm_poly_comm)
    scalars.append(u * omega_zeta % R_MOD)
    points.append(proof.shifted_opening_proof)

    rhs_points = [proof.opening_proof, proof.shifted_opening_proof]
    rhs_scalars = [1, u]
    return points, scalars, rhs_points, rhs_scalars


def verify(vk, pub_input, proof, domain=None, rng=None):
    rng = rng or random.Random()
    u = rng.randrange(1, R_MOD)
    terms = opening_terms(vk, pub_input, proof, u, domain=domain)
    if terms is None:
        return False
    points, scalars, rhs_points, rhs_scalars = terms
    lhs = C.g1_msm(points, scalars)
    rhs_w = C.g1_msm(rhs_points, rhs_scalars)
    return C.pairing_check([
        (lhs, vk.g2),
        (C.g1_neg(rhs_w), vk.tau_g2),
    ])


def verify_aggregate(members, domains=None):
    """Batched verification: N proofs, ONE 2-pair pairing check.

    members: [(vk, pub_input, proof, u, r)] where (u, r) are the
    per-member opening-fold and linear-combination challenges (derived by
    aggregate.derive_challenges from the aggregation transcript — never
    chosen by the prover). Folds every member's pairing equation by the
    random r_j:

        e(sum_j r_j lhs_j, g2) * e(-sum_j r_j (W1_j + u_j W2_j), tau_g2)

    which is 1 iff (w.h.p. over the r_j) EVERY constituent equation
    holds — a single member failing makes the fold nonzero except with
    probability ~1/r. All members must share the same SRS tail (g2,
    tau_g2): distinct-tau members would pair against different tau_g2
    and cannot be folded, so that is a structural REJECT, not an assert.
    """
    if not members:
        return False
    g2, tau_g2 = members[0][0].g2, members[0][0].tau_g2
    lhs_points, lhs_scalars = [], []
    rhs_points, rhs_scalars = [], []
    for vk, pub_input, proof, u, r in members:
        if vk.g2 != g2 or vk.tau_g2 != tau_g2:
            return False
        domain = (domains or {}).get(vk.domain_size)
        terms = opening_terms(vk, pub_input, proof, u, domain=domain)
        if terms is None:
            return False
        points, scalars, rpoints, rscalars = terms
        lhs_points += points
        lhs_scalars += [r * s % R_MOD for s in scalars]
        rhs_points += rpoints
        rhs_scalars += [r * s % R_MOD for s in rscalars]
    lhs = C.g1_msm(lhs_points, lhs_scalars)
    rhs_w = C.g1_msm(rhs_points, rhs_scalars)
    return C.pairing_check([
        (lhs, g2),
        (C.g1_neg(rhs_w), tau_g2),
    ])
