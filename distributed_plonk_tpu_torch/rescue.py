"""Rescue-Prime permutation + sponge hash over Fr, native and in-circuit.

Re-provides the `jf-primitives` Rescue surface the reference's workload
generator consumes (reference src/dispatcher.rs:25-26,1076-1108 pulls
`RescueParameter`-based MerkleTree + `MerkleTreeGadget`; the crate itself is
out-of-tree, so this is a fresh Rescue-Prime instantiation, not a byte
clone). Parameters follow the published Rescue-Prime spec (Szepieniec,
Ashur, Dhooghe 2020) specialised to TurboPlonk's gate set:

  - alpha = 5: the forward S-box x^5 is exactly the q_hash gate
    (reference src/dispatcher2.rs:469-473), and the inverse S-box
    x^(1/5) is one gate run backwards (witness the root, enforce the power).
  - state width m = 4 = GATE_WIDTH: one MDS row spans one gate's four
    input wires, so a full affine layer is 4 gates.
  - capacity 1, rate 3: a 3-ary Merkle node (two siblings + child) or a
    (leaf-index, payload, domain-tag) triple absorbs in a single permutation.

Round constants and the MDS matrix are derived deterministically from
SHAKE-256 (nothing-up-my-sleeve, as in the Rescue-Prime reference code).
In-circuit cost: 12 gates/round, 144 gates/permutation - the same order as
the reference's stated 157 constraints per Merkle level
(reference src/dispatcher.rs:1068-1070).
"""

import hashlib

from .constants import R_MOD

STATE_WIDTH = 4
RATE = 3
CAPACITY = 1
ALPHA = 5
ALPHA_INV = pow(ALPHA, -1, R_MOD - 1)
NUM_ROUNDS = 12  # jf-primitives' ROUNDS for the width-4 BLS12-381 instance

_FR_BYTES = 32


def _shake_field_elements(tag, count):
    """Deterministic field elements: SHAKE-256(tag), rejection-free
    reduction of 512-bit draws (bias < 2^-257)."""
    out = []
    shake = hashlib.shake_256(tag.encode())
    stream = shake.digest(count * 2 * _FR_BYTES)
    for i in range(count):
        chunk = stream[i * 2 * _FR_BYTES:(i + 1) * 2 * _FR_BYTES]
        out.append(int.from_bytes(chunk, "little") % R_MOD)
    return out


def _derive_mds():
    """4x4 Cauchy matrix M[i][j] = 1/(x_i + y_j): MDS whenever the x_i and
    y_j are distinct and all sums nonzero (every square submatrix of a
    Cauchy matrix is invertible)."""
    attempt = 0
    while True:
        # attempt counter in the tag: every retry draws fresh elements
        # (a fixed tag would loop forever if the first draw ever failed)
        elems = _shake_field_elements(
            f"dpt-rescue-mds-v1-{attempt}", 2 * STATE_WIDTH)
        xs, ys = elems[:STATE_WIDTH], elems[STATE_WIDTH:]
        if len(set(xs)) == STATE_WIDTH and len(set(ys)) == STATE_WIDTH and all(
                (x + y) % R_MOD != 0 for x in xs for y in ys):
            break
        attempt += 1
    return [[pow((x + y) % R_MOD, -1, R_MOD) for y in ys] for x in xs]


MDS = _derive_mds()
# 2 injections per round (after each half-round) + 1 pre-round injection
ROUND_KEYS = [
    _shake_field_elements(f"dpt-rescue-rk-v1-{k}", STATE_WIDTH)
    for k in range(2 * NUM_ROUNDS + 1)
]


def _affine(state, key):
    return [
        (sum(MDS[i][j] * state[j] for j in range(STATE_WIDTH)) + key[i]) % R_MOD
        for i in range(STATE_WIDTH)
    ]


def permutation(state):
    """The Rescue-Prime permutation on a 4-element Fr state."""
    assert len(state) == STATE_WIDTH
    state = [(ROUND_KEYS[0][i] + state[i]) % R_MOD for i in range(STATE_WIDTH)]
    for r in range(NUM_ROUNDS):
        state = [pow(x, ALPHA, R_MOD) for x in state]
        state = _affine(state, ROUND_KEYS[2 * r + 1])
        state = [pow(x, ALPHA_INV, R_MOD) for x in state]
        state = _affine(state, ROUND_KEYS[2 * r + 2])
    return state


def hash3(a, b, c):
    """Fixed-length 3-to-1 sponge: absorb (a,b,c) into the rate, one
    permutation, squeeze state[0]."""
    return permutation([a % R_MOD, b % R_MOD, c % R_MOD, 0])[0]


_SPONGE_IV = 2  # capacity-element IV: domain-separates the variable-length
# sponge from hash3 (capacity 0), so sponge([a,b]) can never collide with a
# fixed-length digest like leaf/node hashes


def sponge(inputs):
    """Variable-length sponge (rate 3, 10* zero-padding to a rate multiple,
    nonzero capacity IV for domain separation from hash3)."""
    data = [x % R_MOD for x in inputs] + [1]
    while len(data) % RATE:
        data.append(0)
    state = [0] * RATE + [_SPONGE_IV]
    for off in range(0, len(data), RATE):
        for i in range(RATE):
            state[i] = (state[i] + data[off + i]) % R_MOD
        state = permutation(state)
    return state[0]


# --- in-circuit gadgets ------------------------------------------------------

def permutation_gadget(cs, state_vars):
    """In-circuit Rescue-Prime permutation: 12 gates/round.

    Forward half-round: S-box + MDS row + round key fuse into ONE
    pow5_lc_with_const gate per output element (4 gates). Inverse
    half-round: 4 root5 gates (x^(1/5) witnessed, x^5 enforced) + 4
    lc_with_const gates for the affine layer.
    """
    assert len(state_vars) == STATE_WIDTH
    state_vars = [
        cs.add_constant(state_vars[i], ROUND_KEYS[0][i])
        for i in range(STATE_WIDTH)
    ]
    for r in range(NUM_ROUNDS):
        key1 = ROUND_KEYS[2 * r + 1]
        state_vars = [
            cs.pow5_lc_with_const(state_vars, MDS[i], key1[i])
            for i in range(STATE_WIDTH)
        ]
        roots = [cs.root5(v) for v in state_vars]
        key2 = ROUND_KEYS[2 * r + 2]
        state_vars = [
            cs.lc_with_const(roots, MDS[i], key2[i])
            for i in range(STATE_WIDTH)
        ]
    return state_vars


def hash3_gadget(cs, a, b, c):
    """In-circuit fixed-length 3-to-1 hash matching hash3()."""
    out_state = permutation_gadget(cs, [a, b, c, cs.zero_var])
    return out_state[0]
