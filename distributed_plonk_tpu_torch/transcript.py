"""Fiat-Shamir transcript: Keccak-f[1600] + STROBE-128 + merlin clone.

The reference drives Fiat-Shamir through `merlin::Transcript` 3.0 wrapped in
`FakeStandardTranscript` (reference src/dispatcher2.rs:44-154), which
byte-for-byte reproduces jf-plonk's `StandardTranscript`. For proofs to be
byte-identical with the reference, this module re-implements that stack from
the public specifications:

  * Keccak-f[1600] permutation (FIPS 202) - self-tested against hashlib's
    SHA3 by tests/test_transcript.py.
  * STROBE-128 lite (exactly the subset merlin implements: AD / META-AD /
    PRF over keccak-f[1600], rate 166).
  * merlin's framing: protocol label "Merlin v1.0", dom-sep on new(),
    append_message/challenge_bytes with u32-LE length meta-AD.
  * jf-plonk's StandardTranscript message schedule (labels and arkworks
    CanonicalSerialize byte layouts).
"""

MASK64 = (1 << 64) - 1

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets, indexed [x + 5*y]
_KECCAK_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rol64(v, n):
    n %= 64
    return ((v << n) | (v >> (64 - n))) & MASK64


def keccak_f1600(lanes):
    """In-place-style permutation over 25 64-bit lanes (A[x + 5y])."""
    A = list(lanes)
    for rnd in range(24):
        # theta
        C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rol64(C[(x + 1) % 5], 1) for x in range(5)]
        A = [A[i] ^ D[i % 5] for i in range(25)]
        # rho + pi: B[y + 5*((2x+3y)%5)] = rol(A[x + 5y], rot[x + 5y])
        B = [0] * 25
        for x in range(5):
            for y in range(5):
                B[y + 5 * ((2 * x + 3 * y) % 5)] = _rol64(A[x + 5 * y], _KECCAK_ROT[x + 5 * y])
        # chi
        A = [B[x + 5 * y] ^ ((~B[(x + 1) % 5 + 5 * y] & MASK64) & B[(x + 2) % 5 + 5 * y])
             for y in range(5) for x in range(5)]
        # iota
        A[0] ^= _KECCAK_RC[rnd]
    return A


def keccak_f1600_bytes(state):
    """Permute a 200-byte state (little-endian lanes)."""
    lanes = [int.from_bytes(state[8 * i:8 * i + 8], "little") for i in range(25)]
    lanes = keccak_f1600(lanes)
    out = bytearray(200)
    for i, lane in enumerate(lanes):
        out[8 * i:8 * i + 8] = lane.to_bytes(8, "little")
    return out


# --- STROBE-128 (the merlin-internal subset) ---------------------------------

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    def __init__(self, protocol_label):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.state = keccak_f1600_bytes(st)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        self.state = keccak_f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data):
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n):
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags, more):
        if more:
            assert flags == self.cur_flags, "flag mismatch on continued op"
            return
        assert flags & FLAG_T == 0, "transport flags unsupported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = flags & (FLAG_C | FLAG_K) != 0
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data, more):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data, more):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n, more=False):
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)


# --- merlin Transcript -------------------------------------------------------

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class MerlinTranscript:
    def __init__(self, label):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label, message):
        data_len = len(message).to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label, n):
        data_len = n.to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        return self.strobe.prf(n)


# --- arkworks-style serialization (for transcript + proofs) ------------------

from .constants import R_MOD, Q_MOD  # noqa: E402


def fr_to_bytes(x):
    """ark CanonicalSerialize of Fr: 32 bytes LE of the canonical integer."""
    return (x % R_MOD).to_bytes(32, "little")


def fr_from_le_bytes_mod_order(b):
    return int.from_bytes(b, "little") % R_MOD


def g1_to_bytes_compressed(p):
    """ark 0.3 compressed G1: 48 bytes LE x, flags in the top byte.

    bit 6 of byte[47]: infinity; bit 7: y is the lexicographically
    larger root ("positive", i.e. y > q - y).
    """
    if p is None:
        b = bytearray(48)
        b[47] |= 1 << 6
        return bytes(b)
    x, y = p
    b = bytearray(x.to_bytes(48, "little"))
    if y > Q_MOD - y:
        b[47] |= 1 << 7
    return bytes(b)


def g2_to_bytes_compressed(p):
    """ark 0.3 compressed G2: 96 bytes (c0 then c1 of x, LE), flags in top byte."""
    if p is None:
        b = bytearray(96)
        b[95] |= 1 << 6
        return bytes(b)
    (x0, x1), (y0, y1) = p
    b = bytearray(x0.to_bytes(48, "little") + x1.to_bytes(48, "little"))
    # y sign: lexicographic comparison (c1, then c0) against its negation
    ny0, ny1 = (Q_MOD - y0) % Q_MOD, (Q_MOD - y1) % Q_MOD
    if (y1, y0) > (ny1, ny0):
        b[95] |= 1 << 7
    return bytes(b)


# --- jf-plonk StandardTranscript schedule ------------------------------------

class StandardTranscript:
    """Byte-compatible clone of jf-plonk's StandardTranscript.

    Message schedule mirrors FakeStandardTranscript
    (reference src/dispatcher2.rs:44-154).
    """

    def __init__(self):
        self.t = MerlinTranscript(b"PlonkProof")

    def append_vk_and_pub_input(self, vk, pub_input):
        self.t.append_message(b"field size in bits", (255).to_bytes(8, "little"))
        self.t.append_message(b"domain size", vk.domain_size.to_bytes(8, "little"))
        self.t.append_message(b"input size", vk.num_inputs.to_bytes(8, "little"))
        for ki in vk.k:
            self.t.append_message(b"wire subsets separators", fr_to_bytes(ki))
        for comm in vk.selector_comms:
            self.t.append_message(b"selector commitments", g1_to_bytes_compressed(comm))
        for comm in vk.sigma_comms:
            self.t.append_message(b"sigma commitments", g1_to_bytes_compressed(comm))
        for x in pub_input:
            self.t.append_message(b"public input", fr_to_bytes(x))

    def append_commitment(self, label, comm):
        self.t.append_message(label, g1_to_bytes_compressed(comm))

    def append_commitments(self, label, comms):
        for c in comms:
            self.append_commitment(label, c)

    def append_proof_evaluations(self, wires_evals, wire_sigma_evals, perm_next_eval):
        for w in wires_evals:
            self.t.append_message(b"wire_evals", fr_to_bytes(w))
        for s in wire_sigma_evals:
            self.t.append_message(b"wire_sigma_evals", fr_to_bytes(s))
        self.t.append_message(b"perm_next_eval", fr_to_bytes(perm_next_eval))

    def get_and_append_challenge(self, label):
        buf = self.t.challenge_bytes(label, 64)
        challenge = fr_from_le_bytes_mod_order(buf)
        self.t.append_message(label, fr_to_bytes(challenge))
        return challenge
