"""TurboPlonk constraint system (5 wire types, 13 selectors).

Re-provides the jf-plonk circuit surface the reference consumes through
`Arithmetization` (reference src/dispatcher2.rs:171-186 exposes the
fields: wire_variables, witness, wire_permutation, extended_id_permutation,
pub_input_gate_ids, eval_domain). Gate semantics follow the reference's
quotient formula (reference src/dispatcher2.rs:434-504):

    q_c + PI
      + q_lc0*a + q_lc1*b + q_lc2*c + q_lc3*d
      + q_mul0*(a*b) + q_mul1*(c*d)
      + q_ecc*(a*b*c*d*e)
      + q_hash0*a^5 + q_hash1*b^5 + q_hash2*c^5 + q_hash3*d^5
      - q_o*e  == 0        on every row of the evaluation domain.

Selector order (matches prove_key.selectors indexing in the reference):
    [q_lc0..3, q_mul0, q_mul1, q_hash0..3, q_o, q_c, q_ecc]   (13 total)
"""

from .constants import R_MOD, FR_GENERATOR
from .poly import Domain

GATE_WIDTH = 4  # fan-in; wire types = GATE_WIDTH + 1 (4 inputs + 1 output)
NUM_WIRE_TYPES = 5
NUM_SELECTORS = 2 * GATE_WIDTH + 5  # 13

# selector indices
Q_LC = 0          # ..3
Q_MUL = 4         # ..5
Q_HASH = 6        # ..9
Q_O = 10
Q_C = 11
Q_ECC = 12

_INV_5 = pow(5, -1, R_MOD - 1)  # x -> x^(1/5) exponent (gcd(5, r-1) = 1)


def coset_representatives(num):
    """Wire-subset separators k_0=1, k_i = g^i (g = 7, a primitive root).

    k_i/k_j = g^(i-j) lies in the order-2^s FFT subgroup only if its order
    divides 2^s; ord(g^d) = (r-1)/gcd(d, r-1) keeps the odd part of r-1 for
    0 < d < 5, so the five cosets k_i * H are pairwise disjoint.
    """
    ks = [1]
    cur = 1
    for _ in range(1, num):
        cur = cur * FR_GENERATOR % R_MOD
        ks.append(cur)
    return ks


class PlonkCircuit:
    """Mutable TurboPlonk circuit builder + finalized arithmetization."""

    def __init__(self):
        self.witness = []           # variable values
        self.wire_variables = [[] for _ in range(NUM_WIRE_TYPES)]
        self.selectors = [[] for _ in range(NUM_SELECTORS)]
        self.pub_input_gate_ids = []
        self.pub_inputs = []
        self._finalized = False
        # constant variables 0 and 1, constrained by gates
        self.zero_var = self.create_variable(0)
        self._constant_gate(self.zero_var, 0)
        self.one_var = self.create_variable(1)
        self._constant_gate(self.one_var, 1)

    # --- variables -----------------------------------------------------------

    def create_variable(self, value):
        assert not self._finalized
        self.witness.append(value % R_MOD)
        return len(self.witness) - 1

    def create_public_variable(self, value):
        v = self.create_variable(value)
        self.set_public(v)
        return v

    def set_public(self, var):
        """Add an IO gate exposing `var` as a public input (q_o = 1, PI row)."""
        gid = self._add_gate(
            [self.zero_var] * GATE_WIDTH + [var],
            {Q_O: 1},
        )
        self.pub_input_gate_ids.append(gid)
        self.pub_inputs.append(self.witness[var])

    # --- gates ---------------------------------------------------------------

    def _add_gate(self, wires, sel):
        assert len(wires) == NUM_WIRE_TYPES
        for i in range(NUM_WIRE_TYPES):
            self.wire_variables[i].append(wires[i])
        for i in range(NUM_SELECTORS):
            self.selectors[i].append(sel.get(i, 0) % R_MOD)
        return len(self.wire_variables[0]) - 1

    def _constant_gate(self, var, value):
        # q_c + PI - q_o*e = 0 with q_o=1, q_c=value -> e == value
        self._add_gate([self.zero_var] * GATE_WIDTH + [var], {Q_O: 1, Q_C: value})

    def add_constant_gate(self, var, value):
        self._constant_gate(var, value)

    def add(self, a, b):
        out = self.create_variable(self.witness[a] + self.witness[b])
        self._add_gate([a, b, self.zero_var, self.zero_var, out], {Q_LC: 1, Q_LC + 1: 1, Q_O: 1})
        return out

    def sub(self, a, b):
        out = self.create_variable(self.witness[a] - self.witness[b])
        self._add_gate([a, b, self.zero_var, self.zero_var, out],
                       {Q_LC: 1, Q_LC + 1: R_MOD - 1, Q_O: 1})
        return out

    def mul(self, a, b):
        out = self.create_variable(self.witness[a] * self.witness[b])
        self._add_gate([a, b, self.zero_var, self.zero_var, out], {Q_MUL: 1, Q_O: 1})
        return out

    def lc(self, vars4, coeffs4):
        """out = sum coeffs4[i] * vars4[i]."""
        val = sum(c * self.witness[v] for v, c in zip(vars4, coeffs4))
        out = self.create_variable(val)
        sel = {Q_LC + i: coeffs4[i] % R_MOD for i in range(4)}
        sel[Q_O] = 1
        self._add_gate(list(vars4) + [out], sel)
        return out

    def add_constant(self, a, const):
        out = self.create_variable(self.witness[a] + const)
        self._add_gate([a, self.zero_var, self.zero_var, self.zero_var, out],
                       {Q_LC: 1, Q_C: const % R_MOD, Q_O: 1})
        return out

    def mul_constant(self, a, const):
        out = self.create_variable(self.witness[a] * const)
        self._add_gate([a, self.zero_var, self.zero_var, self.zero_var, out],
                       {Q_LC: const % R_MOD, Q_O: 1})
        return out

    def power5(self, a):
        """out = a^5 via the dedicated hash selector (one gate)."""
        out = self.create_variable(pow(self.witness[a], 5, R_MOD))
        self._add_gate([a, self.zero_var, self.zero_var, self.zero_var, out],
                       {Q_HASH: 1, Q_O: 1})
        return out

    def root5(self, a):
        """out with out^5 == a (one gate, S-box run backwards: the witness
        carries the 5th root, the q_hash selector enforces the power)."""
        out = self.create_variable(pow(self.witness[a], _INV_5, R_MOD))
        self._add_gate([out, self.zero_var, self.zero_var, self.zero_var, a],
                       {Q_HASH: 1, Q_O: 1})
        return out

    def lc_with_const(self, vars4, coeffs4, const):
        """out = sum coeffs4[i]*vars4[i] + const (one gate)."""
        val = sum(c * self.witness[v] for v, c in zip(vars4, coeffs4)) + const
        out = self.create_variable(val)
        sel = {Q_LC + i: coeffs4[i] % R_MOD for i in range(4)}
        sel[Q_C] = const % R_MOD
        sel[Q_O] = 1
        self._add_gate(list(vars4) + [out], sel)
        return out

    def pow5_lc_with_const(self, vars4, coeffs4, const):
        """out = sum coeffs4[i]*vars4[i]^5 + const (one gate).

        The TurboPlonk hash selectors q_hash0..3 weight the 5th powers of all
        four input wires, so a Rescue forward half-round's S-box + one MDS row
        + round constant fuse into a single gate (the gate shape jf-plonk's
        RescueGadget was built around; cf. the q_hash terms of the quotient
        formula at reference src/dispatcher2.rs:469-473)."""
        val = sum(c * pow(self.witness[v], 5, R_MOD)
                  for v, c in zip(vars4, coeffs4)) + const
        out = self.create_variable(val)
        sel = {Q_HASH + i: coeffs4[i] % R_MOD for i in range(4)}
        sel[Q_C] = const % R_MOD
        sel[Q_O] = 1
        self._add_gate(list(vars4) + [out], sel)
        return out

    def mul_add(self, a, b, c, d):
        """out = a*b + c*d (one gate via the two q_mul selectors)."""
        out = self.create_variable(
            self.witness[a] * self.witness[b] + self.witness[c] * self.witness[d])
        self._add_gate([a, b, c, d, out], {Q_MUL: 1, Q_MUL + 1: 1, Q_O: 1})
        return out

    def enforce_bool(self, a):
        """Constrain a in {0,1}: a*a - a == 0 (one gate)."""
        self._add_gate([a, a, self.zero_var, self.zero_var, self.zero_var],
                       {Q_MUL: 1, Q_LC: R_MOD - 1})

    def enforce_equal(self, a, b):
        self._add_gate([a, b, self.zero_var, self.zero_var, self.zero_var],
                       {Q_LC: 1, Q_LC + 1: R_MOD - 1})

    def enforce_ecc_product(self, a, b, c, d, e, k):
        """Native q_ecc gate: constrain a*b*c*d*e == k (single row).

        The 5th factor rides the output wire; the q_ecc selector contributes
        the full 5-way product additively, balanced by the constant.
        """
        self._add_gate([a, b, c, d, e], {Q_ECC: 1, Q_C: (-k) % R_MOD})

    def check_satisfiability(self):
        """Debug oracle: every gate constraint holds on the raw witness."""
        n = len(self.wire_variables[0])
        pi_by_gate = dict(zip(self.pub_input_gate_ids, self.pub_inputs))
        for j in range(n):
            w = [self.witness[self.wire_variables[i][j]] for i in range(NUM_WIRE_TYPES)]
            a, b, c, d, e = w
            s = lambda k: self.selectors[k][j]  # noqa: E731
            pi = pi_by_gate.get(j, 0)
            val = (
                s(Q_C) + pi
                + s(Q_LC) * a + s(Q_LC + 1) * b + s(Q_LC + 2) * c + s(Q_LC + 3) * d
                + s(Q_MUL) * (a * b) + s(Q_MUL + 1) * (c * d)
                + s(Q_ECC) * (a * b % R_MOD * c % R_MOD * d % R_MOD * e)
                + s(Q_HASH) * pow(a, 5, R_MOD) + s(Q_HASH + 1) * pow(b, 5, R_MOD)
                + s(Q_HASH + 2) * pow(c, 5, R_MOD) + s(Q_HASH + 3) * pow(d, 5, R_MOD)
                - s(Q_O) * e
            ) % R_MOD
            if val != 0:
                return False, j
        return True, -1

    # --- finalization --------------------------------------------------------

    @property
    def num_gates(self):
        return len(self.wire_variables[0])

    @property
    def num_vars(self):
        return len(self.witness)

    @property
    def num_inputs(self):
        return len(self.pub_input_gate_ids)

    def finalize(self):
        """Rearrange IO gates to the first rows, pad to a power of two,
        and compute the permutation tables. Mirrors jf-plonk's
        finalize_for_arithmetization (consumed by the reference at
        reference src/dispatcher2.rs:248)."""
        assert not self._finalized
        # 1. move IO gates to rows 0..num_inputs-1 (stable order)
        order = list(self.pub_input_gate_ids)
        io_set = set(order)
        order += [j for j in range(self.num_gates) if j not in io_set]
        for i in range(NUM_WIRE_TYPES):
            self.wire_variables[i] = [self.wire_variables[i][j] for j in order]
        for k in range(NUM_SELECTORS):
            self.selectors[k] = [self.selectors[k][j] for j in order]
        self.pub_input_gate_ids = list(range(len(self.pub_input_gate_ids)))

        # 2. pad to power of two (strictly greater so z-poly row n-1 is free)
        n = 1
        while n < self.num_gates + 1:
            n <<= 1
        pad = n - self.num_gates
        for i in range(NUM_WIRE_TYPES):
            self.wire_variables[i] += [self.zero_var] * pad
        for k in range(NUM_SELECTORS):
            self.selectors[k] += [0] * pad

        self.eval_domain = Domain(n)
        self.n = n
        self._finalized = True

        # 3. permutation tables
        self.k = coset_representatives(NUM_WIRE_TYPES)
        # extended id: id[i][j] = k_i * w^j
        powers = list(self.eval_domain.elements())
        self.extended_id_permutation = [
            [self.k[i] * powers[j] % R_MOD for j in range(n)]
            for i in range(NUM_WIRE_TYPES)
        ]
        # wire_permutation: cyclic right-shift within each variable's slots
        positions = {}
        for i in range(NUM_WIRE_TYPES):
            for j in range(n):
                positions.setdefault(self.wire_variables[i][j], []).append((i, j))
        self.wire_permutation = [[None] * n for _ in range(NUM_WIRE_TYPES)]
        for var, slots in positions.items():
            m = len(slots)
            for t, (i, j) in enumerate(slots):
                self.wire_permutation[i][j] = slots[(t + 1) % m]
        return self

    def sigma_values(self):
        """sigma_i(w^j) = extended_id[perm(i, j)] for the 5 sigma polys."""
        assert self._finalized
        out = []
        for i in range(NUM_WIRE_TYPES):
            row = []
            for j in range(self.n):
                pi, pj = self.wire_permutation[i][j]
                row.append(self.extended_id_permutation[pi][pj])
            out.append(row)
        return out

    def public_input(self):
        assert self._finalized
        return list(self.pub_inputs)

    def wire_values(self, i):
        """Evaluations of wire polynomial i over the domain."""
        assert self._finalized
        return [self.witness[v] for v in self.wire_variables[i]]
