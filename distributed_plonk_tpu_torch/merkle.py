"""3-ary Rescue Merkle tree + membership proofs, native and in-circuit.

Re-provides the `jf-primitives` MerkleTree surface the reference's workload
generator consumes (reference src/dispatcher.rs:1076-1096 builds a
height-32 tree and pulls per-element membership proofs;
reference src/dispatcher.rs:1097-1108 verifies them in-circuit via
MerkleTreeGadget). Same shape: branching factor 3 (the Rescue rate), sparse
tree addressed by u64 leaf index, leaf digest = H(index, payload, tag).

The in-circuit path verifier costs ~159 gates per level (148 for the
permutation + 11 for position selection: 3 enforce_bool + one-hot lc +
enforce_equal + 6 in _select3, the same count workload.py's cost model
uses), matching the order of the reference's stated cost model
`num_proofs * (157*height + 149)`
(reference src/dispatcher.rs:1068-1070).
"""

from .constants import R_MOD
from . import rescue

BRANCH = 3
LEAF_TAG = 1  # domain separator: leaf digests vs internal nodes


def leaf_digest(index, payload):
    return rescue.hash3(index, payload, LEAF_TAG)


def node_digest(children):
    assert len(children) == BRANCH
    return rescue.hash3(*children)


class MerkleTree:
    """Dense bottom-up 3-ary tree over a list of payloads.

    Supports the reference workload's access pattern: build once from a
    vector of leaves, read the root, open membership proofs by index.
    """

    def __init__(self, payloads, height=None):
        self.payloads = [p % R_MOD for p in payloads]
        n = max(1, len(self.payloads))
        h = 1
        while BRANCH ** h < n:
            h += 1
        if height is not None:
            assert BRANCH ** height >= n, "height too small for leaf count"
            h = height
        self.height = h
        level = [leaf_digest(i, p) for i, p in enumerate(self.payloads)]
        # levels[0] = leaf digests, levels[-1] = [root]
        self.levels = [level]
        empty = 0  # digest standing in for absent children
        for _ in range(h):
            level = level + [empty] * ((-len(level)) % BRANCH)
            nxt = [node_digest(level[i:i + BRANCH])
                   for i in range(0, len(level), BRANCH)]
            self.levels.append(nxt)
            level = nxt
        assert len(self.levels[-1]) == 1

    @property
    def root(self):
        return self.levels[-1][0]

    def open(self, index):
        """Membership proof: per level bottom-up, (position in {0,1,2},
        the two sibling digests left-to-right)."""
        assert 0 <= index < len(self.payloads)
        path = []
        idx = index
        for lvl in range(self.height):
            pos = idx % BRANCH
            base = idx - pos
            row = self.levels[lvl]
            sibs = [row[base + j] if base + j < len(row) else 0
                    for j in range(BRANCH) if j != pos]
            path.append((pos, sibs))
            idx //= BRANCH
        return MerkleProof(index, self.payloads[index], path)


class MerkleProof:
    def __init__(self, index, payload, path):
        self.index = index
        self.payload = payload
        self.path = path  # [(pos, [sib0, sib1])] bottom-up

    def verify(self, root):
        cur = leaf_digest(self.index, self.payload)
        for pos, sibs in self.path:
            children = list(sibs)
            children.insert(pos, cur)
            cur = node_digest(children)
        return cur == root


# --- in-circuit membership gadget --------------------------------------------

def _select3(cs, cur, sibs, b):
    """Arrange (cur, sibs[0], sibs[1]) into 3 child slots according to the
    one-hot position bits b = (b0, b1, b2): pos 0 -> (cur, s0, s1),
    pos 1 -> (s0, cur, s1), pos 2 -> (s0, s1, cur). 6 gates."""
    s0, s1 = sibs
    # slot0 = b0*(cur - s0) + s0
    d0 = cs.sub(cur, s0)
    slot0 = cs.mul_add(b[0], d0, s0, cs.one_var)
    # slot1 = b1*cur + b0*s0 + b2*s1
    t = cs.mul_add(b[1], cur, b[0], s0)
    slot1 = cs.mul_add(b[2], s1, t, cs.one_var)
    # slot2 = b2*(cur - s1) + s1
    d1 = cs.sub(cur, s1)
    slot2 = cs.mul_add(b[2], d1, s1, cs.one_var)
    return slot0, slot1, slot2


def membership_gadget(cs, index, payload_var, proof):
    """Verify a MerkleProof in-circuit; returns the computed root variable.

    Position bits are private witnesses, constrained boolean and one-hot per
    level (the index itself never needs range decomposition beyond that).
    """
    idx_var = cs.create_variable(index)
    cs.add_constant_gate(idx_var, index)  # bind the claimed leaf index
    cur = rescue.hash3_gadget(cs, idx_var, payload_var, cs.one_var)
    for pos, sibs in proof.path:
        b = [cs.create_variable(1 if pos == j else 0) for j in range(BRANCH)]
        for bj in b:
            cs.enforce_bool(bj)
        # one-hot: b0 + b1 + b2 == 1
        cs.enforce_equal(
            cs.lc([b[0], b[1], b[2], cs.zero_var], [1, 1, 1, 0]), cs.one_var)
        sib_vars = [cs.create_variable(s) for s in sibs]
        slots = _select3(cs, cur, sib_vars, b)
        cur = rescue.hash3_gadget(cs, *slots)
    return cur
