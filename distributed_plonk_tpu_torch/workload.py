"""Benchmark workload: Merkle-membership circuit generator.

Re-expresses the reference's `generate_circuit`
(reference src/dispatcher.rs:1063-1116 and
reference src/dispatcher2.rs:1218-1271) for the new frontend: build a
3-ary Rescue Merkle tree, then a TurboPlonk circuit proving membership of
`num_proofs` elements, root(s) exposed as public input. The reference's
scales: height 32 with 1 proof (v1, ~2^13 domain) and 50 proofs (v2,
~2^18 domain); cost model `num_proofs * (157*height + 149)` constraints
(reference src/dispatcher.rs:1068-1070) — ours lands within a few
percent (permutation 148 + selection ~11 gates per level).
"""

import random

from .circuit import PlonkCircuit
from .constants import R_MOD
from . import merkle


def generate_circuit(rng=None, height=32, num_proofs=1, num_leaves=None):
    """Build (circuit, tree): `num_proofs` in-circuit membership checks
    against one tree, root public. Mirrors the reference's workload shape
    (uid = leaf index, elem = random payload)."""
    rng = rng or random.Random(0)
    if num_leaves is None:
        num_leaves = max(num_proofs, 3)
    payloads = [rng.randrange(R_MOD) for _ in range(num_leaves)]
    tree = merkle.MerkleTree(payloads, height=height)

    cs = PlonkCircuit()
    root_var = cs.create_public_variable(tree.root)
    for k in range(num_proofs):
        idx = k % num_leaves
        proof = tree.open(idx)
        assert proof.verify(tree.root)
        payload_var = cs.create_variable(proof.payload)
        computed_root = merkle.membership_gadget(cs, idx, payload_var, proof)
        cs.enforce_equal(computed_root, root_var)
    ok, bad = cs.check_satisfiability()
    assert ok, f"workload circuit unsatisfied at gate {bad}"
    return cs.finalize(), tree
