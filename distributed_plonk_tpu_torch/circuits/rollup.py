"""Rollup-style state-transition batch: the zoo's flagship shape.

M account-balance updates applied in sequence under one 3-ary Rescue
Merkle root, proven in ONE circuit: the pre-batch root and the
post-batch root are the only public inputs, and every intermediate
transition is enforced in-circuit — for each update, membership of the
old balance under the current root AND correctness of the new root after
writing `old + delta` back into the same leaf slot. The host-side
MerkleTree is purely a witness oracle (paths, siblings, expected roots);
nothing it produces is trusted by the circuit beyond the two public
roots.

The update gadget is the cost win over two independent membership proofs:
the position bits, their boolean/one-hot constraints, and the sibling
witnesses are SHARED between the old-root and new-root recomputations
(only the two Rescue chains differ), ~2x148 gates per level instead of
2x159. Per update: 2(H+1) Rescue permutations + selection ≈ 310(H+1)
gates, so even the small test shapes land in the multi-thousand-gate
domains the schedulers' flagship SLO class is meant to carry.
"""

import random

from ..circuit import PlonkCircuit
from ..constants import R_MOD
from .. import merkle, rescue

MAX_HEIGHT = 16
MAX_UPDATES = 64


def validate(obj):
    height = obj.get("height")
    if not isinstance(height, int) or not 1 <= height <= MAX_HEIGHT:
        raise ValueError(f"rollup spec needs 1 <= height <= {MAX_HEIGHT}")
    updates = obj.get("updates", 1)
    if not isinstance(updates, int) or not 1 <= updates <= MAX_UPDATES:
        raise ValueError(f"rollup spec needs 1 <= updates <= {MAX_UPDATES}")
    cap = merkle.BRANCH ** height
    num_accounts = obj.get("num_accounts")
    if num_accounts is None:
        num_accounts = min(cap, max(updates, 2))
    if not isinstance(num_accounts, int) or not 1 <= num_accounts <= cap:
        raise ValueError(
            f"rollup spec needs 1 <= num_accounts <= 3^height ({cap})")
    return {"height": height, "updates": updates,
            "num_accounts": num_accounts}


def _update_gadget(cs, index, old_payload_var, new_payload_var, path):
    """Recompute the root twice from one leaf slot — once with the old
    payload, once with the new — sharing the position bits (boolean +
    one-hot constrained) and sibling witnesses between the two chains.
    `path` holds the PRE-update siblings; returns (old_root, new_root)
    variables."""
    idx_var = cs.create_variable(index)
    cs.add_constant_gate(idx_var, index)
    old_cur = rescue.hash3_gadget(cs, idx_var, old_payload_var, cs.one_var)
    new_cur = rescue.hash3_gadget(cs, idx_var, new_payload_var, cs.one_var)
    for pos, sibs in path:
        b = [cs.create_variable(1 if pos == j else 0)
             for j in range(merkle.BRANCH)]
        for bj in b:
            cs.enforce_bool(bj)
        cs.enforce_equal(
            cs.lc([b[0], b[1], b[2], cs.zero_var], [1, 1, 1, 0]), cs.one_var)
        sib_vars = [cs.create_variable(s) for s in sibs]
        old_cur = rescue.hash3_gadget(
            cs, *merkle._select3(cs, old_cur, sib_vars, b))
        new_cur = rescue.hash3_gadget(
            cs, *merkle._select3(cs, new_cur, sib_vars, b))
    return old_cur, new_cur


def build(params, seed):
    height = params["height"]
    updates = params["updates"]
    num_accounts = params["num_accounts"]
    rng = random.Random(seed)

    balances = [rng.randrange(R_MOD) for _ in range(num_accounts)]
    tree = merkle.MerkleTree(balances, height=height)

    cs = PlonkCircuit()
    cur_root_var = cs.create_public_variable(tree.root)
    for m in range(updates):
        # account choice is structural (m % num_accounts, like the merkle
        # workload's leaf indices): same params -> same paths -> same wiring
        account = m % num_accounts
        proof = tree.open(account)
        delta = rng.randrange(R_MOD)
        old_var = cs.create_variable(proof.payload)
        delta_var = cs.create_variable(delta)
        new_var = cs.add(old_var, delta_var)
        old_root, new_root = _update_gadget(
            cs, account, old_var, new_var, proof.path)
        cs.enforce_equal(old_root, cur_root_var)
        cur_root_var = new_root
        # advance the witness oracle and cross-check the in-circuit root
        balances[account] = (balances[account] + delta) % R_MOD
        tree = merkle.MerkleTree(balances, height=height)
        assert cs.witness[new_root] == tree.root
    cs.set_public(cur_root_var)

    ok, bad = cs.check_satisfiability()
    assert ok, f"rollup circuit unsatisfied at gate {bad}"
    return cs.finalize()
