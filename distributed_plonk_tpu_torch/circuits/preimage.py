"""Rescue-hash preimage circuits: knowledge of (x, y, z) with
H(x, y, z) = digest, digest public.

One rescue.hash3_gadget per statement — a single width-4 Rescue-Prime
permutation, ~148 q_hash-dominated gates — with the computed digest
exposed as a public input. The preimage triple stays private (plain
witness variables, never IO rows). This is the pure-hash end of the zoo's
selector spectrum: essentially every gate row carries q_hash weight,
which stresses the selector-commitment path the lc-heavy `range` family
barely touches.
"""

import random

from ..circuit import PlonkCircuit
from ..constants import R_MOD
from .. import rescue

MAX_COUNT = 256


def validate(obj):
    count = obj.get("count", 1)
    if not isinstance(count, int) or not 1 <= count <= MAX_COUNT:
        raise ValueError(f"preimage spec needs 1 <= count <= {MAX_COUNT}")
    return {"count": count}


def build(params, seed):
    rng = random.Random(seed)
    cs = PlonkCircuit()
    for _ in range(params["count"]):
        x, y, z = (rng.randrange(R_MOD) for _ in range(3))
        xv, yv, zv = (cs.create_variable(v) for v in (x, y, z))
        digest_var = rescue.hash3_gadget(cs, xv, yv, zv)
        assert cs.witness[digest_var] == rescue.hash3(x, y, z)
        cs.set_public(digest_var)
    ok, bad = cs.check_satisfiability()
    assert ok, f"preimage circuit unsatisfied at gate {bad}"
    return cs.finalize()
