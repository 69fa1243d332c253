"""Range-check circuits: prove `count` public values lie in [0, 2^bits).

The classic bit-decomposition gadget on the TurboPlonk gate set: each
value is decomposed into `bits` private bit witnesses, every bit is
constrained boolean (enforce_bool, one q_mul gate each), and the bits
are recomposed back to the public value through a chain of 4-input
linear-combination gates (3 bits + the running accumulator per gate, so
ceil(bits/3) lc gates per value). Cost: count * (bits + ceil(bits/3) + 2)
gates plus the IO rows — a deliberately lc/mul-heavy selector profile,
the opposite end of the spectrum from the q_hash-dominated Rescue
families, so shape buckets of equal domain size but different kind carry
genuinely different selector polynomials.
"""

import random

from ..circuit import PlonkCircuit

MAX_BITS = 64
MAX_COUNT = 512


def validate(obj):
    bits = obj.get("bits")
    if not isinstance(bits, int) or not 1 <= bits <= MAX_BITS:
        raise ValueError(f"range spec needs 1 <= bits <= {MAX_BITS}")
    count = obj.get("count", 1)
    if not isinstance(count, int) or not 1 <= count <= MAX_COUNT:
        raise ValueError(f"range spec needs 1 <= count <= {MAX_COUNT}")
    return {"bits": bits, "count": count}


def build(params, seed):
    bits, count = params["bits"], params["count"]
    rng = random.Random(seed)
    cs = PlonkCircuit()
    for _ in range(count):
        value = rng.randrange(1 << bits)
        value_var = cs.create_public_variable(value)
        bit_vars = []
        for i in range(bits):
            b = cs.create_variable((value >> i) & 1)
            cs.enforce_bool(b)
            bit_vars.append(b)
        # recompose little-endian, 3 bits + accumulator per lc gate:
        # acc' = acc + 2^i b_i + 2^(i+1) b_(i+1) + 2^(i+2) b_(i+2)
        acc = cs.zero_var
        for i in range(0, bits, 3):
            chunk = bit_vars[i:i + 3]
            coeffs = [1] + [1 << (i + j) for j in range(len(chunk))]
            while len(chunk) < 3:
                chunk.append(cs.zero_var)
                coeffs.append(0)
            acc = cs.lc([acc] + chunk, coeffs)
        cs.enforce_equal(acc, value_var)
    ok, bad = cs.check_satisfiability()
    assert ok, f"range circuit unsatisfied at gate {bad}"
    return cs.finalize()
