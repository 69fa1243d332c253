"""The circuit zoo: workload families beyond the Merkle generator (a copy
of the JAX package's circuits/, host only).

A registry of circuit families built on the 5-wire/13-selector builder
(circuit.PlonkCircuit), each obeying one structural contract:

    two builds with the same params but different seeds produce circuits
    with IDENTICAL structure (gates, wiring, selectors) — only witness
    values and public inputs differ.

That contract is what lets one SRS and proving key serve every circuit
of a shape, so every builder here derives gate COUNT and WIRING purely
from params, and draws only witness VALUES from the seed.

Kinds (each module exposes validate(obj) -> params and
build(params, seed) -> finalized, satisfiability-checked circuit):

  range     bit-decomposition range checks: `count` public values each
            proven to lie in [0, 2^bits) via enforce_bool chains
  preimage  Rescue-hash preimage knowledge: public digests, private
            (x, y, z) preimages through hash3_gadget
  rollup    a rollup-style state-transition batch: `updates`
            account-balance updates under one 3-ary Rescue Merkle root,
            old root and final root public, every intermediate
            transition proven in-circuit

The proof service routes every zoo kind through REGISTRY
(service/jobs.py: JobSpec.from_wire validates with validate_params,
build_circuit builds with build), as the JAX package's service does.
"""

from . import preimage, range_check, rollup

# kind name -> module with validate(obj)->params, build(params, seed)->ckt
REGISTRY = {
    "range": range_check,
    "preimage": preimage,
    "rollup": rollup,
}

KINDS = tuple(sorted(REGISTRY))


def validate_params(kind, obj):
    """Untrusted wire dict -> canonical params dict for `kind`.
    Raises ValueError with a client-presentable reason."""
    mod = REGISTRY.get(kind)
    if mod is None:
        raise ValueError(f"unknown circuit kind {kind!r}")
    return mod.validate(obj)


def build(kind, params, seed):
    """(kind, params, seed) -> finalized circuit; every builder runs
    check_satisfiability() before finalize, so a buggy witness generator
    fails loudly at build time, never as an unverifiable proof."""
    mod = REGISTRY.get(kind)
    if mod is None:
        raise ValueError(f"unknown circuit kind {kind!r}")
    return mod.build(params, seed)
