"""A multi-shard dry run of the mesh prover at tiny shapes: the port of the
JAX package's dryrun_multichip (its __graft_entry__.py).

    from distributed_plonk_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4)            # four shards on the card(s)
    dryrun_multichip(4, "cpu")     # four CPU shards, the plain kernels

Runs the two sharded paths alone, then a whole prove: a mesh iNTT and a
coset NTT held against the poly oracle, a preprocess of a tiny circuit on
MeshBackend, a mesh MSM over its sharded commit key held against
curve.g1_msm, and the prove on MeshBackend held byte for byte against
PythonBackend's proof, which must verify; then the same prove on a
MeshBackend whose min_local (1) shards every handle of at least one lane
a shard, byte for byte again, its handle counters showing the n- and
m-lane state sharded and no handle replicated.
Raises on any mismatch; returns the backend's path counters and the
sharded backend's handle counters.
"""

import random

from .. import curve as C
from .. import kzg
from .. import poly as P
from ..circuit import PlonkCircuit
from ..constants import R_MOD
from ..poly import Domain
from ..proof_io import serialize_proof
from ..prover import prove
from ..verifier import verify
from ..backend.python_backend import PythonBackend
from .mesh import make_mesh
from .mesh_backend import MeshBackend
from .ntt_mesh import MeshNttPlan


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _circuit():
    ckt = PlonkCircuit()
    x = ckt.create_public_variable(5)
    y = ckt.create_public_variable(11)
    s = ckt.add(x, y)
    p = ckt.mul(x, y)
    ckt.power5(s)
    ckt.enforce_ecc_product(x, y, s, p, ckt.one_var, 5 * 11 * 16 * 55)
    ckt.finalize()
    ok, row = ckt.check_satisfiability()
    _check(ok, "dry-run circuit unsatisfied at row %s" % (row,))
    return ckt


def dryrun_multichip(n_shards, device=None):
    mesh = make_mesh(n_shards, device)
    rng = random.Random(7)
    n = 64 if n_shards <= 8 else 16 * n_shards
    domain = P.Domain(n)
    values = [rng.randrange(R_MOD) for _ in range(n)]

    plan = MeshNttPlan(mesh, n)
    coeffs = plan.run_ints(values, inverse=True)
    _check(coeffs == P.ifft(domain, values), "mesh iNTT mismatch")
    evals = plan.run_ints(coeffs, coset=True)
    _check(evals == P.coset_fft(domain, coeffs), "mesh coset NTT mismatch")

    ckt = _circuit()
    srs = kzg.universal_setup(ckt.n + 3, tau=0xDEADBEEF)
    be = MeshBackend(mesh)
    pk, vk = kzg.preprocess(srs, ckt, be)

    # the MSM alone, over the commit key preprocess sharded (the range of
    # the last shard is mostly identity padding)
    scalars = [rng.randrange(R_MOD) for _ in range(len(pk.ck))]
    _check(be.msm(pk.ck, scalars) == C.g1_msm(pk.ck, scalars),
           "mesh MSM mismatch")

    proof_mesh = prove(random.Random(1), ckt, pk, be)
    proof_host = prove(random.Random(1), ckt, pk, PythonBackend())
    _check(serialize_proof(proof_mesh) == serialize_proof(proof_host),
           "mesh proof differs from the host oracle's")
    _check(verify(vk, ckt.public_input(), proof_mesh, rng=random.Random(2)),
           "mesh proof rejected")

    sharded = MeshBackend(mesh, min_local=1)
    proof_sharded = prove(random.Random(1), ckt, pk, sharded)
    _check(serialize_proof(proof_sharded) == serialize_proof(proof_host),
           "sharded mesh proof differs from the host oracle's")
    m = Domain(6 * (ckt.n + 1) + 1).size
    _check({ckt.n, m} <= set(sharded.sharded_handles)
           and not sharded.replicated_handles,
           "the sharded mesh kept handles whole: %s, %s" % (
               dict(sharded.sharded_handles),
               dict(sharded.replicated_handles)))
    return {"mesh_ntt_calls": dict(be.mesh_ntt_calls),
            "replicated_ntt_calls": dict(be.replicated_ntt_calls),
            "mesh_msm_calls": be.mesh_msm_calls,
            "sharded_handles": dict(sharded.sharded_handles),
            "replicated_handles": dict(sharded.replicated_handles)}
