"""The port's MeshBackend end to end on four CPU shards (one repeated
device): preprocess and prove of the conftest circuit from the device SRS
of the golden recipe (tau = 0xDEADBEEF, prove rng random.Random(1)). The
keys must equal the JAX package's host preprocess (which
test_torch_keys.py and test_torch_prove.py hold TorchBackend's to), the
proof must equal tests/fixtures/proof_small.hex and the JAX package's
PythonBackend proof and verify, and the counters must show the mesh path
at every size the mesh divides; then dryrun_multichip(4, "cpu"). The
same preprocess and prove on a MeshBackend whose min_local (1) shards
the circuit's handles, over 4 shards (n = 16 lanes are 4 a shard, the
n + 2 and n + 3 lanes of the blinded polynomials keep those blocks and a
tail) and over 2 (where n + 2 divides: blinding relays the blocks), must
give the same bytes, with every handle sharded from round 1's wire
polynomials to round 5's openings.
"""

import random

import pytest
import torch

from distributed_plonk_tpu import proof_io as JIO
from distributed_plonk_tpu_torch import kzg, proof_io
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.verifier import verify
from distributed_plonk_tpu_torch.parallel.dryrun import dryrun_multichip
from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
from distributed_plonk_tpu_torch.parallel.mesh_backend import MeshBackend
from distributed_plonk_tpu_torch.parallel.ntt_mesh import divides

from test_torch_prove import _port_test_circuit, golden

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh_proof():
    ckt = _port_test_circuit()
    srs = kzg.universal_setup_device(ckt.n + 2, tau=0xDEADBEEF,
                                     device="cpu")
    be = MeshBackend(make_mesh(4, device="cpu"))
    pk, vk = kzg.preprocess(srs, ckt, be)
    proof = prove(random.Random(1), ckt, pk, be)
    return ckt, be, pk, vk, proof


def test_mesh_keys_equal_the_host_keys(mesh_proof, proven):
    _, pk0, vk0, _ = proven
    _, _, pk, vk, _ = mesh_proof
    assert vk.selector_comms == vk0.selector_comms
    assert vk.sigma_comms == vk0.sigma_comms
    assert pk.selectors == pk0.selectors and pk.sigmas == pk0.sigmas


def test_mesh_proof_matches_golden_and_jax_and_verifies(mesh_proof, proven):
    _, _, _, jax_proof = proven         # JAX prove(..., PythonBackend())
    ckt, _, _, vk, proof = mesh_proof
    blob = proof_io.serialize_proof(proof)
    assert blob == golden()
    assert blob == JIO.serialize_proof(jax_proof)
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(2))


def test_mesh_counters_show_the_mesh_path(mesh_proof):
    """Every NTT at a size the 4 shards divide went through the mesh, the
    rest were counted replicated; preprocess and prove committed 18 + 13
    handles, all on the mesh."""
    ckt, be, _, _, _ = mesh_proof
    n, m = ckt.n, 8 * ckt.n
    assert divides(4, n) and divides(4, m)
    assert set(be.mesh_ntt_calls) == {n, m}
    assert be.replicated_ntt_calls == {}
    # preprocess: 18 iNTTs; prove: 5 + 1 + 1 iNTTs of size n, 25 coset
    # NTTs and 1 coset iNTT of size m
    assert be.mesh_ntt_calls == {n: 18 + 7, m: 26}
    assert be.mesh_msm_calls == 18 + 13


def test_dryrun_multichip_on_cpu_shards():
    counts = dryrun_multichip(4, "cpu")
    assert counts["mesh_msm_calls"] == 1 + 18 + 13
    assert counts["mesh_ntt_calls"] and not counts["replicated_ntt_calls"]
    assert counts["sharded_handles"] and not counts["replicated_handles"]


@pytest.fixture(scope="module", params=[4, 2], ids=["4shards", "2shards"])
def sharded_proof(request):
    ckt = _port_test_circuit()
    srs = kzg.universal_setup_device(ckt.n + 2, tau=0xDEADBEEF,
                                     device="cpu")
    be = MeshBackend(make_mesh(request.param, device="cpu"), min_local=1)
    pk, vk = kzg.preprocess(srs, ckt, be)
    proof = prove(random.Random(1), ckt, pk, be)
    return ckt, be, pk, vk, proof


def test_sharded_mesh_proof_matches_golden_jax_and_mesh(sharded_proof,
                                                        mesh_proof, proven):
    """The sharded mesh's keys and proof equal the default mesh's (whose
    handles stay whole at this size), the golden bytes and the JAX
    package's PythonBackend proof, and the proof verifies."""
    _, _, _, jax_proof = proven
    ckt, be, pk, vk, proof = sharded_proof
    _, _, pk0, vk0, proof0 = mesh_proof
    assert vk.selector_comms == vk0.selector_comms
    assert vk.sigma_comms == vk0.sigma_comms
    assert pk.selectors == pk0.selectors and pk.sigmas == pk0.sigmas
    blob = proof_io.serialize_proof(proof)
    assert blob == golden() == proof_io.serialize_proof(proof0)
    assert blob == JIO.serialize_proof(jax_proof)
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(2))


def test_sharded_mesh_counters_show_the_state_sharded(sharded_proof,
                                                      mesh_proof):
    """Every handle the sharded mesh made was Sharded, by length: the
    n-lane ones (18 lifted key columns and their 18 iNTTs; 5 wire
    columns, their 5 iNTTs, z, its iNTT, the public inputs and their
    iNTT), the n + 2 ones (5 blinded wires, 5 split quotient pieces, the
    2 openings), the n + 3 ones (the blinded z, the linearization and the
    batched opening) and the m-lane ones (25 coset planes, the quotient
    evaluations and its coset iNTT); the default mesh made the same
    handles whole. The path counters agree."""
    ckt, be, _, _, _ = sharded_proof
    _, be0, _, _, _ = mesh_proof
    n, m = ckt.n, 8 * ckt.n
    want = {n: 36 + 14, n + 2: 12, n + 3: 3, m: 27}
    assert be.sharded_handles == want and not be.replicated_handles
    assert be0.replicated_handles == want and not be0.sharded_handles
    assert be.mesh_ntt_calls == be0.mesh_ntt_calls == {n: 18 + 7, m: 26}
    assert be.mesh_msm_calls == be0.mesh_msm_calls == 18 + 13
