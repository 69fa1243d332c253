"""The port's circuit zoo (circuits/) against the JAX package's: at the
sizes of tests/test_circuits.py each kind builds the same circuit, gate by
gate (wires, witness, selectors, wiring, public inputs), with structure
fixed by the params; and the cheap kinds (range, preimage, as the JAX zoo
test proves) give a TorchBackend(device="cpu") proof equal to the JAX
PythonBackend proof byte for byte that verifies. The rollup's proof runs
on the card (chip_smoke.py's zoo phase, at n = 2^16).
"""

import random

import pytest
import torch

from distributed_plonk_tpu import circuits as jax_circuits
from distributed_plonk_tpu import kzg as jax_kzg
from distributed_plonk_tpu import proof_io as JIO
from distributed_plonk_tpu.backend.python_backend import \
    PythonBackend as JaxPythonBackend
from distributed_plonk_tpu.prover import prove as jax_prove
from distributed_plonk_tpu_torch import circuits, kzg, proof_io
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.verifier import verify
from distributed_plonk_tpu_torch.backend.torch_backend import TorchBackend

torch.set_num_threads(1)

ZOO = [
    ("range", {"bits": 8, "count": 2}),
    ("preimage", {"count": 1}),
    ("rollup", {"height": 1, "updates": 1, "num_accounts": 2}),
]
IDS = [k for k, _ in ZOO]


def _gates(ckt):
    return (ckt.n, ckt.wire_variables, ckt.witness, ckt.selectors,
            ckt.wire_permutation, ckt.pub_input_gate_ids,
            ckt.public_input())


def test_registry_covers_the_zoo():
    assert circuits.KINDS == jax_circuits.KINDS == ("preimage", "range",
                                                    "rollup")
    with pytest.raises(ValueError):
        circuits.validate_params("nope", {})
    with pytest.raises(ValueError):
        circuits.build("nope", {}, 0)


@pytest.mark.parametrize("kind,params", ZOO, ids=IDS)
def test_circuit_equals_the_jax_circuit(kind, params):
    ckt = circuits.build(kind, params, seed=7)
    assert ckt.n >= 2 and ckt.n & (ckt.n - 1) == 0
    assert _gates(ckt) == _gates(jax_circuits.build(kind, params, seed=7))
    other = circuits.build(kind, params, seed=8)
    assert other.wire_variables == ckt.wire_variables
    assert other.selectors == ckt.selectors
    assert other.witness != ckt.witness


@pytest.mark.parametrize("kind,bad", [
    ("range", {"bits": 0}), ("range", {"bits": 65}),
    ("range", {"bits": 8, "count": 0}), ("preimage", {"count": 0}),
    ("preimage", {"count": 10**6}), ("rollup", {"height": 0}),
    ("rollup", {"height": 1, "updates": 0}),
    ("rollup", {"height": 1, "num_accounts": 99}),
])
def test_bad_params_rejected_as_the_jax_zoo_does(kind, bad):
    with pytest.raises(ValueError):
        jax_circuits.validate_params(kind, bad)
    with pytest.raises(ValueError):
        circuits.validate_params(kind, bad)


@pytest.mark.parametrize("kind,params", ZOO[:2], ids=IDS[:2])
def test_proof_equals_the_jax_proof(kind, params):
    jckt = jax_circuits.build(kind, params, seed=3)
    srs = jax_kzg.universal_setup(jckt.n + 3, tau=0xDEADBEEF)
    jpk, _ = jax_kzg.preprocess(srs, jckt)
    want = JIO.serialize_proof(jax_prove(random.Random(3), jckt, jpk,
                                         JaxPythonBackend()))
    ckt = circuits.build(kind, params, seed=3)
    port_srs = kzg.UniversalSrs(srs.powers_of_g1, srs.g2, srs.tau_g2)
    be = TorchBackend(device="cpu")
    pk, vk = kzg.preprocess(port_srs, ckt, be)
    proof = prove(random.Random(3), ckt, pk, be)
    assert proof_io.serialize_proof(proof) == want
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(1))
