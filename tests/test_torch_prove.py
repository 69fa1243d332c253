"""The port's main path on the CPU: TorchBackend(device="cpu") preprocess +
prove of the test circuit with the golden recipe (tau = 0xDEADBEEF, prove
rng random.Random(1), verify rng random.Random(2)) must give the bytes of
tests/fixtures/proof_small.hex AND of the JAX package's proof, and
verify. Every kernel runs its plain torch version here (CPU tensors).

`port_keys()` is the keys the other port test modules prove with: the
test circuit preprocessed from the device SRS (same tau, so the same
commit key and proof bytes), built once per process.
"""

import functools
import os
import random

import pytest
import torch

from distributed_plonk_tpu import proof_io as JIO
from distributed_plonk_tpu_torch import curve as C, kzg, proof_io
from distributed_plonk_tpu_torch.circuit import PlonkCircuit
from distributed_plonk_tpu_torch.prover import prove
from distributed_plonk_tpu_torch.trace import Tracer
from distributed_plonk_tpu_torch.verifier import verify
from distributed_plonk_tpu_torch.backend import curve_torch as CT
from distributed_plonk_tpu_torch.backend import field_torch as F
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend import msm_torch as M
from distributed_plonk_tpu_torch.backend import ntt_torch as N
from distributed_plonk_tpu_torch.backend.fixed_base_torch import \
    FixedBaseContext
from distributed_plonk_tpu_torch.backend.torch_backend import TorchBackend

# the plain versions run many small ops: one intra-op thread per test
# process beats oversubscribing the cores the other test workers share
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "proof_small.hex")


def _port_test_circuit():
    """conftest.build_test_circuit, built with the port's own circuit
    module (the port imports nothing of the JAX package)."""
    ckt = PlonkCircuit()
    x = ckt.create_public_variable(5)
    y = ckt.create_public_variable(11)
    s = ckt.add(x, y)
    p = ckt.mul(x, y)
    ckt.power5(s)
    lc = ckt.lc([x, y, s, p], [2, 3, 5, 7])
    d = ckt.add_constant(lc, 42)
    m = ckt.mul_constant(d, 9)
    ckt.sub(m, p)
    ckt.enforce_ecc_product(x, y, s, p, ckt.one_var, 5 * 11 * 16 * 55)
    ckt.finalize()
    return ckt


def golden():
    with open(FIXTURE) as f:
        return bytes.fromhex(f.read().strip())


@functools.lru_cache(maxsize=1)
def port_keys():
    """(circuit, backend, pk, vk) of the test circuit, preprocessed on
    TorchBackend(device="cpu") from universal_setup_device(n + 2,
    tau=0xDEADBEEF): the commit key of the golden recipe."""
    ckt = _port_test_circuit()
    srs = kzg.universal_setup_device(ckt.n + 2, tau=0xDEADBEEF,
                                     device="cpu")
    be = TorchBackend(device="cpu")
    pk, vk = kzg.preprocess(srs, ckt, be)
    return ckt, be, pk, vk


def test_port_proof_matches_golden_and_jax_proof(proven):
    _, _, _, jax_proof = proven       # JAX prove(..., PythonBackend())
    ckt = _port_test_circuit()
    srs = kzg.universal_setup(ckt.n + 3, tau=0xDEADBEEF)
    be = TorchBackend(device="cpu")
    pk, vk = kzg.preprocess(srs, ckt, be)
    tr = Tracer()
    proof = prove(random.Random(1), ckt, pk, be, tracer=tr)
    blob = proof_io.serialize_proof(proof)
    assert blob == golden()
    assert blob == JIO.serialize_proof(jax_proof)
    assert verify(vk, ckt.public_input(), proof, rng=random.Random(2))
    assert set(tr.totals(0)) == {"round%d" % i for i in range(1, 6)}


def test_torch_backend_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend("cuda")
    assert TorchBackend(device="cpu").device.type == "cpu"


# entry point -> a call of it with the given device argument (None: the
# default); preprocess takes a backend, whose default is TorchBackend()
ENTRY_POINTS = {
    "get_plan": lambda dev: N.get_plan(8, dev),
    "NttPlan": lambda dev: N.NttPlan(8, dev),
    "MsmContext": lambda dev: M.MsmContext([None, None], dev),
    "preprocess": lambda dev: kzg.preprocess(None, None),
    "universal_setup_device": lambda dev: kzg.universal_setup_device(
        1, tau=5, device=dev),
    "FixedBaseContext": lambda dev: FixedBaseContext(C.G1_GEN, dev),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Every entry point runs on the card unless the caller asks for the
    CPU: with no device it raises where CUDA is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry](None)
    if entry != "preprocess":
        assert ENTRY_POINTS[entry]("cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch wrappers never fall back to a plain version: a tensor
    that is not on a CUDA device is an error, before any build."""
    a = TL.lift([1, 2, 3, 4], "cpu")
    with pytest.raises(ValueError):
        F.mont_mul_cuda(F.FR, a, a)
    with pytest.raises(ValueError):
        N.ntt_cuda(N.get_plan(4, "cpu"), a[:, None, :])
    p = CT.proj_inf((4,), "cpu")
    with pytest.raises(ValueError):
        CT._add_cuda(p, p)
    with pytest.raises(ValueError):
        M.msm_digits_cuda(a[:, None, :], torch.zeros(4, dtype=torch.bool),
                          7, True, True)
    ops = torch.zeros((1, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        M.bucket_sums_cuda(M.point_major(p[0], p[1]), ops, ops, 1, 64)
    sums = CT.proj_inf((2, 64), "cpu")
    with pytest.raises(ValueError):
        M.msm_tail_cuda(*sums, signed=True)
