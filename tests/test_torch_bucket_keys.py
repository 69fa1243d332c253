"""The port's bucket keys equal the JAX package's: `build_bucket_keys(spec,
device="cpu")` (the device SRS and TorchBackend's preprocess, on the
kernels' plain versions) gives the SRS powers, g2 points and verifying key
that the JAX package's host build gives for the same spec, for a toy, a
height-2 Merkle (n = 512) and a range circuit. The vk is the one a client
derives; the premise of shape buckets is that the seed-0 circuit stands in
for every seed, so each is also checked against another seed's circuit.
"""

import pytest
import torch

from distributed_plonk_tpu.service import jobs as JJ
from distributed_plonk_tpu_torch.service import jobs as PJ

torch.set_num_threads(1)


@pytest.mark.parametrize("obj", [
    {"kind": "toy", "gates": 8, "seed": 4},
    {"kind": "merkle", "height": 2, "seed": 9},
    {"kind": "range", "bits": 8, "count": 1, "seed": 2},
], ids=lambda o: o["kind"])
def test_bucket_keys_equal_the_jax_keys(obj):
    srs, pk, vk = PJ.build_bucket_keys(PJ.JobSpec.from_wire(obj),
                                       device="cpu")
    jsrs, jpk, jvk = JJ.build_bucket_keys(JJ.JobSpec.from_wire(obj))
    assert srs.count == len(jsrs.powers_of_g1) == vk.domain_size + 4
    assert srs.powers_affine() == jsrs.powers_of_g1
    assert (srs.g2, srs.tau_g2) == (jsrs.g2, jsrs.tau_g2)
    for name in ("domain_size", "num_inputs", "selector_comms",
                 "sigma_comms", "k", "g1", "g2", "tau_g2"):
        assert getattr(vk, name) == getattr(jvk, name), name
    assert pk.selectors == jpk.selectors and pk.sigmas == jpk.sigmas
    # structure from params alone: another seed builds the same shape
    ckt = PJ.build_circuit(PJ.JobSpec.from_wire(dict(obj, seed=77)))
    assert ckt.n == vk.domain_size and ckt.num_inputs == vk.num_inputs
