"""The port's fixed-base walk and device SRS (backend/fixed_base_torch.py,
kzg.universal_setup_device) on the CPU, where kernel 4's mixed add and
kernel 1 run their plain versions.

Held to: the JAX package's FixedBaseContext.batch_mul limb for limb
(through limbs.from_jax_limbs; exact, tolerance 0) on the scalars of
tests/test_fixed_base.py, the host double-and-add g1_mul, the host
universal_setup, and the host-SRS preprocess's commitments.
"""

import random

import numpy as np
import pytest
import torch

from distributed_plonk_tpu import curve as JC
from distributed_plonk_tpu.backend.fixed_base import \
    FixedBaseContext as JaxFixedBaseContext
from distributed_plonk_tpu_torch import curve as C, kzg
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.backend import curve_torch as CT
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend.fixed_base_torch import (
    FixedBaseContext, digits_of_scalars)

from test_torch_prove import port_keys

torch.set_num_threads(1)


def _scalars():
    # tests/test_fixed_base.py's: 0 -> infinity, 1 -> G, r-1 -> -G, 2,
    # plus randoms
    rng = random.Random(3)
    return [0, 1, R_MOD - 1, 2] + [rng.randrange(R_MOD) for _ in range(12)]


@pytest.fixture(scope="module")
def jax_walk():
    """The JAX walk's Jacobian (24, 16) limb arrays for _scalars()."""
    out = JaxFixedBaseContext(JC.G1_GEN).batch_mul(_scalars())
    return [np.asarray(c) for c in out]


def _equal_to_jax(got, want, lanes=None):
    for g, w in zip(got, want):
        w = w if lanes is None else w[:, :lanes]
        assert torch.equal(g, TL.from_jax_limbs(w, "cpu"))


def test_digits_are_the_little_endian_bytes():
    s = _scalars()
    d = digits_of_scalars(s)
    assert d.shape == (32, len(s))
    assert all(sum(int(d[w, i]) << (8 * w) for w in range(32)) == s[i]
               for i in range(len(s)))


def test_batch_mul_equals_jax_walk_limb_for_limb_and_host(jax_walk):
    scalars = _scalars()
    got = FixedBaseContext(C.G1_GEN, "cpu").batch_mul(scalars)
    _equal_to_jax(got, jax_walk)
    # edge digits: 0 takes the table's infinity flag, so lane 0 stays the
    # identity (Z = 0) instead of adding the (0, 0) row
    assert CT.affine_to_host(*CT.batch_to_affine(got)) == [
        C.g1_mul(C.G1_GEN, s) for s in scalars]


def test_batch_mul_multi_chunk(jax_walk):
    ctx = FixedBaseContext(C.G1_GEN, "cpu")
    ctx.CHUNK = 4
    _equal_to_jax(ctx.batch_mul(_scalars()[:10]), jax_walk, lanes=10)


def test_device_srs_matches_host_setup():
    srs_h = kzg.universal_setup(33, tau=987654321)
    srs_d = kzg.universal_setup_device(33, tau=987654321, device="cpu")
    assert srs_d.count == 34
    assert srs_d.powers_affine() == srs_h.powers_of_g1
    assert srs_d.tau_g2 == srs_h.tau_g2


def test_device_srs_preprocess_gives_host_vk(proven):
    """The port's test circuit preprocessed from the device SRS commits to
    the vk of the JAX package's host-SRS preprocess (same tau)."""
    _, _, vk_h, _ = proven
    ckt, be, pk, vk = port_keys()
    assert len(pk.ck) == 32      # n + 3 = 19 powers, padded as the host key
    assert vk.selector_comms == vk_h.selector_comms
    assert vk.sigma_comms == vk_h.sigma_comms
    assert vk.tau_g2 == vk_h.tau_g2
