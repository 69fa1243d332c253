"""KZG polynomial commitments: setup, preprocess, proving/verifying keys.

Re-provides the jf-plonk surface consumed by the reference:
`universal_setup` / `preprocess` (reference src/dispatcher2.rs:1279-1280)
and the commit-key layout the dispatcher pads to a multiple of 32
(reference src/dispatcher2.rs:207-208).
"""

import random

import torch

from .constants import R_MOD
from . import curve as C
from .backend import curve_torch as CT
from .backend import field_torch as F
from .backend.fixed_base_torch import g1_batch_mul
from .backend.msm_torch import DeviceCommitKey
from .backend.torch_backend import TorchBackend
from .circuit import NUM_WIRE_TYPES, NUM_SELECTORS


class UniversalSrs:
    def __init__(self, powers_of_g1, g2, tau_g2):
        self.powers_of_g1 = powers_of_g1  # [G1, tau G1, tau^2 G1, ...]
        self.g2 = g2
        self.tau_g2 = tau_g2


class VerifyingKey:
    def __init__(self, domain_size, num_inputs, selector_comms, sigma_comms,
                 k, g1, g2, tau_g2):
        self.domain_size = domain_size
        self.num_inputs = num_inputs
        self.selector_comms = selector_comms
        self.sigma_comms = sigma_comms
        self.k = k
        self.g1 = g1
        self.g2 = g2
        self.tau_g2 = tau_g2


class ProvingKey:
    """ck: commit key (G1 powers, padded); selectors: 13 coefficient
    vectors; sigmas: 5 coefficient vectors.

    The host coefficient lists are LAZY: the device handles are what the
    prover consumes (registered via backend.register_pk_polys, and kept
    as `device_polys` = (device, selector handles, sigma handles) for the
    other backends on that device, e.g. a service's pool workers), and
    the 18 host int lists are only materialized if a consumer asks for
    them (a backend on another device, the host oracle, the key store)."""

    def __init__(self, ck, vk, domain, lazy):
        self.ck = ck
        self.device_polys = None
        self._selectors = self._sigmas = None
        self._lazy = lazy  # () -> (selector_lists, sigma_lists)
        self.vk = vk
        self.domain = domain

    def _materialize(self):
        if self._selectors is None:
            self._selectors, self._sigmas = self._lazy()
            self._lazy = None  # release the captured backend/device handles

    @property
    def selectors(self):
        self._materialize()
        return self._selectors

    @property
    def sigmas(self):
        self._materialize()
        return self._sigmas

    @property
    def domain_size(self):
        return self.domain.size


def _tau_powers(max_degree, rng=None, tau=None):
    if tau is None:
        rng = rng or random.Random()
        tau = rng.randrange(1, R_MOD)
    powers = []
    acc = 1
    for _ in range(max_degree + 1):
        powers.append(acc)
        acc = acc * tau % R_MOD
    return tau, powers


def universal_setup(max_degree, rng=None, tau=None):
    """Simulated trusted setup (test SRS; tau is toxic waste).

    Mirrors PlonkKzgSnark::universal_setup (reference src/dispatcher2.rs:1279).
    """
    tau, powers = _tau_powers(max_degree, rng, tau)
    # batch the scalar muls through one Pippenger-style pass per power is
    # overkill here; direct double-and-add per power (host oracle only).
    powers_of_g1 = [C.g1_mul(C.G1_GEN, p) for p in powers]
    tau_g2 = C.g2_mul(C.G2_GEN, tau)
    return UniversalSrs(powers_of_g1, C.G2_GEN, tau_g2)


class DeviceSrs:
    """SRS whose G1 powers live on a device as Jacobian Montgomery word
    tensors ((12, N),)*3: produced by the fixed-base walk, consumed by
    DeviceCommitKey / MsmContext without visiting the host."""

    def __init__(self, jac_powers, count, g2, tau_g2):
        self.jac_powers = jac_powers
        self.count = count
        self.g2 = g2
        self.tau_g2 = tau_g2

    @property
    def device(self):
        return self.jac_powers[0].device

    def powers_affine(self):
        """Host affine list (test/oracle boundary: one batch inversion on
        the device, then one transfer per coordinate)."""
        return CT.affine_to_host(*CT.batch_to_affine(self.jac_powers))


def universal_setup_device(max_degree, rng=None, tau=None, device=None):
    """Trusted setup with the [tau^i]G1 walk run as one device batch
    (backend/fixed_base_torch.py) instead of max_degree serial host scalar
    muls: the set-up's scale blocker at reference size (2^18 + 3 powers,
    reference workload src/dispatcher2.rs:1219-1221). device None: the
    card."""
    device = F.resolve_device(device, "universal_setup_device")
    tau, powers = _tau_powers(max_degree, rng, tau)
    jac = g1_batch_mul(powers, device)
    tau_g2 = C.g2_mul(C.G2_GEN, tau)
    return DeviceSrs(jac, max_degree + 1, C.G2_GEN, tau_g2)


def device_commit_key(srs, srs_size, device):
    """A DeviceSrs's first srs_size powers padded with identity columns
    (Z = 0) to a multiple of 32, the host key's length (pad_commit_key),
    so both keys give the MSM the same point count. Padding never changes
    a commitment."""
    assert srs.count >= srs_size, "SRS too small for this circuit"
    pad = (-srs_size) % 32
    px, py, pz = (torch.nn.functional.pad(p[:, :srs_size].to(device),
                                          (0, pad))
                  for p in srs.jac_powers)
    return DeviceCommitKey(px, py, pz)


def pad_commit_key(powers, srs_size):
    """Host G1 powers -> commit key: slice to srs_size, pad to a multiple
    of 32 with the identity, as the dispatcher does (reference
    src/dispatcher2.rs:207-208) so MSM shard sizes divide evenly. The
    JAX package pads identically, so both sides commit with one key."""
    assert len(powers) >= srs_size, "SRS too small for this circuit"
    ck = list(powers[:srs_size])
    while len(ck) % 32 != 0:
        ck.append(None)
    return ck


def preprocess(srs, circuit, backend=None):
    """Build (pk, vk) for a finalized circuit on a device backend (None:
    TorchBackend() on the card), from a host UniversalSrs or a DeviceSrs
    (whose commit key stays on the device, never normalized on the host).

    Mirrors PlonkKzgSnark::preprocess (reference src/dispatcher2.rs:1280):
    selector/sigma polynomials are iFFTs of their domain evaluations;
    their commitments go into the vk (and the Fiat-Shamir transcript).
    The 18 iFFTs run as batched launches and the 18 commitments as
    batched MSMs over poly HANDLES (device-resident end to end): the
    reference's join_all fan-out (src/dispatcher2.rs:294-321) applied to
    setup.
    """
    if backend is None:
        backend = TorchBackend()
    n = circuit.n
    domain = circuit.eval_domain
    srs_size = n + 3  # degree n+2 polys (blinded z) must be committable
    if isinstance(srs, DeviceSrs):
        ck = device_commit_key(srs, srs_size, backend.device)
    else:
        ck = pad_commit_key(srs.powers_of_g1, srs_size)

    cols = list(circuit.selectors) + list(circuit.sigma_values())
    assert len(circuit.selectors) == NUM_SELECTORS
    assert len(cols) == NUM_SELECTORS + NUM_WIRE_TYPES
    chs = backend.ifft_many(domain, backend.lift_many(cols))
    comms = backend.commit_many_h(ck, chs)
    sel_h, sig_h = chs[:NUM_SELECTORS], chs[NUM_SELECTORS:]

    vk = VerifyingKey(
        domain_size=n,
        num_inputs=circuit.num_inputs,
        selector_comms=comms[:NUM_SELECTORS],
        sigma_comms=comms[NUM_SELECTORS:],
        k=list(circuit.k),
        g1=C.G1_GEN,
        g2=srs.g2,
        tau_g2=srs.tau_g2,
    )
    # the host coefficient lists stay lazy; the backend's device cache is
    # seeded so the prover's pk_polys() does not re-lift them
    pk = ProvingKey(ck, vk, domain,
                    lazy=lambda: ([backend.lower(h) for h in sel_h],
                                  [backend.lower(h) for h in sig_h]))
    backend.register_pk_polys(pk, sel_h, sig_h)
    pk.device_polys = (backend.device, tuple(sel_h), tuple(sig_h))
    return pk, vk
