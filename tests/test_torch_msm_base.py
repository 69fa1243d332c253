"""The port's base-layout MSM (backend/msm_torch.py, MsmContext layout
"base") and kernel 4's window finish (msm_finish_ref, the plain version
of csrc/msm_finish.cu) vs the window-shifted layout, the JAX package's
msm_jax and the host curve.py oracle, exactly:

- base and shifted contexts, msm_jax.MsmContext.msm_many and curve.g1_msm
  give the same affine points, over keys of n + 3 points (n = 300: signed
  c = 7; n = 64: unsigned c = 4) identity-padded as the commit key is, at
  batches of 1 and 3 handles of the blinded widths n + 2 and n + 3;
- msm_finish_ref on seeded bucket sums equals msm_jax.finish_batch after
  conversion to affine, and the multiple of G the sums encode;
- point ranges forced small (bucket planes merged by proj_add) give the
  oracle's points;
- launch_cut keeps every launch sequence under 2^31 (lane, point)
  elements, and bucket_sums refuses one past it, before any tensor is
  allocated;
- a TorchBackend(device="cpu") prove whose commit key takes the base
  layout gives tests/fixtures/proof_small.hex.
"""

import functools
import os
import random

import jax
import numpy as np
import pytest
import torch

from distributed_plonk_tpu.backend import msm_jax as MJ
from distributed_plonk_tpu_torch import curve as C, kzg, proof_io
from distributed_plonk_tpu_torch.analysis import registry as AR
from distributed_plonk_tpu_torch.backend import curve_torch as CT
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend import msm_torch as M
from distributed_plonk_tpu_torch.backend.torch_backend import TorchBackend
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.prover import prove

# the plain versions run many small ops: one intra-op thread per test
# process beats oversubscribing the cores the other test workers share
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "proof_small.hex")


@functools.lru_cache(maxsize=None)
def key(n):
    """(points, commit key, base context) for a key of n + 3 points
    padded with identities to a multiple of 32 (kzg.pad_commit_key)."""
    rng = random.Random(n)
    points = [C.g1_mul(C.G1_GEN, rng.randrange(1, R_MOD))
              for _ in range(n + 3)]
    ck = kzg.pad_commit_key(points, n + 3)
    return points, ck, M.MsmContext(ck, "cpu", layout="base")


def scalars(n, batch, seed):
    """`batch` scalar lists of the widths n + 2 and n + 3 in turn (one
    handle: n + 3), the corners 0, 1 and r - 1 first."""
    rng = np.random.default_rng(seed)
    widths = [n + 3] if batch == 1 else [(n + 2, n + 3)[i % 2]
                                         for i in range(batch)]
    out = []
    for w in widths:
        vals = [int.from_bytes(rng.bytes(40), "little") % R_MOD
                for _ in range(w)]
        vals[:3] = [0, 1, R_MOD - 1]
        out.append(vals)
    return out


@pytest.mark.parametrize("n,batch", [(300, 3), (64, 1)])
def test_base_layout_matches_shifted_msm_jax_and_oracle(n, batch):
    """Signed c = 7 with 3 handles against the oracle and the JAX
    package's MsmContext; unsigned c = 4 with one handle against the
    oracle and the shifted layout (each of the two costs a CPU key build
    or an XLA compile of 10-20 s; both layouts meet the oracle in every
    case, and the prove below holds them to one proof)."""
    points, ck, base = key(n)
    assert base.layout == "base" and base.key.shape == (len(ck), 24)
    assert (base.signed, base.c) == ((True, 7) if n == 300 else (False, 4))
    sc = scalars(n, batch, 10 * n + batch)
    want = [C.g1_msm(points[:len(s)], s) for s in sc]
    assert base.msm_many(sc) == want
    if n == 300:
        assert MJ.MsmContext(ck).msm_many(sc) == want
    else:
        assert M.MsmContext(ck, "cpu", layout="shifted").msm_many(sc) == want


def test_msm_finish_ref_matches_msm_jax_finish():
    """Seeded bucket sums of one handle's 37 windows (multiples k G of
    the generator with random Z, some the identity: the registry's
    sampler) through msm_finish_ref and through msm_jax.finish_batch,
    both to affine; and the contract that the total is the multiple the
    sums encode."""
    windows, c = M.W7, 7
    ob = AR._finish_value(1, windows, c, True)
    args = ob.sampler(np.random.default_rng(1))
    planes = args[:3]
    got = M.msm_finish_ref(*planes, windows, c, True)
    want = jax.jit(MJ.finish_batch, static_argnums=(3, 4))(
        *(TL.to_jax_limbs(p) for p in planes), 1, True)
    want = tuple(TL.from_jax_limbs(np.asarray(w), "cpu") for w in want)
    assert CT.proj_to_affine(got) == CT.proj_to_affine(want)
    assert ob.contract(args, [np.asarray(g.numpy(), dtype=object)
                              for g in got]) == []


def test_point_ranges_merge_to_one_launchs_points():
    """Ranges of 40 points (3 ranges over the 96-point key, the planes
    merged by proj_add in range order) for a batch of 3 handles give the
    oracle's points."""
    points, ck, _ = key(64)
    cut = M.MsmContext(ck, "cpu", layout="base", point_chunk=40)
    assert M.launch_cut(3, cut.windows, cut.n, 40) == (3, 40)
    sc = scalars(64, 3, 7)
    assert cut.msm_many(sc) == [C.g1_msm(points[:len(s)], s) for s in sc]


def test_launch_cut_keeps_int32_element_indices(monkeypatch):
    """At 2^24 points and 37 windows one handle fills the default byte
    budget; with the budget lifted the 2^31 element cut takes 3 handles
    (3 x 37 x 2^24 < 2^31 <= 4 x 37 x 2^24); a range forced past 2^31
    elements raises, and bucket_sums refuses one before it allocates
    (meta tensors hold no memory)."""
    n, W = 1 << 24, M.W7
    assert M.launch_cut(32, W, n) == (1, n)
    assert M.launch_cut(32, 1, 300) == (32, 300)
    monkeypatch.setattr(M, "LAUNCH_BYTES_MAX", 1 << 50)
    assert M.launch_cut(32, W, n) == (3, n)
    assert 3 * W * n <= M.ELEMS_MAX < 4 * W * n
    # one handle past the cap: ranges of the points
    assert M.launch_cut(1, W, 1 << 26) == (1, M.ELEMS_MAX // W)
    with pytest.raises(ValueError, match="int32"):
        M.launch_cut(1, W, 1 << 26, point_chunk=1 << 26)
    meta = torch.empty((n, 24), dtype=torch.int32, device="meta")
    flat = torch.empty((4 * W * n,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="int32"):
        M.bucket_sums(meta, flat, flat, 4 * W, 64)
    # the layout: shifted for the prover's keys, base past the build cap
    assert M.resolve_layout("auto", (1 << 20) + 32) == "shifted"
    assert M.resolve_layout("auto", (1 << 21) + 32) == "base"
    assert M.resolve_layout("auto", 1 << 24) == "base"
    with pytest.raises(ValueError):
        M.resolve_layout("strided", 64)


def test_base_layout_prove_gives_the_fixture():
    from test_torch_prove import port_keys
    ckt, _, pk, vk = port_keys()
    be = TorchBackend(device="cpu", msm_layout="base")
    proof = prove(random.Random(1), ckt, pk, be)
    assert be._ctx(pk.ck).layout == "base"
    with open(FIXTURE) as f:
        assert proof_io.serialize_proof(proof).hex() == f.read().strip()
