"""Each of the port's four CUDA kernels against its plain torch version on
the card, exactly (tolerance 0: every value is a canonical integer).

Marked `cuda`; every test skips without a card. This file imports neither
jax nor the JAX package, so it also runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from distributed_plonk_tpu_torch import curve as C
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.backend import curve_torch as CT
from distributed_plonk_tpu_torch.backend import field_torch as F
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend import msm_torch as M
from distributed_plonk_tpu_torch.backend import ntt_torch as N

pytestmark = pytest.mark.cuda

MODES = [(False, False), (True, False), (False, True), (True, True)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the port's kernels run only on a CUDA card")
    return torch.device("cuda")


def _values(mod, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(56), "little") % mod for _ in range(n)]
    vals[:3] = [0, 1, mod - 1]
    return vals


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul_kernel_matches_plain(field):
    dev = _card()
    spec = F.FR if field == "fr" else F.FQ
    a, b = (TL.to_tensor(TL.ints_to_words(_values(spec.mod, 4099, s),
                                          spec.n_words), dev)
            for s in (1, 2))
    assert torch.equal(F.mont_mul_cuda(spec, a, b),
                       F.mont_mul_ref(spec, a, b))


@pytest.mark.parametrize("inverse,coset", MODES)
def test_ntt_kernel_matches_plain(inverse, coset):
    dev = _card()
    n, batch = 1 << 10, 3
    plan = N.get_plan(n, dev)
    v = TL.lift(_values(R_MOD, n * batch, 3), dev).reshape(8, batch, n)
    assert torch.equal(N.ntt_cuda(plan, v, inverse, coset),
                       N.ntt_ref(plan, v, inverse, coset))


def test_bucket_and_add_kernels_match_plain():
    dev = _card()
    n, group = 512, 4
    rng = np.random.default_rng(4)
    points = [C.g1_mul(C.G1_GEN, int(rng.integers(1, 1 << 62)))
              for _ in range(n - 2)] + [None, None]
    px, py, inf = M.points_to_device(points, 0, dev)
    words = torch.stack([F._wide(TL.to_tensor(TL.ints_to_words(
        _values(R_MOD, n, 5 + b), 8), dev)) for b in range(2)], dim=1)
    digits = M.signed_digits7_from_canon(words)               # (37, 2, n)
    ops = M.signed_ops(digits.transpose(0, 1).reshape(-1, n), inf, 64)
    got = M.bucket_accumulate_cuda(px, py, ops, group, 64)
    want = M.bucket_accumulate_ref(px, py, ops, group, 64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    p = tuple(c[:, :2].contiguous() for c in got)
    q = tuple(c[:, 2:].contiguous() for c in got)
    assert all(torch.equal(g, w) for g, w in
               zip(CT._add_cuda(p, q), CT.proj_add_ref(p, q)))
    affine = tuple(c.reshape(12, -1)[:, :64].contiguous() for c in (px, py))
    head = tuple(c.reshape(12, -1)[:, :64].contiguous() for c in p)
    assert all(torch.equal(g, w) for g, w in
               zip(CT._add_cuda(head, affine),
                   CT.proj_add_mixed_ref(head, affine)))
