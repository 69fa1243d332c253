"""Port NTT (backend/ntt_torch.py) vs the JAX package's ntt_jax and the
poly.py oracle, exactly, in all four (inverse, coset) modes at the
Montgomery boundary, for odd and even log2 n.

The JAX side is ntt_jax.get_plan(n).kernel(...) on its XLA stage core;
the port side is kernel 2's plain version (ntt_ref), stage for stage.
"""

import numpy as np
import pytest
import torch

from distributed_plonk_tpu import poly as P
from distributed_plonk_tpu.backend import ntt_jax
from distributed_plonk_tpu.backend import prover_jax as PJ
from distributed_plonk_tpu.constants import R_MOD
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend import ntt_torch as N

# the plain versions run many small ops: one intra-op thread per test
# process beats oversubscribing the cores the other test workers share
torch.set_num_threads(1)

MODES = [(False, False), (True, False), (False, True), (True, True)]


def _values(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % R_MOD
            for _ in range(n)]
    vals[:3] = [0, 1, R_MOD - 1]
    return vals


def _oracle(domain, values, inverse, coset):
    if inverse and coset:
        return P.coset_ifft(domain, values)
    if inverse:
        return P.ifft(domain, values)
    if coset:
        return P.coset_fft(domain, values)
    return P.fft(domain, values)


@pytest.mark.parametrize("n", [8, 64, 128])
def test_ntt_all_modes_match_ntt_jax_and_oracle(n):
    domain = P.Domain(n)
    plan_j = ntt_jax.get_plan(n)
    plan_t = N.get_plan(n, "cpu")
    for k, (inverse, coset) in enumerate(MODES):
        vals = _values(n, 100 * n + k)
        h_j = PJ.lift(vals)
        want = np.asarray(plan_j.kernel(inverse=inverse, coset=coset,
                                        boundary="mont")(h_j))
        got = plan_t.kernel(inverse, coset)(TL.from_jax_limbs(h_j, "cpu"))
        assert np.array_equal(TL.to_jax_limbs(got), want), (n, inverse,
                                                             coset)
        assert TL.lower(got) == _oracle(domain, vals, inverse, coset)


def test_ntt_batch_axis_matches_single_transforms():
    """(8, B, n) batches transform each row independently."""
    n, B = 64, 3
    plan = N.get_plan(n, "cpu")
    rows = [TL.lift(_values(n, 7 + b), "cpu") for b in range(B)]
    batch = torch.stack(rows, dim=1)
    for inverse, coset in MODES:
        out = N.ntt(plan, batch, inverse, coset)
        for b in range(B):
            assert torch.equal(out[:, b],
                               plan.kernel(inverse, coset)(rows[b]))


def test_run_ints_round_trips():
    n = 32
    vals = _values(n, 3)
    plan = N.get_plan(n, "cpu")
    assert plan.run_ints(plan.run_ints(vals), inverse=True) == vals
    assert plan.run_ints(plan.run_ints(vals, coset=True), inverse=True,
                         coset=True) == vals
