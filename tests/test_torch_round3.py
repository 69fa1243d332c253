"""The port's streamed round 3 (TorchBackend.quotient_streamed,
prover_torch's gate and sigma steps) on the CPU.

Exact (tolerance 0) against the one-shot path it replaces, the quotient
of all 25 coset planes at once, with a combine slice narrower than the
quotient domain and coset-FFT launches narrower than the selector count;
and the default prove, which streams, gives the bytes of
tests/fixtures/proof_small.hex.
"""

import random

import torch

from distributed_plonk_tpu_torch import proof_io
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.fields import fr_inv
from distributed_plonk_tpu_torch.prover import _ProveCtx, prove

from test_torch_prove import golden, port_keys

torch.set_num_threads(1)


def _round3_inputs(cx, seed):
    """Random round-3 operands of the prover's widths: five wire polys
    (n + 2 coefficients), the permutation poly (n + 3), the public-input
    poly (n), and the challenges."""
    rng = random.Random(seed)
    be, n = cx.backend, cx.n

    def poly(size):
        return be.lift([rng.randrange(R_MOD) for _ in range(size)])

    beta, gamma, alpha = (rng.randrange(R_MOD) for _ in range(3))
    asdn = alpha * alpha % R_MOD * fr_inv(n) % R_MOD
    return ((n, cx.m, cx.quot_domain, cx.pk.vk.k, beta, gamma, alpha, asdn,
             cx.sel_h, cx.sigma_h),
            ([poly(n + 2) for _ in range(cx.nw)], poly(n + 3), poly(n)))


def test_streamed_quotient_equals_one_shot(monkeypatch):
    ckt, be, pk, _ = port_keys()
    cx = _ProveCtx(pk, be)
    head, (wires, z, pi) = _round3_inputs(cx, 5)
    n, m, dom, k, beta, gamma, alpha, asdn, sel, sig = head
    batch = be.coset_fft_many(dom, list(sel) + list(sig) + wires + [z, pi])
    ns, nw = len(sel), cx.nw
    evals = be.quotient(n, m, dom, k, beta, gamma, alpha, asdn, batch[:ns],
                        batch[ns:ns + nw], batch[ns + nw:ns + 2 * nw],
                        batch[ns + 2 * nw], batch[ns + 2 * nw + 1])
    # slices of m/4 lanes; coset-FFT launches of 3 planes
    monkeypatch.setattr(be, "QUOT_SLICE", m // 4)
    monkeypatch.setattr(be, "STREAM_ELEMS", 3 * m)
    assert torch.equal(be.quotient_streamed(*head, wires, z, pi), evals)


def test_default_prove_streams_and_gives_golden_bytes(monkeypatch):
    """With the fused hook off, the prove streams (the default is the
    fused round 3, tests/test_torch_round3_fused.py)."""
    ckt, be, pk, _ = port_keys()
    monkeypatch.setattr(be, "quotient_poly_streamed", None)
    calls = []
    streamed = be.quotient_streamed

    def spy(*args):
        calls.append(args[1])
        return streamed(*args)
    monkeypatch.setattr(be, "quotient_streamed", spy)
    lowers = be.lowers
    proof = prove(random.Random(1), ckt, pk, be)
    assert proof_io.serialize_proof(proof) == golden()
    assert calls == [_ProveCtx(pk, be).m]
    # no handle leaves the device mid-prove: the one download is round 4's
    # evaluations
    assert be.lowers - lowers == 1
