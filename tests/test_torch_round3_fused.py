"""The port's fused round 3 (TorchBackend.quotient_poly_streamed and
prover_torch's gate_fold, sigma_fold and quotient_combine) on the CPU,
where each fold runs its plain version. Tolerance 0 throughout: every
value is a canonical field element.

- The fused round 3 equals the streamed one followed by the coset iNTT,
  and the one-shot quotient followed by it, with coset-FFT launches of 3
  planes (batches that start and end inside a selector kind); and it
  equals the JAX package's JaxBackend().quotient_poly_streamed (its fused
  path, DPT_R3_FUSE) on the same inputs, word for word.
- Each plain fold equals its sequence of step functions for every batch
  split; the combine equals quotient_combine_slice over [0, m) and its
  slices put together.
- The default prove calls quotient_poly_streamed once, with m, and gives
  the bytes of tests/fixtures/proof_small.hex; MeshBackend and
  PythonBackend do not take the fused path.
- The kernel wrappers refuse CPU tensors; the registry's round-3 entries
  meet their bounds and value contracts.
"""

import random

import numpy as np
import pytest
import torch

from distributed_plonk_tpu import kzg as JK
from distributed_plonk_tpu.poly import Domain as JDomain
from distributed_plonk_tpu_torch import proof_io
from distributed_plonk_tpu_torch.analysis import registry as R
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend import prover_torch as PT
from distributed_plonk_tpu_torch.backend.python_backend import PythonBackend
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.fields import fr_inv
from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
from distributed_plonk_tpu_torch.parallel.mesh_backend import MeshBackend
from distributed_plonk_tpu_torch.prover import _ProveCtx, prove
from distributed_plonk_tpu_torch.runtime.dispatcher import RemoteBackend
from distributed_plonk_tpu_torch.trace import Tracer

from test_torch_keys import _HostCommitJaxBackend
from test_torch_prove import golden, port_keys

torch.set_num_threads(1)

SEED = 7


def _round3_ints(n, seed):
    """Seeded round-3 operands as canonical ints: five wire polys (n + 2
    coefficients), the permutation poly (n + 3), the public-input poly
    (n), and beta, gamma, alpha, alpha^2 / n."""
    rng = random.Random(seed)

    def poly(size):
        return [rng.randrange(R_MOD) for _ in range(size)]

    beta, gamma, alpha = (rng.randrange(R_MOD) for _ in range(3))
    asdn = alpha * alpha % R_MOD * fr_inv(n) % R_MOD
    return ((beta, gamma, alpha, asdn),
            ([poly(n + 2) for _ in range(5)], poly(n + 3), poly(n)))


def _port_args(cx, ints):
    be = cx.backend
    scalars, (wires, z, pi) = ints
    head = (cx.n, cx.m, cx.quot_domain, cx.pk.vk.k) + scalars
    return head, ([be.lift(w) for w in wires], be.lift(z), be.lift(pi))


def test_fused_equals_streamed_and_one_shot(monkeypatch):
    ckt, be, pk, _ = port_keys()
    cx = _ProveCtx(pk, be)
    head, (wires, z, pi) = _port_args(cx, _round3_ints(cx.n, SEED))
    sel, sig, dom = cx.sel_h, cx.sigma_h, cx.quot_domain
    # coset-FFT launches of 3 planes: gate batches [0-2], [3-5], [6-8],
    # [9-11], [12] and sigma batches [0-2], [3-4]
    monkeypatch.setattr(be, "STREAM_ELEMS", 3 * cx.m)
    fused = be.quotient_poly_streamed(*head, sel, sig, wires, z, pi)
    assert fused.shape == (8, cx.m) and fused.dtype == torch.int32
    streamed = be.coset_ifft_h(
        dom, be.quotient_streamed(*head, sel, sig, wires, z, pi))
    batch = be.coset_fft_many(dom, list(sel) + list(sig) + wires + [z, pi])
    ns, nw = len(sel), cx.nw
    one_shot = be.coset_ifft_h(dom, be.quotient(
        *head, batch[:ns], batch[ns:ns + nw], batch[ns + nw:ns + 2 * nw],
        batch[ns + 2 * nw], batch[ns + 2 * nw + 1]))
    assert torch.equal(fused, streamed)
    assert torch.equal(fused, one_shot)


@pytest.fixture(scope="module")
def jax_fused(proven):
    """JAX JaxBackend().quotient_poly_streamed on the test circuit, its
    keys preprocessed on JaxBackend with host commitments, on the
    operands of _round3_ints(n, SEED): (coset constants k, the quotient
    polynomial as port words)."""
    jckt = proven[0]
    srs = JK.universal_setup(jckt.n + 3, tau=0xDEADBEEF)
    jbe = _HostCommitJaxBackend()
    jpk, _ = JK.preprocess(srs, jckt, jbe)
    sel_h, sig_h = jbe.pk_polys(jpk)
    n = jckt.n
    dom = JDomain(6 * (n + 1) + 1)
    scalars, (wires, z, pi) = _round3_ints(n, SEED)
    out = jbe.quotient_poly_streamed(
        n, dom.size, dom, jpk.vk.k, *scalars, sel_h, sig_h,
        [jbe.lift(w) for w in wires], jbe.lift(z), jbe.lift(pi))
    return list(jpk.vk.k), TL.from_jax_limbs(np.asarray(out), "cpu")


def test_fused_equals_the_jax_fused_round3(jax_fused):
    ckt, be, pk, _ = port_keys()
    cx = _ProveCtx(pk, be)
    head, (wires, z, pi) = _port_args(cx, _round3_ints(cx.n, SEED))
    jk, want = jax_fused
    assert list(cx.pk.vk.k) == jk
    got = be.quotient_poly_streamed(*head, cx.sel_h, cx.sigma_h, wires, z,
                                    pi)
    assert got.shape == want.shape == (8, cx.m)
    assert torch.equal(got, want)


def _planes(rng, *shape):
    """Seeded canonical Montgomery words (8, *shape)."""
    count = int(np.prod(shape))
    return TL.lift([rng.randrange(R_MOD) for _ in range(count)],
                   "cpu").reshape((8,) + shape)


LANES = 16


@pytest.mark.parametrize("width", [1, 3, 4, 13])
def test_gate_fold_equals_its_steps(width):
    rng = random.Random(width)
    sel = _planes(rng, 13, LANES)
    wires = _planes(rng, 5, LANES)
    gate = want = _planes(rng, LANES)
    for start in range(0, 13, width):
        count = min(width, 13 - start)
        for j in range(count):
            step, operands = PT.GATE_STEPS[start + j]
            want = step(want, sel[:, start + j],
                        *[wires[:, x] for x in operands])
        batch = sel[:, start:start + count]
        got = PT.gate_fold(gate, batch, wires, start)
        assert torch.equal(got, want), (width, start)
        gate = got


@pytest.mark.parametrize("width", [1, 2, 5])
def test_sigma_fold_equals_its_steps(width):
    rng = random.Random(100 + width)
    sig = _planes(rng, 5, LANES)
    wires = _planes(rng, 5, LANES)
    beta, gamma = rng.randrange(R_MOD), rng.randrange(R_MOD)
    beta_c, gamma_c = (TL.lift_scalar(x, "cpu") for x in (beta, gamma))
    acc2 = want = _planes(rng, LANES)
    for start in range(0, 5, width):
        count = min(width, 5 - start)
        for j in range(count):
            want = PT.sigma_step(want, sig[:, start + j],
                                 wires[:, start + j], beta_c, gamma_c)
        batch = sig[:, start:start + count]
        got = PT.sigma_fold(acc2, batch, wires, start, beta, gamma)
        assert torch.equal(got, want), (width, start)
        acc2 = got


def test_combine_equals_the_slice_over_the_whole_domain():
    rng = random.Random(3)
    wires = _planes(rng, 5, LANES)
    z, gate, acc2, ep, zh, sh = (_planes(rng, LANES) for _ in range(6))
    tabs = {"ep": ep, "zh_inv": zh, "shifted_inv": sh}
    k = [rng.randrange(R_MOD) for _ in range(5)]
    scalars = [rng.randrange(R_MOD) for _ in range(4)]
    got = PT.quotient_combine(wires, z, gate, acc2, tabs, k, *scalars)
    want = PT.quotient_combine_slice(
        [wires[:, j] for j in range(5)], z, gate, acc2, tabs,
        TL.lift(k, "cpu").reshape(8, 5, 1),
        *[TL.lift_scalar(x, "cpu") for x in scalars], 0, LANES)
    assert torch.equal(got, want)
    # the slices of the streamed path put together
    half = LANES // 2
    parts = [PT.quotient_combine_slice(
        [wires[:, j] for j in range(5)], z, gate, acc2, tabs,
        TL.lift(k, "cpu").reshape(8, 5, 1),
        *[TL.lift_scalar(x, "cpu") for x in scalars], j0, half)
        for j0 in (0, half)]
    assert torch.equal(got, torch.cat(parts, dim=1))


def test_default_prove_takes_the_fused_round3(monkeypatch):
    ckt, be, pk, _ = port_keys()
    calls, streamed = [], []
    fused = be.quotient_poly_streamed

    def spy(*args):
        calls.append(args[1])
        return fused(*args)
    monkeypatch.setattr(be, "quotient_poly_streamed", spy)
    monkeypatch.setattr(be, "quotient_streamed",
                        lambda *a: streamed.append(a))
    lowers = be.lowers
    tr = Tracer()
    proof = prove(random.Random(1), ckt, pk, be, tracer=tr)
    assert proof_io.serialize_proof(proof) == golden()
    assert calls == [_ProveCtx(pk, be).m] and streamed == []
    spans = tr.totals(1)
    assert "quotient_stream_fused" in spans
    assert not {"quotient_stream", "coset_ffts", "coset_ifft_quot"} & set(
        spans)
    # no handle leaves the device mid-prove: the one download is round 4's
    # evaluations
    assert be.lowers - lowers == 1


def test_mesh_and_python_backends_keep_their_round3():
    ckt, be, pk, _ = port_keys()
    assert _ProveCtx(pk, be).stream_poly is not None
    mesh_be = MeshBackend(make_mesh(4, device="cpu"))
    cx = _ProveCtx(pk, mesh_be)
    assert cx.stream_poly is None and cx.stream is None
    cx = _ProveCtx(pk, PythonBackend())
    assert cx.stream_poly is None and cx.stream is None
    assert getattr(RemoteBackend, "quotient_poly_streamed", None) is None


def test_kernel_wrappers_refuse_cpu_tensors():
    rng = random.Random(5)
    planes, wires, acc = (_planes(rng, 2, LANES), _planes(rng, 5, LANES),
                          _planes(rng, LANES))
    tabs = {"ep": acc, "zh_inv": acc, "shifted_inv": acc}
    with pytest.raises(ValueError):
        PT.gate_fold_cuda(acc, planes, wires, 0)
    with pytest.raises(ValueError):
        PT.sigma_fold_cuda(acc, planes, wires, 0, 1, 2)
    with pytest.raises(ValueError):
        PT.quotient_combine_cuda(wires, acc, acc, acc, tabs, [1] * 5, 1, 2,
                                 3, 4)


def test_registry_round3_entries_clean():
    """Bounds (no int64 wrap, int32 words out) and the host value
    contracts of the r3/ entries; the value pass reuses each entry's
    trace."""
    entries = [e for e in R.build_registry() if e.name.startswith("r3/")]
    assert len(entries) == 4
    assert all(e.kernel is not None for e in entries)
    for e in entries:
        assert [str(v) for v in e.check(strict=True)] == [], e.name
        assert [str(v) for v in e.check_values(strict=True)] == [], e.name
