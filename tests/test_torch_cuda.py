"""Each of the port's CUDA kernels (csrc/*.cu, round 3's folds included)
against its plain torch version on the card, exactly (tolerance 0: every
value is a canonical integer, and every addition happens in a fixed
order).

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


def _equal(got, want):
    if isinstance(got, (tuple, list)):
        return all(_equal(g, w) for g, w in zip(got, want))
    return torch.equal(got, want)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul_kernel_matches_plain(field):
    dev = _card()
    spec = F.FR if field == "fr" else F.FQ
    a, b = (TL.to_tensor(TL.ints_to_words(_values(spec.mod, 4099, s),
                                          spec.n_words), dev)
            for s in (1, 2))
    assert torch.equal(F.mont_mul_cuda(spec, a, b),
                       F.mont_mul_ref(spec, a, b))


def _words(spec, shape, seed, dev):
    count = int(np.prod(shape))
    vals = _values(spec.mod, max(count, 3), seed)[-count:]
    return TL.to_tensor(TL.ints_to_words(vals, spec.n_words),
                        dev).reshape((spec.n_words,) + tuple(shape))


@pytest.mark.parametrize("lanes", [1, 4099])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul_kernel_strided_and_broadcast(field, lanes):
    """Broadcast scalars, slices x[:, i] of a stacked tensor and two lane
    axes, read through their strides, against the plain version."""
    dev = _card()
    spec = F.FR if field == "fr" else F.FQ
    stacked = _words(spec, (13, lanes), 7, dev)
    cases = [(_words(spec, (1,), 8, dev), _words(spec, (lanes,), 9, dev)),
             (stacked[:, 3], stacked[:, 11]),
             (stacked[:, 5], _words(spec, (lanes,), 10, dev)),
             (stacked[:, 2:6], _words(spec, (4, 1), 11, dev)),
             (_words(spec, (1, 1), 12, dev), stacked)]
    for a, b in cases:
        assert torch.equal(F.mont_mul_cuda(spec, a, b),
                           F.mont_mul_ref(spec, a, b))


def test_mont_mul_broadcast_is_one_launch_and_no_copy():
    """A broadcast (8, 1) operand against (8, 330): torch.profiler sees
    exactly one kernel, kernel 1's, and no copy."""
    dev = _card()
    a = _words(F.FR, (330,), 13, dev)
    z = _words(F.FR, (1,), 14, dev)
    F.mont_mul(F.FR, a, z)
    torch.cuda.synchronize()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        F.mont_mul(F.FR, a, z)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    assert [(e.key.split("(")[0], e.count) for e in device] == [
        ("void mont_mul_kernel<Fr>", 1)], [(e.key, e.count) for e in device]


@pytest.mark.parametrize("batch", [1, 3, 25])
@pytest.mark.parametrize("n", [2, 32, 512, 1 << 13, 1 << 16])
def test_ntt_kernel_matches_plain(n, batch):
    dev = _card()
    plan = N.get_plan(n, dev)
    v = TL.lift(_values(R_MOD, max(n * batch, 3), 3 + n)[:n * batch],
                dev).reshape(8, batch, n)
    for inverse, coset in MODES:
        assert torch.equal(N.ntt_cuda(plan, v, inverse, coset),
                           N.ntt_ref(plan, v, inverse, coset)), (
            n, batch, inverse, coset)


def _key(n, seed, dev):
    rng = np.random.default_rng(seed)
    points = [C.g1_mul(C.G1_GEN, int(rng.integers(1, 1 << 62)))
              for _ in range(n - 2)] + [None, None]
    return M.points_to_device(points, 0, dev)


@pytest.mark.parametrize("shifted", [True, False])
def test_msm_kernels_match_plain(shifted, monkeypatch):
    """msm_digits, bucket_sums (chunk 32 and 2) and msm_tail: the signed
    c = 7 path over 512 base points, in both lane layouts."""
    dev = _card()
    n, B = 512, 3
    px, py, inf = _key(n, 4, dev)
    v = torch.stack([TL.lift(_values(R_MOD, n, 5 + b), dev)
                     for b in range(B)], dim=1)                 # (8, B, n)
    got = M.msm_digits_cuda(v, inf, 7, True, shifted)
    assert _equal(got, M.msm_digits_ref(v, inf, 7, True, shifted))
    ops, keys = got
    lanes = B if shifted else B * M.W7
    # over the base key (n points) or a key of W * n points
    key = M.point_major(px, py)
    if shifted:
        key = key.repeat(M.W7, 1)
    for chunk in (M.CHUNK, 2):
        monkeypatch.setattr(M, "CHUNK", chunk)
        sums = M.bucket_sums_cuda(key, ops, keys, lanes, 64)
        assert _equal(sums, M.bucket_sums_ref(key, ops, keys, lanes, 64))
    assert _equal(M.msm_tail_cuda(*sums, signed=True),
                  M.msm_tail_ref(*sums, signed=True))


@pytest.mark.parametrize("nb", [16, 4, 2])
def test_msm_tail_kernel_matches_plain_unsigned(nb):
    dev = _card()
    px, py, _ = _key(3 * nb, 6, dev)
    sums = tuple(c.reshape(12, 3, nb).contiguous()
                 for c in CT.from_affine(px, py, torch.zeros_like(px[0]) != 0))
    assert _equal(M.msm_tail_cuda(*sums, signed=False),
                  M.msm_tail_ref(*sums, signed=False))


def test_add_kernels_match_plain():
    dev = _card()
    px, py, inf = _key(256, 7, dev)
    p = CT.from_affine(px[:, :128].contiguous(), py[:, :128].contiguous(),
                       inf[:128])
    q = tuple(c.contiguous() for c in CT.proj_add_ref(p, p))
    assert _equal(CT._add_cuda(p, q), CT.proj_add_ref(p, q))
    affine = (px[:, 128:].contiguous(), py[:, 128:].contiguous())
    assert _equal(CT._add_cuda(q, affine), CT.proj_add_mixed_ref(q, affine))
    # the shifted key's build (doublings through the kernel) equals the
    # plain build on the CPU
    assert torch.equal(M.shifted_key(px, py, inf, 7, 3).cpu(),
                       M.shifted_key(px.cpu(), py.cpu(), inf.cpu(), 7, 3))


def test_fixed_base_walk_matches_plain():
    """The fixed-base walk of the device SRS (32 mixed adds of kernel 4,
    then kernel 1) on the card equals the same walk over the plain
    versions on the CPU, coordinate for coordinate; scalar 0 stays the
    identity through the table's infinity flag."""
    dev = _card()
    from distributed_plonk_tpu_torch.backend.fixed_base_torch import \
        FixedBaseContext
    scalars = [0, 1, R_MOD - 1, 2] + _values(R_MOD, 60, 15)
    got = FixedBaseContext(C.G1_GEN, dev).batch_mul(scalars)
    want = FixedBaseContext(C.G1_GEN, "cpu").batch_mul(scalars)
    assert _equal(tuple(c.cpu() for c in got), want)
    assert int(got[2][:, 0].abs().sum()) == 0


def test_streamed_round3_matches_one_shot_at_2p16():
    """quotient_streamed (coset FFTs folded plane by plane, combine in
    slices) equals the one-shot quotient on the card at the 2^13
    workload's quotient domain, m = 2^16."""
    dev = _card()
    from distributed_plonk_tpu_torch.circuit import coset_representatives
    from distributed_plonk_tpu_torch.poly import Domain
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    n = 1 << 13
    dom = Domain(6 * (n + 1) + 1)
    assert dom.size == 1 << 16
    be = TorchBackend(dev)
    vals = iter(_values(R_MOD, 25 * (n + 3), 16))

    def poly(size):
        return be.lift([next(vals) for _ in range(size)])

    sel = [poly(n) for _ in range(13)]
    sig = [poly(n) for _ in range(5)]
    wires = [poly(n + 2) for _ in range(5)]
    z, pi = poly(n + 3), poly(n)
    beta, gamma, alpha, asdn = (next(vals) for _ in range(4))
    head = (n, dom.size, dom, coset_representatives(5), beta, gamma, alpha,
            asdn, sel, sig)
    batch = be.coset_fft_many(dom, sel + sig + wires + [z, pi])
    evals = be.quotient(*head[:8], batch[:13], batch[13:18], batch[18:23],
                        batch[23], batch[24])
    be.QUOT_SLICE = 1 << 14
    be.STREAM_ELEMS = 3 << 16
    assert torch.equal(be.quotient_streamed(*head, wires, z, pi), evals)


def _fr_planes(shape, seed, dev):
    """Canonical Fr words (8, *shape) on dev with the corners 0, 1, r - 1
    in the first lanes."""
    count = int(np.prod(shape))
    return TL.to_tensor(TL.ints_to_words(_values(R_MOD, count, seed), 8),
                        dev).reshape((8,) + tuple(shape))


@pytest.mark.parametrize("start,count", [(0, 13), (0, 4), (4, 4), (8, 4),
                                         (12, 1), (10, 3)])
def test_r3_gate_fold_matches_plain(start, count):
    """r3_gate_fold at every v2 batch, v1's batch of 13 and a batch over
    Q_O, Q_C and Q_ECC, on 4,099 lanes (a ragged last block), from a
    strided view of the planes."""
    dev = _card()
    from distributed_plonk_tpu_torch.backend import prover_torch as PT
    m = 4099
    sel = _fr_planes((count + 1, m), 31 + start, dev)[:, 1:]
    wires = _fr_planes((7, m), 32, dev)[:, :5]
    gate = _fr_planes((m,), 33, dev)
    want = PT.gate_fold_ref(gate, sel, wires, start)
    assert torch.equal(PT.gate_fold_cuda(gate, sel, wires, start), want)
    assert torch.equal(PT.gate_fold(gate, sel, wires, start), want)


@pytest.mark.parametrize("start,count", [(0, 5), (0, 4), (4, 1)])
def test_r3_sigma_fold_matches_plain(start, count):
    dev = _card()
    from distributed_plonk_tpu_torch.backend import prover_torch as PT
    m = 4099
    sig = _fr_planes((count, m), 41, dev)
    wires = _fr_planes((5, m), 42, dev)
    acc2 = _fr_planes((m,), 43, dev)
    beta, gamma = _values(R_MOD, 5, 44)[3:]
    want = PT.sigma_fold_ref(acc2, sig, wires, start, beta, gamma)
    assert torch.equal(PT.sigma_fold_cuda(acc2, sig, wires, start, beta,
                                          gamma), want)


def test_r3_combine_matches_plain():
    dev = _card()
    from distributed_plonk_tpu_torch.backend import prover_torch as PT
    m = 4099
    wires = _fr_planes((5, m), 51, dev)
    z, gate, acc2, ep, zh, sh = _fr_planes((6, m), 52, dev).unbind(1)
    tabs = {"ep": ep, "zh_inv": zh, "shifted_inv": sh}
    vals = _values(R_MOD, 12, 53)[3:]
    args = (wires, z, gate, acc2, tabs, vals[:5]) + tuple(vals[5:9])
    assert torch.equal(PT.quotient_combine_cuda(*args),
                       PT.quotient_combine_ref(*args))


def test_fused_round3_matches_streamed_at_2p16():
    """quotient_poly_streamed (one kernel per fold) equals the streamed
    round 3 followed by the coset iNTT at m = 2^16, in batches of 3 planes
    and of the default width."""
    dev = _card()
    from distributed_plonk_tpu_torch.backend import _build
    from distributed_plonk_tpu_torch.circuit import coset_representatives
    from distributed_plonk_tpu_torch.poly import Domain
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    n = 1 << 13
    dom = Domain(6 * (n + 1) + 1)
    be = TorchBackend(dev)
    vals = iter(_values(R_MOD, 25 * (n + 3), 17))

    def poly(size):
        return be.lift([next(vals) for _ in range(size)])

    sel = [poly(n) for _ in range(13)]
    sig = [poly(n) for _ in range(5)]
    wires = [poly(n + 2) for _ in range(5)]
    z, pi = poly(n + 3), poly(n)
    beta, gamma, alpha, asdn = (next(vals) for _ in range(4))
    head = (n, dom.size, dom, coset_representatives(5), beta, gamma, alpha,
            asdn, sel, sig)
    want = be.coset_ifft_h(dom, be.quotient_streamed(*head, wires, z, pi))
    for width in (None, 3):
        if width is not None:
            be.STREAM_ELEMS = width << 16
        _build.reset_launches()
        got = be.quotient_poly_streamed(*head, wires, z, pi)
        assert torch.equal(got, want), width
        folds = -(-13 // (width or 32)), -(-5 // (width or 32))
        assert (_build.LAUNCHES["r3_gate_fold"],
                _build.LAUNCHES["r3_sigma_fold"],
                _build.LAUNCHES["r3_combine"]) == folds + (1,)


@pytest.mark.parametrize("n", [1 << 16, 1 << 21])
@pytest.mark.parametrize("inverse,coset", MODES)
def test_stage_panels_match_plain(n, inverse, coset):
    """The fleet worker's stage panels (kernels 1 and 2 over a whole
    FFT1 row panel and FFT2 column panel) against the same steps through
    the plain versions, on the same tables, at the v1 and v2 quotient
    domains: worker 1's rows and columns in a 4-worker plan."""
    from distributed_plonk_tpu_torch.runtime.dispatcher import _split_rc
    from distributed_plonk_tpu_torch.runtime.torch_stages import \
        StageKernels
    from distributed_plonk_tpu_torch.runtime.worker import FftTask
    dev = _card()
    r, c = _split_rc(n)
    rows = [c * j // 4 for j in range(5)]
    cols = [(r * j // 4, r * (j + 1) // 4) for j in range(4)]
    task = FftTask(inverse, coset, n, r, c, rows[1], rows[2], cols, 1)
    st = StageKernels(dev)
    gen = torch.Generator(device="cpu").manual_seed(n + 2 * inverse + coset)
    for stage, (count, size) in ((1, (rows[2] - rows[1], r)),
                                 (2, (cols[1][1] - cols[1][0], c))):
        # random canonical words: a top word below 2^30 keeps each value
        # below the modulus
        v = torch.randint(-2**31, 2**31, (8, count, size),
                          dtype=torch.int32, generator=gen).to(dev)
        v[7] &= 0x3FFFFFFF
        if stage == 1:
            tables = dict(zip(("pre", "mid"),
                              st._stage1_tables(task, rows[1], rows[2])))
        else:
            tables = {"post": st._stage2_tables(task, *cols[1])}
        got = st.panel_words(v, size, inverse, **tables)
        want = st.panel_words(v, size, inverse, plain=True, **tables)
        assert torch.equal(got, want), (stage, n, inverse, coset)


@pytest.mark.parametrize("inverse,coset", MODES)
def test_mesh_ntt_matches_single_card_ntt(inverse, coset):
    """The 4-step mesh NTT over four shards of the card (kernels 1 and 2
    on each shard's rows, the all-to-all as tile copies) against the
    single-card kernel 2 and its plain version at 2^16, batch 2."""
    from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
    from distributed_plonk_tpu_torch.parallel.ntt_mesh import MeshNttPlan
    dev = _card()
    n = 1 << 16
    gen = torch.Generator(device="cpu").manual_seed(n + 2 * inverse + coset)
    v = torch.randint(-2**31, 2**31, (8, 2, n), dtype=torch.int32,
                      generator=gen).to(dev)
    v[7] &= 0x3FFFFFFF
    got = MeshNttPlan(make_mesh(4, dev), n).ntt(v, inverse, coset)
    plan = N.get_plan(n, dev)
    assert torch.equal(got, N.ntt_cuda(plan, v, inverse, coset))
    assert torch.equal(got, N.ntt_ref(plan, v, inverse, coset))


def test_mesh_msm_matches_single_card_msm():
    """The range-sharded MSM over four shards of the card (kernel 3 per
    shard, the planes folded by kernel 4) against the single-card
    MsmContext over the same 1,000 bases."""
    from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
    from distributed_plonk_tpu_torch.parallel.msm_mesh import MeshMsmContext
    dev = _card()
    bases = [C.g1_mul(C.G1_GEN, k + 2) for k in range(1000)]
    hs = [TL.lift(_values(R_MOD, 1000, 90 + k), dev) for k in range(3)]
    got = MeshMsmContext(make_mesh(4, dev), bases).msm_mont_limbs_many(hs)
    assert got == M.MsmContext(bases, dev).msm_mont_limbs_many(hs)


@pytest.mark.parametrize("inverse,coset", MODES)
def test_mesh_sharded_ntt_matches_single_card_ntt(inverse, coset):
    """The mesh NTT on lane blocks in and out (the entry and exit tile
    exchanges, parallel/sharded.py's layout) over four shards of the card
    against the single-card kernel 2 at 2^16, batch 2."""
    from distributed_plonk_tpu_torch.parallel import sharded as S
    from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
    from distributed_plonk_tpu_torch.parallel.ntt_mesh import MeshNttPlan
    dev = _card()
    n = 1 << 16
    gen = torch.Generator(device="cpu").manual_seed(n + 2 * inverse + coset)
    v = torch.randint(-2**31, 2**31, (8, 2, n), dtype=torch.int32,
                      generator=gen).to(dev)
    v[7] &= 0x3FFFFFFF
    mesh = make_mesh(4, dev)
    blocks, _ = S.take_many(mesh, [v[:, 0], v[:, 1]], 0, n, n // 4)
    got = MeshNttPlan(mesh, n).ntt(blocks, inverse, coset, sharded=True)
    want = N.ntt_cuda(N.get_plan(n, dev), v, inverse, coset)
    assert torch.equal(torch.cat(got, dim=2), want)


def test_mesh_sharded_round_math_matches_torch_backend():
    """MeshBackend's round math on sharded handles (4 shards of the card,
    min_local 1) against TorchBackend's on the whole handles: the linear
    combination, blinding, synthetic division, evaluation, degree and
    split of handles of 2^13 + 3 lanes, kernel 1 for every product."""
    from distributed_plonk_tpu_torch.backend.torch_backend import \
        TorchBackend
    from distributed_plonk_tpu_torch.parallel import sharded as S
    from distributed_plonk_tpu_torch.parallel.mesh import make_mesh
    from distributed_plonk_tpu_torch.parallel.mesh_backend import \
        MeshBackend
    dev = _card()
    n = 1 << 13
    be = MeshBackend(make_mesh(4, dev), min_local=1)
    ref = TorchBackend(device=dev)
    polys = [_values(R_MOD, n + k, 200 + k) for k in range(4)]
    z = _values(R_MOD, 1, 210)[0]
    hs, ws = [be.lift(p) for p in polys], [ref.lift(p) for p in polys]
    assert all(isinstance(h, S.Sharded) for h in hs)
    lin = be.lin_comb_h(hs, [3, 5, 7, 11])
    lin_w = ref.lin_comb_h(ws, [3, 5, 7, 11])
    assert torch.equal(S.gather(lin), lin_w)
    blinded = be.blind(hs[0], [1, 2], n)
    assert torch.equal(S.gather(blinded), ref.blind(ws[0], [1, 2], n))
    assert torch.equal(S.gather(be.synth_div_h(lin, z)),
                       ref.synth_div_h(lin_w, z))
    assert be.eval_many_h([(h, z) for h in hs]) == \
        ref.eval_many_h([(w, z) for w in ws])
    assert be.degree_is(hs[3], n + 2) == ref.degree_is(ws[3], n + 2)
    size = n // 3 + 1                   # pieces straddle the shards
    for a, b in zip(be.split(lin, size, 3, n), ref.split(lin_w, size, 3,
                                                         n)):
        assert torch.equal(S.gather(a), b)
