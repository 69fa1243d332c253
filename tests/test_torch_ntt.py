"""Port NTT (backend/ntt_torch.py) vs the JAX package's ntt_jax and the
poly.py oracle, exactly, in all four (inverse, coset) modes at the
Montgomery boundary, for odd and even log2 n.

The JAX side is ntt_jax.get_plan(n).kernel(...) on its XLA stage core;
the port side is kernel 2's plain version (ntt_ref), which runs the
kernel's pass schedule with its tables and index maps. Schedules of one,
two, three and four passes are reached at small n by cutting the stages
per pass (max_log_rows). A line-by-line Python transliteration of the
CUDA pass kernel's tile loop (shared-memory slots, stage indices,
bit-reversed stores, boundary scales) checks the kernel's own address
arithmetic against the plain version, which the card alone could
otherwise show.
"""

import numpy as np
import pytest
import torch

from distributed_plonk_tpu import poly as P
from distributed_plonk_tpu.backend import ntt_jax
from distributed_plonk_tpu.backend import prover_jax as PJ
from distributed_plonk_tpu.constants import R_MOD
from distributed_plonk_tpu_torch.backend import field_torch as F
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
    return vals[:n]


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


# (n, max_log_rows, passes), at the sizes the test above compiles on the
# JAX side: one pass, two passes of 2^4 x 2^3 (odd log2 n), three passes
# above 2^(2R) with R cut to 2 and 3 (even and odd log2 n), four passes
SCHEDULES = [(8, 8, 1), (64, 8, 1), (128, 4, 2), (64, 2, 3), (128, 3, 3),
             (128, 2, 4)]


@pytest.mark.parametrize("n,rows,passes", SCHEDULES)
def test_ntt_pass_schedules_match_ntt_jax_and_oracle(n, rows, passes):
    """Batch 2, every mode: each row equals ntt_jax and the poly.py
    oracle exactly."""
    domain = P.Domain(n)
    plan_j = ntt_jax.get_plan(n)
    plan_t = N.get_plan(n, "cpu", rows)
    assert len(plan_t.digits) == passes and sum(plan_t.digits) == \
        n.bit_length() - 1
    for k, (inverse, coset) in enumerate(MODES):
        vals = [_values(n, 1000 * n + 10 * k + b) for b in range(2)]
        batch = torch.stack([TL.lift(v, "cpu") for v in vals], dim=1)
        got = N.ntt(plan_t, batch, inverse, coset)
        for b in range(2):
            want = np.asarray(plan_j.kernel(inverse=inverse, coset=coset,
                                            boundary="mont")(
                PJ.lift(vals[b])))
            assert np.array_equal(TL.to_jax_limbs(got[:, b]), want), (
                n, rows, inverse, coset, b)
            assert TL.lower(got[:, b]) == _oracle(domain, vals[b], inverse,
                                                  coset)


def test_split_digits_main_path():
    """The main path's shapes: 2^16 in two passes of 2^8, 2^13 in 2^7 x
    2^6, anything up to 2^8 in one pass."""
    assert N.split_digits(16) == [8, 8]
    assert N.split_digits(13) == [7, 6]
    assert N.split_digits(8) == [8] and N.split_digits(1) == [1]
    assert N.split_digits(17) == [6, 6, 5]


_R_INV = pow(1 << 256, -1, R_MOD)


def _ints(t):
    return TL.words_to_ints(TL.to_numpy(t.reshape(8, -1)))


def _slot(r, c, log_cols):
    return (r << log_cols) + c + (r >> (5 - log_cols))


def _emulate_kernel(plan, v, inverse, coset):
    """csrc/ntt.cu's dpt_ntt_pass / ntt_pass_kernel, transliterated: the
    same geometry integers, tile decomposition, shared-memory slots, stage
    loop, bit-reversed store and scales, on Montgomery ints."""
    passes, pre, post = plan.tables(inverse, coset)
    n, B = plan.n, v.shape[1]

    def mm(a, b):
        return a * b * _R_INV % R_MOD

    pre = _ints(pre) if pre is not None else None
    post = _ints(post) if post is not None else None
    src = _ints(v)
    for p, ps in enumerate(passes):
        g = dict(zip(N.NttPass.ORDER, ps.geometry(B)))
        log_rows, log_cols = g["log_rows"], g["log_cols"]
        rows, cols = 1 << log_rows, 1 << log_cols
        words = (1 << (log_rows + log_cols)) + (rows >> (5 - log_cols))
        stage = _ints(ps.stage_table)
        assert len(stage) == g["stage_words"]
        tw = _ints(ps.tw_table) if ps.tw_table is not None else None
        lv = ps.lv_table.tolist() if ps.lv_table is not None else None
        dst = list(src) if not ps.last else [None] * (B * n)
        for tile in range(g["tiles"]):
            b, rem = divmod(tile, g["mids"] * g["tiles_per_mid"])
            mid, t = divmod(rem, g["tiles_per_mid"])
            in_base = mid * g["in_mid"] + t * g["in_tile"]
            s = {}
            for e in range(rows * cols):
                c, r = e & (cols - 1), e >> log_cols
                at = _slot(r, c, log_cols)
                assert at < words and at not in s
                s[at] = src[b * n + in_base + c * g["in_col"]
                            + r * g["in_row"]]
            for st in range(log_rows):
                log_half = log_rows - st - 1
                half = 1 << log_half
                off = rows - (rows >> st)
                assert stage[off] == F.FR.mont_r     # w^0: skipped product
                for q in range(rows * cols // 2):
                    c = q & (cols - 1)
                    blk = (q >> log_cols) & ((1 << st) - 1)
                    k = q >> (log_cols + st)
                    r0 = (blk << (log_half + 1)) + k
                    a0, a1 = _slot(r0, c, log_cols), \
                        _slot(r0 + half, c, log_cols)
                    u, w = s[a0], s[a1]
                    if p == 0 and st == 0 and pre is not None:
                        i0 = in_base + c * g["in_col"] + r0 * g["in_row"]
                        u = mm(u, pre[i0])
                        w = mm(w, pre[i0 + half * g["in_row"]])
                    s[a0] = (u + w) % R_MOD
                    s[a1] = (mm((u - w) % R_MOD, stage[off + k]) if k
                             else (u - w) % R_MOD)
            out_base = (lv[mid] if lv is not None else mid * g["out_mid"]) \
                + t * g["out_tile"]
            for e in range(rows * cols):
                c, k = e & (cols - 1), e >> log_cols
                pos = int(format(k, "0%db" % log_rows)[::-1], 2)
                u = s[_slot(pos, c, log_cols)]
                if tw is not None:
                    u = mm(u, tw[k * g["tw_row"] + t * g["tw_tile"] + c])
                o = out_base + c * g["out_col"] + k * g["out_row"]
                if ps.last and post is not None:
                    u = mm(u, post[o])
                dst[b * n + o] = u
        assert None not in dst
        src = dst
    return src


@pytest.mark.parametrize("n,rows", [(2, 8), (64, 8), (512, 8), (32, 2),
                                    (128, 3)])
def test_cuda_pass_kernel_arithmetic_matches_plain(n, rows):
    """The transliterated kernel equals ntt_ref word for word, batch 3,
    every mode: the slots are distinct and within the buffer, and every
    output is written once."""
    plan = N.get_plan(n, "cpu", rows)
    v = torch.stack([TL.lift(_values(n, 77 + b), "cpu") for b in range(3)],
                    dim=1)
    for inverse, coset in MODES:
        want = _ints(N.ntt_ref(plan, v, inverse, coset))
        assert _emulate_kernel(plan, v, inverse, coset) == want, (
            n, rows, inverse, coset)


def test_run_ints_round_trips():
    n = 32
    vals = _values(n, 3)
    plan = N.get_plan(n, "cpu")
    assert plan.run_ints(plan.run_ints(vals), inverse=True) == vals
    assert plan.run_ints(plan.run_ints(vals, coset=True), inverse=True,
                         coset=True) == vals
