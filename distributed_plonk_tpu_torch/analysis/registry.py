"""Kernel registry: the port's production entry points the verifier proves.

One `Entry` per entry point, with its plain function (the aten graph the
bounds and exact-value passes read), its declared argument bounds, and,
where a kernel exists, its CUDA entry: on the card the value pass holds
the kernel's output to the same contract on the same samples. Families:

- field/: `mont_mul_ref` for Fr and Fq (card: kernel 1, also on broadcast
  and strided operands), add / sub / neg / to_mont / from_mont, `_sweep32`
  at its full input range, the 16-bit split and join of the plain
  multiplier (`words_roundtrip`), `cumsum`;
- ntt/: `ntt_ref` in all four (inverse, coset) modes at log n = 5 and 6,
  one mode in 2 and 3 passes, a batch of 3 (card: kernel 2);
- msm/: the digit recodes at the prover's widths n + 2 and n + 3,
  `msm_digits_ref` signed and unsigned (card: kernel 3's msm_digits), and
  `bucket_sums_ref` / `msm_tail_ref` (bounds only, as the JAX package's
  bucket and finish entries are);
- curve/: `proj_add_ref`, `proj_add_mixed_ref` (bounds only);
- eval/: `poly_eval` / `poly_eval_many` (card: kernel 1);
- r3/: round 3's folds, `gate_fold_ref` (all 13 selectors, and a batch
  that starts and ends inside a kind), `sigma_fold_ref`,
  `quotient_combine_ref` (card: csrc/round3.cu).

`card_entries()` adds one main-path shape per kernel for the card half
alone: kernel 1 at 2^16 lanes, kernel 2 at n = 2^13 in each mode, kernel
3's msm_digits over a round-1 batch of 5 handles of width n + 2, and the
three round-3 folds at 2^12 lanes (16 blocks).

Shapes are representative, not production-sized: every interval rule is
width-generic, and the loops of the plain versions repeat one step on the
same intervals. Where a plain version loops far more at production size
(poly_eval's Horner chunk, the bucket and tail adds), the entry says how
it was cut.
"""

import numpy as np
import torch

from ..constants import R_MOD
from . import bounds as B
from . import values as V
from .bounds import Bound, word_rows

U16 = (1 << 16) - 1
U32 = (1 << 32) - 1
I32 = ((-(1 << 31)), (1 << 31) - 1)


class ValueObligation:
    """A machine-checked value contract for a registry entry.

    sampler(rng) -> CPU tensors; contract(args, outs) -> error strings.
    `fn` overrides the entry fn for the host pass when a cheaper
    instantiation of the same code serves (a shorter Horner chunk);
    `kernel` overrides the entry's kernel on the card likewise."""

    def __init__(self, sampler, contract, samples=1, fn=None, kernel=None):
        self.sampler = sampler
        self.contract = contract
        self.samples = samples
        self.fn = fn
        self.kernel = kernel


class Entry:
    """A production entry point: plain `fn` at `args` (Bounds or concrete
    tensors), its postcondition `out_bounds`, its value obligation, and
    `kernel`, the CUDA entry (None: no kernel), counted under `launches`
    (the _build launch counter it bumps). `trace_args(rng)` gives the
    trace's concrete arguments where a Bound sample would not be a
    consistent input (the MSM's op words and sort keys). A `card_only`
    entry has no host passes (a main-path shape)."""

    def __init__(self, name, fn, args, out_bounds=None, value=None,
                 kernel=None, launches=None, trace_args=None,
                 card_only=False):
        self.name = name
        self.fn = fn
        self.args = tuple(args)
        self.out_bounds = out_bounds
        self.value = value
        self.kernel = kernel
        self.launches = launches
        self.trace_args = trace_args
        self.card_only = card_only
        self._graphs = {}

    def graph(self):
        """The plain fn's graph at the declared shapes, traced once."""
        if self.trace_args is not None:
            args = tuple(self.trace_args(np.random.default_rng(0)))
        else:
            args = B.sample_args(self.args)
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = B.trace(self.fn, args)
        return g

    def check(self, strict=True):
        if self.card_only:
            return []
        try:
            g = self.graph()
        except B.TraceDiverged as e:
            return [B.Violation(self.name, "trace", str(e))]
        return B.check_graph(self.name, g, B.input_vals(self.args),
                             self.out_bounds, strict)

    def check_values(self, strict=True, seed=0, device="cpu"):
        """The value contract on the host (exact evaluation of the plain
        graph) or on the card (the kernel); None when the entry has no
        obligation there."""
        ob = self.value
        if ob is None:
            return None
        card = torch.device(device).type == "cuda"
        if card and self.kernel is None:
            return None
        if not card and self.card_only:
            return None
        # the host pass reuses the bounds trace when it runs the same fn
        graphs = self._graphs if ob.fn is None else None
        return V.check_value(self.name, ob.fn or self.fn, ob.sampler,
                             ob.contract, samples=ob.samples, seed=seed,
                             strict=strict, device=device,
                             kernel=ob.kernel or self.kernel,
                             graphs=graphs)


# -- samplers / contracts ------------------------------------------------------
#
# Sample points are seeded field elements PLUS the corners 0, 1, p-1 in
# fixed lanes: a dropped carry, an off-by-one limb shift, a wrong modulus or
# a stale twiddle changes the value at almost every point, so a handful of
# samples rejects each, while the corners pin the conditional-subtract and
# carry-out edges random sampling would miss.

def _fe_lane_vals(rng, p, lanes):
    vals = [0, 1, p - 1][:lanes]
    return vals + [V.rand_fe(rng, p) for _ in range(lanes - len(vals))]


def _fe_tensor(rng, spec, lanes, shape=None, shuffle=True):
    vals = _fe_lane_vals(rng, spec.mod, lanes)
    if shuffle:
        rng.shuffle(vals)   # corners meet corners across samples
    return V.word_tensor(vals, spec.n_words, shape)


def _field_sampler(spec, shapes):
    """One (L, *shape) word tensor per shape."""
    def sample(rng):
        return tuple(_fe_tensor(rng, spec, int(np.prod(s)), s)
                     for s in shapes)
    return sample


def _mod_fn(spec, op):
    p, R = spec.mod, V.mont_r(spec)
    rinv = pow(R, -1, p)
    return {
        "mont_mul": lambda a, b: a * b * rinv % p,
        "add": lambda a, b: (a + b) % p,
        "sub": lambda a, b: (a - b) % p,
        "neg": lambda a: -a % p,
        "to_mont": lambda a: a * R % p,
        "from_mont": lambda a: a * rinv % p,
    }[op]


def _mod_contract(spec, op, view=None):
    """value(out) as a function of value(in) mod p, plus canonicality (out
    < p): the claim each field entry's docstring makes. `view` maps the
    sampled first operand to what the kernel reads (a strided slice)."""
    p = spec.mod
    fn = _mod_fn(spec, op)
    nargs = fn.__code__.co_argcount

    def contract(args, outs):
        args = list(args)
        if view is not None:
            args[0] = view(args[0])
        ins = [V.word_value(V.to_exact(a)) for a in args[:nargs]]
        want = V.elementwise(lambda *vs: fn(*[int(x) for x in vs]), *ins)
        got = V.word_value(outs[0])
        errs = V.mismatch_report("value(out) == %s(value(in)) mod p" % op,
                                 got, want)
        over = sum(int(g) >= p for g in got.reshape(-1))
        if over:
            errs.append("%s: output not canonical (>= p) in %d lane(s)"
                        % (op, over))
        return errs
    return contract


def _sweep32_value(K=8, lanes=6):
    top = (1 << 62) - 1

    def sampler(rng):
        cols = rng.integers(0, top, size=(K, lanes), dtype=np.int64,
                            endpoint=True)
        cols[:, 0] = 0          # corner: all-zero columns
        cols[:, 1] = top        # corner: every column at its bound
        return (torch.from_numpy(cols),)

    def contract(args, outs):
        vc = V.col_value(V.to_exact(args[0]), 32)
        vw = V.col_value(outs[0], 32)
        carry = V.elementwise(lambda c: int(c) << (32 * K), outs[1])
        errs = V.mismatch_report(
            "value(words) + carry*2^(32K) == value(cols)", vw + carry, vc)
        if any(int(w) >> 32 for w in outs[0].reshape(-1)):
            errs.append("a word is not below 2^32")
        return errs
    return ValueObligation(sampler, contract, samples=2)


def _roundtrip_value(shape=(16, 8)):
    def sampler(rng):
        v = rng.integers(0, U16, size=shape, dtype=np.int64, endpoint=True)
        v.reshape(-1)[0] = 0
        v.reshape(-1)[1] = U16
        return (torch.from_numpy(v),)

    def contract(args, outs):
        from ..backend import limbs
        errs = V.mismatch_report("16-bit split/join roundtrip identity",
                                 outs[0], V.to_exact(args[0]))
        host = limbs.to_jax_limbs(limbs.from_jax_limbs(
            args[0].numpy().astype(np.uint32), "cpu"))
        errs += V.mismatch_report("limbs.from_jax_limbs/to_jax_limbs "
                                  "roundtrip identity", V.to_exact(host),
                                  V.to_exact(args[0]))
        return errs
    return ValueObligation(sampler, contract, samples=2)


def _cumsum_value(spec, lanes=8):
    p = spec.mod

    def sampler(rng):
        return (_fe_tensor(rng, spec, lanes, shuffle=False),)

    def contract(args, outs):
        vin = V.word_value(V.to_exact(args[0]))
        got = V.word_value(outs[0])
        acc, want = 0, []
        for x in vin.reshape(-1):
            acc = (acc + int(x)) % p
            want.append(acc)
        return V.mismatch_report("inclusive prefix sums mod p", got,
                                 np.array(want, dtype=object))
    return ValueObligation(sampler, contract, samples=2)


def _ntt_oracle(n, inverse, coset):
    from .. import poly as P
    dom = P.Domain(n)
    if inverse and coset:
        return lambda vs: P.coset_ifft(dom, vs)
    if inverse:
        return lambda vs: P.ifft(dom, vs)
    if coset:
        return lambda vs: P.coset_fft(dom, vs)
    return lambda vs: P.fft(dom, vs)


def _ntt_value(n, inverse, coset, rows=1, samples=1):
    """value(out) == DFT(value(in)) against the port's pure-Python poly
    oracle, row by row. Fr-linearity makes the oracle apply to the raw
    handle values: Montgomery form scales by R, and the DFT commutes with
    scalar multiplication."""
    from ..constants import R_MOD
    from ..backend.field_torch import FR
    oracle = _ntt_oracle(n, inverse, coset)

    def sampler(rng):
        vals = [V.rand_fe(rng, R_MOD) for _ in range(rows * n)]
        vals[0], vals[1], vals[2] = 0, 1, R_MOD - 1
        return (V.word_tensor(vals, FR.n_words, (rows, n)),)

    def contract(args, outs):
        vin = V.word_value(V.to_exact(args[0])).reshape(-1, n)
        got = V.word_value(outs[0]).reshape(-1, n)
        errs = []
        for b in range(vin.shape[0]):
            want = list(oracle([int(x) for x in vin[b]]))
            row = [int(x) for x in got[b]]
            if any(x >= R_MOD for x in row):
                errs.append("row %d: output not canonical (>= r)" % b)
            if row != want:
                k = next(i for i in range(n) if row[i] != want[i])
                nbad = sum(r != w for r, w in zip(row, want))
                errs.append("row %d: mismatch vs poly oracle at lane %d "
                            "(%d/%d lanes differ)" % (b, k, nbad, n))
        return errs
    return ValueObligation(sampler, contract, samples=samples)


def _scalars(words):
    """Montgomery handles -> their canonical scalars (from_mont)."""
    from ..constants import R_MOD
    rinv = pow(1 << 256, -1, R_MOD)
    return V.elementwise(lambda v: int(v) * rinv % R_MOD,
                         V.word_value(V.to_exact(words)))


def _digits_value(Lw, c, bias, padded):
    """sum_w (digit_w - bias) * 2^(c w) reconstructs from_mont(handle)
    exactly, per lane, zero on padding: the recombination equation the
    bucket accumulation relies on (bias 0 = unsigned)."""
    from ..backend.field_torch import FR

    def sampler(rng):
        return (_fe_tensor(rng, FR, Lw, shuffle=False),)

    def contract(args, outs):
        scal = list(_scalars(args[0]).reshape(-1))
        d = np.asarray(outs[0], dtype=object)
        W, width = d.shape
        errs = []
        if width != padded:
            return ["digits: %d lanes, want the padded %d" % (width, padded)]
        rec = np.zeros(width, dtype=object)
        for w in range(W):
            rec = rec + ((d[w] - bias) << (c * w))
        for j in range(width):
            want = scal[j] if j < len(scal) else 0
            if rec[j] != want:
                errs.append("digit recombination wrong at lane %d: "
                            "sum((d-%d)*2^(%dw)) = %d, scalar = %d"
                            % (j, bias, c, rec[j], want))
                break
        return errs
    return ValueObligation(sampler, contract, samples=1)


def _msm_digits_value(B_, n, c, signed, shifted, width=None, inf_lanes=(),
                      samples=1):
    """msm_digits' op words decoded by signed_ops / unsigned_ops' layout
    (bucket | neg << 8 | skip << 9) recombine to each handle's scalar; a
    point at infinity skips every window; each sort key is lane * nb +
    bucket, or the sentinel lanes * nb for a skip. `width`: the handles'
    width before the zero padding to the key's n points."""
    from ..backend import msm_torch as M
    from ..backend.field_torch import FR
    W = M.W7 if signed else M.SCALAR_BITS // c
    nb = 1 << (c - 1) if signed else 1 << c
    lanes = B_ if shifted else B_ * W
    width = n if width is None else width

    def sampler(rng):
        hs = [_fe_tensor(rng, FR, width, shuffle=False)
              for _ in range(B_)]
        v = torch.nn.functional.pad(torch.stack(hs, dim=1),
                                    (0, n - width))
        inf = torch.zeros(n, dtype=torch.bool)
        inf[list(inf_lanes)] = True
        return v, inf

    def contract(args, outs):
        v, inf = args
        ops = np.asarray(outs[0], dtype=np.int64)
        keys = np.asarray(outs[1], dtype=np.int64)
        errs = []
        if ops.shape != (B_, W, n) or keys.shape != (B_, W, n):
            return ["msm_digits: outputs %s / %s, want (%d, %d, %d)"
                    % (ops.shape, keys.shape, B_, W, n)]
        skip = (ops >> M.SKIP_BIT) & 1
        bucket = ops & 0xFF
        if signed:
            neg = (ops >> M.NEG_BIT) & 1
            d = np.where(neg == 1, -(bucket + 1), bucket + 1)
        else:
            d = bucket
        d = np.where(skip == 1, 0, d)
        infm = inf.numpy()
        if not np.all(skip[:, :, infm] == 1):
            errs.append("a point at infinity does not skip every window")
        live = (skip == 0)
        if np.any(live & (d == 0)):
            errs.append("a live op word selects digit 0")
        if ops.min() < 0 or ops.max() >= 1 << (M.SKIP_BIT + 1):
            errs.append("op words outside the 10-bit layout")
        lane = np.arange(B_).reshape(B_, 1, 1) if shifted else \
            np.arange(B_ * W).reshape(B_, W, 1)
        want_keys = np.where(skip == 1, lanes * nb, lane * nb + bucket)
        if not np.array_equal(keys, want_keys):
            bad = np.argwhere(keys != want_keys)[0]
            errs.append("sort key wrong at %s: %d, want %d" % (
                tuple(bad), keys[tuple(bad)], want_keys[tuple(bad)]))
        scal = _scalars(v.reshape(FR.n_words, -1)).reshape(B_, n)
        rec = np.zeros((B_, n), dtype=object)
        for w in range(W):
            rec = rec + (d[:, w, :].astype(object) << (c * w))
        for b in range(B_):
            for j in range(n):
                want = 0 if infm[j] else scal[b, j]
                got = 0 if infm[j] else rec[b, j]
                if got != want:
                    errs.append("handle %d lane %d: digits recombine to "
                                "%d, scalar %d" % (b, j, got, want))
                    return errs
        return errs
    return ValueObligation(sampler, contract, samples=samples)


def _eval_value(Lc, batch=None, fn=None):
    """value(out) == sum_i c_i z^i in raw-value terms: coefficients and
    point arrive in Montgomery form (c_i = v_i R^-1, z = vz R^-1);
    poly_eval returns the Montgomery form of p(z), poly_eval_many the
    canonical value."""
    from ..constants import R_MOD
    from ..backend.field_torch import FR
    R = 1 << 256
    rinv = pow(R, -1, R_MOD)
    B_ = batch or 1

    def sampler(rng):
        ps = torch.stack([_fe_tensor(rng, FR, Lc, shuffle=False)
                          for _ in range(B_)], dim=1)
        zs = torch.stack([V.word_tensor([V.rand_fe(rng, R_MOD)], FR.n_words)
                          for _ in range(B_)], dim=1)
        return ps, zs

    def contract(args, outs):
        vin = V.word_value(V.to_exact(args[0])).reshape(B_, Lc)
        vz = V.word_value(V.to_exact(args[1])).reshape(B_)
        got = V.word_value(outs[0]).reshape(-1)
        errs = []
        for b in range(B_):
            cs = [int(x) * rinv % R_MOD for x in vin[b]]
            z = int(vz[b]) * rinv % R_MOD
            pz = 0
            for c in reversed(cs):
                pz = (pz * z + c) % R_MOD
            want = pz if batch else pz * R % R_MOD
            if int(got[b]) != want:
                errs.append("poly %d: p(z) value mismatch: got %d, want %d"
                            % (b, int(got[b]), want))
        return errs
    return ValueObligation(sampler, contract, samples=1, fn=fn)


# -- the families --------------------------------------------------------------

def _field_entries():
    from ..backend import field_torch as F

    out = []
    for spec in (F.FR, F.FQ):
        L = spec.n_words
        n = spec.name.lower()
        words = [I32]

        def mm(s=spec):
            return (lambda a, b: F.mont_mul_ref(s, a, b),
                    lambda a, b: F.mont_mul_cuda(s, a, b))
        plain, card = mm()
        out.append(Entry(
            "field/%s_mont_mul" % n, plain, (word_rows(L, 8),) * 2, words,
            value=ValueObligation(_field_sampler(spec, [(8,), (8,)]),
                                  _mod_contract(spec, "mont_mul"),
                                  samples=2),
            kernel=card, launches="mont_mul"))
        # a broadcast scalar operand and a strided one: kernel 1 reads
        # both through their strides
        out.append(Entry(
            "field/%s_mont_mul_bcast" % n, plain,
            (word_rows(L, 8), word_rows(L, 1)), words,
            value=ValueObligation(_field_sampler(spec, [(8,), (1,)]),
                                  _mod_contract(spec, "mont_mul")),
            kernel=card, launches="mont_mul"))
        out.append(Entry(
            "field/%s_mont_mul_strided" % n,
            lambda a, b, s=spec: F.mont_mul_ref(s, a[:, ::2], b),
            (word_rows(L, 16), word_rows(L, 8)), words,
            value=ValueObligation(
                _field_sampler(spec, [(16,), (8,)]),
                _mod_contract(spec, "mont_mul", view=lambda a: a[:, ::2])),
            kernel=lambda a, b, s=spec: F.mont_mul_cuda(s, a[:, ::2], b),
            launches="mont_mul"))
        for op in ("add", "sub"):
            out.append(Entry(
                "field/%s_%s" % (n, op),
                lambda a, b, s=spec, f=getattr(F, op): f(s, a, b),
                (word_rows(L, 8),) * 2, words,
                value=ValueObligation(_field_sampler(spec, [(8,), (8,)]),
                                      _mod_contract(spec, op), samples=2)))
        out.append(Entry(
            "field/%s_neg" % n, lambda a, s=spec: F.neg(s, a),
            (word_rows(L, 8),), words,
            value=ValueObligation(_field_sampler(spec, [(8,)]),
                                  _mod_contract(spec, "neg"), samples=2)))
        for op in ("to_mont", "from_mont"):
            f = getattr(F, op)
            out.append(Entry(
                "field/%s_%s" % (n, op), lambda a, s=spec, f=f: f(s, a),
                (word_rows(L, 8),), words,
                value=ValueObligation(_field_sampler(spec, [(8,)]),
                                      _mod_contract(spec, op), samples=2),
                kernel=lambda a, s=spec, f=f: f(s, a), launches="mont_mul"))
    # the sweep at its weakest precondition (any columns below 2^62): words
    # below 2^32 and a carry below 2^31; the value obligation is the
    # equation its docstring states, value(words) + carry*2^(32K) ==
    # value(cols), exactly
    out.append(Entry("field/sweep32", F._sweep32,
                     (Bound((8, 6), torch.int64, 0, (1 << 62) - 1),),
                     [(0, U32), (0, 1 << 31)], value=_sweep32_value()))
    out.append(Entry("field/words_roundtrip",
                     lambda v: F._to16(F._from16(v)),
                     (Bound((16, 8), torch.int64, 0, U16),), [(0, U16)],
                     value=_roundtrip_value()))
    out.append(Entry("field/fr_cumsum", lambda v: F.cumsum(F.FR, v),
                     (word_rows(8, 8),), [I32],
                     value=_cumsum_value(F.FR)))
    return out


# (n, max_log_rows) of the multi-pass plans: 2^6 in 2 passes of 3 stages
# and in 3 passes of 2
_NTT_PASSES = ((64, 3), (64, 2))


def _ntt_fns(n, inverse, coset, max_log_rows=None, host=True):
    """(plain, card) of one NTT mode; the plain version's host plan is
    built here, outside any trace."""
    from ..backend import ntt_torch as N
    plan = N.get_plan(n, "cpu", max_log_rows) if host else None

    def plain(v):
        return N.ntt_ref(plan, v, inverse, coset)

    def card(v):
        return N.ntt_cuda(N.get_plan(n, v.device, max_log_rows), v,
                          inverse, coset)
    return plain, card


def _ntt_entries():
    out = []
    for n in (32, 64):
        for inverse in (False, True):
            for coset in (False, True):
                plain, card = _ntt_fns(n, inverse, coset)
                out.append(Entry(
                    "ntt/n%d_inv%d_coset%d" % (n, inverse, coset), plain,
                    (word_rows(8, 1, n),), [I32],
                    value=_ntt_value(n, inverse, coset), kernel=card,
                    launches="ntt"))
    for n, mlr in _NTT_PASSES:
        from ..backend import ntt_torch as N
        passes = len(N.split_digits(n.bit_length() - 1, mlr))
        plain, card = _ntt_fns(n, True, True, mlr)
        out.append(Entry(
            "ntt/n%d_inv1_coset1_passes%d" % (n, passes), plain,
            (word_rows(8, 1, n),), [I32],
            value=_ntt_value(n, True, True), kernel=card, launches="ntt"))
    plain, card = _ntt_fns(32, False, True)
    out.append(Entry("ntt/n32_batch3_coset", plain, (word_rows(8, 3, 32),),
                     [I32], value=_ntt_value(32, False, True, rows=3),
                     kernel=card, launches="ntt"))
    return out


def _unsigned_trace_ops(rng, lanes, P, nb):
    """Consistent (op words, sort keys) for bucket_sums' trace: random
    unsigned digits with some skips, keyed as op_keys keys them."""
    from ..backend import msm_torch as M
    d = torch.from_numpy(rng.integers(0, nb, size=(lanes, 1, P)))
    inf = torch.zeros(P, dtype=torch.bool)
    inf[0] = True
    ops = M.unsigned_ops(d, inf)
    keys = M.op_keys(ops, nb, True)
    return ops.reshape(-1), keys.reshape(-1)


def _msm_entries():
    from ..backend import msm_torch as M

    out = []
    dom = 64
    pad = 2 * dom
    for Lw in (dom + 2, dom + 3):   # the prover's blinded handle widths
        out.append(Entry(
            "msm/digits_signed_c7_L%d" % Lw,
            lambda h: M.signed_digits7_from_mont(h, pad),
            (word_rows(8, Lw),), [(0, 127)],
            value=_digits_value(Lw, 7, 64, pad)))
        out.append(Entry(
            "msm/digits_unsigned_c4_L%d" % Lw,
            lambda h: M.digits_from_mont(h, 4, pad),
            (word_rows(8, Lw),), [(0, 15)],
            value=_digits_value(Lw, 4, 0, pad)))
    # kernel 3's digit decode: the prover's round-1 layout (B handles of
    # width n + 2 zero-padded to the key's n + 3 points), signed over a
    # shifted key and unsigned over a small one
    for c, signed, nb, W in ((7, True, 64, M.W7), (4, False, 16, 64)):
        n, width, B_ = dom + 3, dom + 2, 2
        lanes = B_

        def plain(v, inf, c=c, signed=signed):
            return M.msm_digits_ref(v, inf, c, signed, True)

        def card(v, inf, c=c, signed=signed):
            return M.msm_digits_cuda(v, inf, c, signed, True)
        tag = "signed_c7" if signed else "unsigned_c4"
        out.append(Entry(
            "msm/msm_digits_%s_B%d_L%d" % (tag, B_, width), plain,
            (word_rows(8, B_, n), Bound((n,), torch.bool, 0, 1)),
            [(0, (1 << 10) - 1), (0, lanes * nb)],
            value=_msm_digits_value(B_, n, c, signed, True, width,
                                    inf_lanes=(3, n - 1)),
            kernel=card, launches="msm_digits"))
    # bucket accumulation and the tail: bounds only. Cut to size: 24 points
    # in 2 lanes over 4 buckets at chunk 4 (the chunk loop and the tree
    # repeat one projective add); the tail at 4 buckets (its running sums
    # repeat the same add)
    P, lanes, nb, chunk = 24, 2, 4, 4
    out.append(Entry(
        "msm/bucket_sums_nb%d_chunk%d" % (nb, chunk),
        lambda key, ops, keys: M.bucket_sums_ref(key, ops, keys, lanes, nb,
                                                 chunk),
        (word_rows(P, 24), Bound((lanes * P,), torch.int32, 0, 1023),
         Bound((lanes * P,), torch.int32, 0, lanes * nb)),
        [I32] * 3,
        trace_args=lambda rng: (word_rows(P, 24).sample(rng),)
        + _unsigned_trace_ops(rng, lanes, P, nb)))
    for signed in (True, False):
        out.append(Entry(
            "msm/tail_%s_nb%d" % ("signed" if signed else "unsigned", nb),
            lambda bx, by, bz, s=signed: M.msm_tail_ref(bx, by, bz, s),
            (word_rows(12, 2, nb),) * 3, [I32] * 3))
    return out


def _curve_entries():
    from ..backend import curve_torch as CT

    pt = (word_rows(12, 8),) * 3
    return [
        Entry("curve/proj_add", lambda x1, y1, z1, x2, y2, z2:
              CT.proj_add_ref((x1, y1, z1), (x2, y2, z2)), pt + pt,
              [I32] * 3),
        Entry("curve/proj_add_mixed", lambda x1, y1, z1, x2, y2:
              CT.proj_add_mixed_ref((x1, y1, z1), (x2, y2)), pt + pt[:2],
              [I32] * 3),
    ]


# round 3's card entries: 16 blocks of 256 lanes (the folds are lane-wise;
# chip_smoke.py phase 2 holds them at the main path's widths, 2^16 and
# 2^21, against their plain versions)
R3_CARD_LANES = 1 << 12

# poly_eval's bounds entries run at chunk 16: the production chunk (256)
# repeats one Horner step on the same intervals; 16 keeps the pad, the
# lanes and the power combine at a tenth of the trace
EVAL_BOUNDS_CHUNK = 16


def _eval_entries():
    """The round-4 evaluation (prover_torch.poly_eval: block Horner + the
    power combine): at a chunk-multiple width and at the blinded n + 2
    width (the padded tail), and poly_eval_many's batched launch. The value
    obligation runs the same poly_eval at chunk 8 on 20 coefficients: 3
    Horner blocks, the padded tail and the combine. On the card these
    launch kernel 1."""
    from ..backend import prover_torch as PT

    out = []
    for L in (256, 66):
        out.append(Entry(
            "eval/horner_at_r_n%d" % L,
            lambda p, z: PT.poly_eval(p, z, EVAL_BOUNDS_CHUNK),
            (word_rows(8, 1, L), word_rows(8, 1, 1)), [I32],
            value=_eval_value(
                20, fn=lambda p, z: PT.poly_eval(p, z, chunk=8)),
            kernel=lambda p, z: PT.poly_eval(p, z, chunk=8),
            launches="mont_mul"))
    out.append(Entry(
        "eval/horner_at_r_batch4_n66",
        lambda p, z: PT.poly_eval_many(p, z),
        (word_rows(8, 4, 66), word_rows(8, 4, 1)), [I32],
        value=_eval_value(5, batch=2), kernel=PT.poly_eval_many,
        launches="mont_mul"))
    return out


_RINV = pow(1 << 256, -1, R_MOD)

# round 3's folds: the scalars of every entry (canonical Fr values, the
# role of the transcript's challenges and the coset constants k)
R3_BETA, R3_GAMMA, R3_ALPHA, R3_ASDN = (
    0x2a5f0e4b1c9d7a3e, 0x5bd1e995 << 160 | 0x1b873593, 7 << 200 | 11, 3)
R3_K = (1, 7, 13, 17, 19)
# (start, count) of the gate entries: every selector kind in one batch, and
# a v2-width batch that starts inside Q_MUL and ends inside Q_HASH
R3_GATE_BATCHES = ((0, 13), (4, 4))


def _mm_int(a, b):
    """The Montgomery product on raw (Montgomery-form) ints."""
    return a * b * _RINV % R_MOD


def _gate_term(q, s, w):
    """Raw value of selector q's term sel * f(w) (Q_O's enters negated,
    Q_C's is sel itself)."""
    mm = _mm_int
    if q == 11:
        return s
    if q < 4:
        f = w[q]
    elif q < 6:
        f = mm(w[2 * (q - 4)], w[2 * (q - 4) + 1])
    elif q < 10:
        x = w[q - 6]
        f = mm(mm(mm(x, x), mm(x, x)), x)
    elif q == 10:
        f = w[4]
    else:
        f = mm(mm(mm(w[0], w[1]), mm(w[2], w[3])), w[4])
    return mm(s, f)


def _lanes(words, m):
    """(8, k, m) or (8, m) word tensor -> k lists of m raw ints."""
    v = V.word_value(V.to_exact(words)).reshape(-1, m)
    return [[int(x) for x in row] for row in v]


def _r3_report(what, got, want, m):
    row = [int(x) for x in V.word_value(got).reshape(-1)]
    errs = []
    if any(x >= R_MOD for x in row):
        errs.append("%s: output not canonical (>= r)" % what)
    if row != want:
        k = next(i for i in range(m) if row[i] != want[i])
        errs.append("%s: mismatch at lane %d (%d/%d lanes differ)" % (
            what, k, sum(r != x for r, x in zip(row, want)), m))
    return errs


def _gate_value(start, count, m, samples=1):
    """value(out) == gate + sum of the batch's selector terms mod r, on
    raw Montgomery values (each product carries one R^-1)."""
    from ..backend.field_torch import FR

    def sampler(rng):
        return (_fe_tensor(rng, FR, m, (m,)),
                _fe_tensor(rng, FR, count * m, (count, m)),
                _fe_tensor(rng, FR, 5 * m, (5, m)))

    def contract(args, outs):
        g = _lanes(args[0], m)[0]
        sel, w = _lanes(args[1], m), _lanes(args[2], m)
        want = []
        for i in range(m):
            acc = g[i]
            wi = [w[j][i] for j in range(5)]
            for j in range(count):
                q = start + j
                t = _gate_term(q, sel[j][i], wi)
                acc = (acc - t if q == 10 else acc + t) % R_MOD
            want.append(acc)
        return _r3_report("gate_fold", outs[0], want, m)
    return ValueObligation(sampler, contract, samples=samples)


def _mont_int(x):
    return x % R_MOD * (1 << 256) % R_MOD


def _sigma_value(start, count, m, samples=1):
    """value(out) == acc2 * prod_j (w_j + gamma + beta * sigma_j) mod r."""
    from ..backend.field_torch import FR
    beta, gamma = _mont_int(R3_BETA), _mont_int(R3_GAMMA)

    def sampler(rng):
        return (_fe_tensor(rng, FR, m, (m,)),
                _fe_tensor(rng, FR, count * m, (count, m)),
                _fe_tensor(rng, FR, 5 * m, (5, m)))

    def contract(args, outs):
        a = _lanes(args[0], m)[0]
        sig, w = _lanes(args[1], m), _lanes(args[2], m)
        want = []
        for i in range(m):
            acc = a[i]
            for j in range(count):
                f = (w[start + j][i] + gamma
                     + _mm_int(sig[j][i], beta)) % R_MOD
                acc = _mm_int(acc, f)
            want.append(acc)
        return _r3_report("sigma_fold", outs[0], want, m)
    return ValueObligation(sampler, contract, samples=samples)


def _combine_value(m, samples=1):
    """value(out) == zh_inv * (gate + alpha * (acc1 - acc2)) + l1 mod r,
    acc1 = z * prod_j (w_j + gamma + k_j ep beta), l1 = alpha^2/n *
    (z - 1) * shifted_inv, on raw Montgomery values."""
    from ..backend.field_torch import FR
    mm = _mm_int
    beta, gamma, alpha, asdn = (_mont_int(x) for x in (
        R3_BETA, R3_GAMMA, R3_ALPHA, R3_ASDN))
    ks = [_mont_int(k) for k in R3_K]
    one = _mont_int(1)

    def sampler(rng):
        return ((_fe_tensor(rng, FR, 5 * m, (5, m)),)
                + tuple(_fe_tensor(rng, FR, m, (m,)) for _ in range(6)))

    def contract(args, outs):
        w = _lanes(args[0], m)
        z, g, a2, ep, zh, sh = (_lanes(a, m)[0] for a in args[1:])
        want = []
        for i in range(m):
            acc1 = z[i]
            for j in range(5):
                f = (w[j][i] + gamma + mm(mm(ks[j], ep[i]), beta)) % R_MOD
                acc1 = mm(acc1, f)
            perm = mm(alpha, (acc1 - a2[i]) % R_MOD)
            l1 = mm(mm(asdn, (z[i] - one) % R_MOD), sh[i])
            want.append((mm(zh[i], (g[i] + perm) % R_MOD) + l1) % R_MOD)
        return _r3_report("quotient_combine", outs[0], want, m)
    return ValueObligation(sampler, contract, samples=samples)


def _r3_fns(kind, start=0, count=0):
    """(plain, card) of one fold at the registry's scalars."""
    from ..backend import prover_torch as PT
    if kind == "gate":
        return (lambda g, p, w: PT.gate_fold_ref(g, p, w, start),
                lambda g, p, w: PT.gate_fold_cuda(g, p, w, start))
    if kind == "sigma":
        return (lambda a, p, w: PT.sigma_fold_ref(a, p, w, start, R3_BETA,
                                                  R3_GAMMA),
                lambda a, p, w: PT.sigma_fold_cuda(a, p, w, start, R3_BETA,
                                                   R3_GAMMA))

    def combine(fn):
        def run(w, z, g, a2, ep, zh, sh):
            tabs = {"ep": ep, "zh_inv": zh, "shifted_inv": sh}
            return fn(w, z, g, a2, tabs, R3_K, R3_BETA, R3_GAMMA, R3_ALPHA,
                      R3_ASDN)
        return run
    return (combine(PT.quotient_combine_ref),
            combine(PT.quotient_combine_cuda))


# the host entries' lanes: every step is lane-wise, so the width is free
R3_LANES = 8


def _r3_entries():
    """Round 3's folds (prover_torch.gate_fold_ref, sigma_fold_ref,
    quotient_combine_ref; on the card csrc/round3.cu's r3_gate_fold,
    r3_sigma_fold, r3_combine) at 8 lanes."""
    m = R3_LANES
    plane = word_rows(8, m)
    out = []
    for start, count in R3_GATE_BATCHES:
        plain, card = _r3_fns("gate", start, count)
        out.append(Entry(
            "r3/gate_fold_s%d_b%d" % (start, count), plain,
            (plane, word_rows(8, count, m), word_rows(8, 5, m)), [I32],
            value=_gate_value(start, count, m), kernel=card,
            launches="r3_gate_fold"))
    plain, card = _r3_fns("sigma", 0, 5)
    out.append(Entry(
        "r3/sigma_fold_s0_b5", plain,
        (plane, word_rows(8, 5, m), word_rows(8, 5, m)), [I32],
        value=_sigma_value(0, 5, m), kernel=card, launches="r3_sigma_fold"))
    plain, card = _r3_fns("combine")
    out.append(Entry(
        "r3/combine", plain, (word_rows(8, 5, m),) + (plane,) * 6, [I32],
        value=_combine_value(m), kernel=card, launches="r3_combine"))
    return out


def build_registry():
    """All production entries (list of Entry)."""
    return (_field_entries() + _ntt_entries() + _msm_entries()
            + _curve_entries() + _eval_entries() + _r3_entries())


def card_entries():
    """Main-path shapes held on the card only (too large for the exact
    host pass): kernel 1 at 2^16 lanes, kernel 2 at n = 2^13 in each mode,
    kernel 3's msm_digits over the v1 round-1 batch (5 handles of width
    n + 2 on the key's n + 3 points)."""
    from ..backend import field_torch as F
    from ..backend import msm_torch as M

    out = []
    lanes = 1 << 16
    for spec in (F.FR, F.FQ):
        out.append(Entry(
            "field/%s_mont_mul_main" % spec.name.lower(), None, (),
            value=ValueObligation(_field_sampler(spec, [(lanes,),
                                                        (lanes,)]),
                                  _mod_contract(spec, "mont_mul")),
            kernel=lambda a, b, s=spec: F.mont_mul_cuda(s, a, b),
            launches="mont_mul", card_only=True))
    n = 1 << 13
    for inverse in (False, True):
        for coset in (False, True):
            _, card = _ntt_fns(n, inverse, coset, host=False)
            out.append(Entry(
                "ntt/n%d_inv%d_coset%d_main" % (n, inverse, coset), None,
                (), value=_ntt_value(n, inverse, coset), kernel=card,
                launches="ntt", card_only=True))
    out.append(Entry(
        "msm/msm_digits_signed_c7_B5_L%d_main" % (n + 2), None, (),
        value=_msm_digits_value(5, n + 3, 7, True, True, n + 2),
        kernel=lambda v, inf: M.msm_digits_cuda(v, inf, 7, True, True),
        launches="msm_digits", card_only=True))
    # round 3's folds over 16 blocks of lanes: all 13 selectors in one
    # launch (v1's batch), the 5 sigmas, the combine
    lanes = R3_CARD_LANES
    for kind, start, count, value, launches in (
            ("gate", 0, 13, _gate_value(0, 13, lanes), "r3_gate_fold"),
            ("sigma", 0, 5, _sigma_value(0, 5, lanes), "r3_sigma_fold"),
            ("combine", 0, 0, _combine_value(lanes), "r3_combine")):
        out.append(Entry(
            "r3/%s_m%d_card" % (kind, lanes), None, (), value=value,
            kernel=_r3_fns(kind, start, count)[1], launches=launches,
            card_only=True))
    return out


def _selected(name, names):
    return names is None or any(s in name for s in names)


def run_bounds(strict=True, names=None, progress=None, contracts=True):
    """Check every registry entry (plus the carry contracts unless the
    caller runs them separately). Returns (violations, entries_checked)."""
    violations = list(B.check_contracts()) if contracts else []
    checked = 0
    for e in build_registry():
        if not _selected(e.name, names):
            continue
        v = e.check(strict=strict)
        checked += 1
        if progress is not None:
            progress(e.name, v)
        violations.extend(v)
    return violations, checked


def run_values(strict=True, names=None, progress=None, device="cpu",
               entries=None):
    """Every entry's value contract: on the host (device "cpu": exact
    evaluation of the plain graphs) or on the card (every entry with a
    kernel, the main-path shapes of card_entries() included). Returns
    (violations, entries_checked)."""
    card = torch.device(device).type == "cuda"
    if entries is None:
        entries = build_registry() + (card_entries() if card else [])
    violations = []
    checked = 0
    for e in entries:
        if not _selected(e.name, names):
            continue
        v = e.check_values(strict=strict, device=device)
        if v is None:
            continue
        checked += 1
        if progress is not None:
            progress(e.name, v)
        violations.extend(v)
    return violations, checked
