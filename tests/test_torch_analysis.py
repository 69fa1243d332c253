"""The port's static verifier (distributed_plonk_tpu_torch/analysis/):
registry, interval bounds, exact values and carry contracts, held against
the JAX package's analysis.

Every JAX value entry with a port counterpart draws its arguments with the
JAX sampler (seeded numpy), converted by limbs.from_jax_limbs; the port's
plain function runs on them, and

- the JAX contract accepts the port's outputs (converted back),
- the port's own contract accepts them,
- where the JAX entry function runs directly (field/, eval/), its outputs
  equal the port's bit for bit,
- both contracts reject the same output with one word of one lane moved
  by 1, and
- run_exact over the port's traced graph equals the plain function's
  machine output.

The JAX package's own interpreters (its check_fn, run_bounds, run_values,
check_mutants) are not called: they use jax.core.Literal, which this jax
lacks. Its registry, samplers and contracts work on outputs passed in.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from distributed_plonk_tpu.analysis import registry as JR
from distributed_plonk_tpu.analysis import values as JV
from distributed_plonk_tpu_torch.analysis import bounds as B
from distributed_plonk_tpu_torch.analysis import registry as R
from distributed_plonk_tpu_torch.analysis import values as V
from distributed_plonk_tpu_torch.backend import field_torch as F
from distributed_plonk_tpu_torch.backend import limbs

ROOT = Path(__file__).resolve().parent.parent

# JAX value entry -> port entry. The JAX entries without one: the plain
# NTT boundary (the port's NTT takes and gives Montgomery handles only),
# the deferred output permutation (the port's last pass stores natural
# order), and the signed c = 8 digits (the port signs c = 7 only).
COUNTERPART = {}
for _s in ("fr", "fq"):
    for _op in ("add", "sub", "neg", "to_mont", "from_mont"):
        COUNTERPART["field/%s_%s" % (_s, _op)] = "field/%s_%s" % (_s, _op)
    for _v in ("f32", "u32", "pallas_lazy", "pallas_mxu"):
        COUNTERPART["field/%s_mont_mul_%s" % (_s, _v)] = \
            "field/%s_mont_mul" % _s
COUNTERPART.update({
    "field/carry_sweep": "field/sweep32",
    "field/pack_unpack_limb_pairs": "field/words_roundtrip",
    "field/cumsum_mont": "field/fr_cumsum",
    "ntt/n32_radix2_inv1_coset1_mont": "ntt/n32_inv1_coset1",
    "ntt/n32_radix4_batch3_coset": "ntt/n32_batch3_coset",
    "ntt/n64_pallas_inv0_coset1_rows64": "ntt/n64_inv0_coset1",
    "ntt/n64_pallas_inv1_coset1_rows8": "ntt/n64_inv1_coset1_passes2",
    "ntt/n32_pallas_inv0_coset0_batch3_rows32": "ntt/n32_inv0_coset0",
    "eval/horner_at_r_n256": "eval/horner_at_r_n256",
    "eval/horner_at_r_n66": "eval/horner_at_r_n66",
    "eval/horner_at_r_batch4_n66": "eval/horner_at_r_batch4_n66",
})
for _i in (0, 1):
    for _c in (0, 1):
        COUNTERPART["ntt/n32_radix4_inv%d_coset%d_mont" % (_i, _c)] = \
            "ntt/n32_inv%d_coset%d" % (_i, _c)
for _w in (66, 67):
    for _d in ("signed_c7", "unsigned_c4"):
        COUNTERPART["msm/digits_%s_L%d" % (_d, _w)] = \
            "msm/digits_%s_L%d" % (_d, _w)
NO_COUNTERPART = {
    "ntt/n32_radix4_inv%d_coset%d_plain" % (i, c)
    for i in (0, 1) for c in (0, 1)} | {
    "ntt/n64_radix4_batch3_coset_defer_perm",
    "ntt/n64_pallas_batch3_coset_defer_perm",
    "msm/digits_signed_c8_L66", "msm/digits_signed_c8_L67"}

# the JAX entry functions run directly here (no Pallas kernel inside)
DIRECT = ("field/", "eval/")


_JAX = {}
_PORT = {}


def jax_entries():
    if not _JAX:
        _JAX.update((e.name, e) for e in JR.build_registry())
    return _JAX


def port_entries():
    if not _PORT:
        _PORT.update((e.name, e) for e in R.build_registry())
    return _PORT


def _jax_value_names():
    return sorted(COUNTERPART)


def test_every_jax_value_entry_is_mapped_or_listed():
    vals = {n for n, e in jax_entries().items() if e.value is not None}
    assert len(jax_entries()) == 72 and len(vals) == 45
    assert vals == set(COUNTERPART) | NO_COUNTERPART
    assert set(COUNTERPART.values()) <= set(port_entries())


# -- conversions between the JAX entries' arguments and the port's -----------

def _to_port(jname, args):
    """The JAX sampler's numpy arguments -> the port entry's tensors."""
    if jname == "field/carry_sweep":
        cols = args[0].astype(np.int64)
        return (torch.from_numpy(cols[0::2] + (cols[1::2] << 16)),)
    if jname == "field/pack_unpack_limb_pairs":
        return (torch.from_numpy(args[0].astype(np.int64)),)
    if jname.startswith("ntt/"):
        arr = args[0]
        n = arr.shape[-1]
        return (limbs.from_jax_limbs(arr, "cpu").reshape(8, -1, n),)
    if jname == "eval/horner_at_r_batch4_n66":
        return tuple(limbs.from_jax_limbs(np.moveaxis(a, 1, 0), "cpu")
                     for a in args)
    if jname.startswith("eval/"):
        return tuple(limbs.from_jax_limbs(a, "cpu")[:, None] for a in args)
    return tuple(limbs.from_jax_limbs(a, "cpu") for a in args)


def _to_jax(jname, jargs, outs):
    """The port's outputs -> what the JAX contract reads."""
    if jname == "field/carry_sweep":
        words, carry = outs
        return [limbs._split16(words.numpy().astype(np.uint32)),
                carry.numpy()]
    if jname == "field/pack_unpack_limb_pairs" or jname.startswith("msm/"):
        return [o.numpy() for o in outs]
    if jname.startswith("ntt/"):
        return [limbs.to_jax_limbs(outs[0]).reshape(jargs[0].shape)]
    if jname.startswith("eval/"):
        return [limbs.to_jax_limbs(outs[0].reshape(8, -1))]
    return [limbs.to_jax_limbs(o) for o in outs]


def _port_run(jname):
    """(port entry, port args, port fn, port outs) on the JAX sampler's
    first sample."""
    je = jax_entries()[jname]
    pe = port_entries()[COUNTERPART[jname]]
    jargs = je.value.sampler(np.random.default_rng(0x5eed))
    pargs = _to_port(jname, jargs)
    fn = pe.value.fn or pe.fn
    outs = fn(*pargs)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    return je, pe, jargs, pargs, fn, outs


def _perturbed(outs):
    bad = [o.clone() for o in outs]
    bad[0].view(-1)[0] += 1
    return bad


@pytest.mark.parametrize("jname", _jax_value_names())
def test_port_outputs_meet_the_jax_and_port_contracts(jname):
    je, pe, jargs, pargs, fn, outs = _port_run(jname)
    exact = [V.to_exact(o) for o in outs]
    assert je.value.contract(jargs, [JV.to_exact(x) for x in _to_jax(
        jname, jargs, outs)]) == []
    assert pe.value.contract(pargs, exact) == []
    # one word of one lane moved by 1: both contracts reject it
    bad = _perturbed(outs)
    assert je.value.contract(jargs, [JV.to_exact(x) for x in _to_jax(
        jname, jargs, bad)]) != []
    assert pe.value.contract(pargs, [V.to_exact(o) for o in bad]) != []
    # the exact evaluation of the traced graph is the machine's output
    g = B.trace(fn, pargs)
    got = V.run_exact(g, pargs)
    assert len(got) == len(outs)
    for o, e in zip(got, exact):
        assert o.shape == e.shape and (o == e).all()
    if jname.startswith(DIRECT) and "pallas" not in jname:
        ob = je.value
        jout = je._patched(je.patches + ob.patches,
                           lambda: jax.jit(ob.fn or je.fn)(*jargs))
        jout = jout if isinstance(jout, (tuple, list)) else (jout,)
        for want, mine in zip(jout, _to_jax(jname, jargs, outs)):
            np.testing.assert_array_equal(np.asarray(want),
                                          np.asarray(mine), strict=False)


# -- the registry is clean under --strict --------------------------------------

@pytest.mark.parametrize("subset", [
    ("field/fr_mont_mul", "field/fq_mont_mul_strided", "field/sweep32",
     "field/fr_sub"),
    ("eval/horner_at_r_n66",),
    ("msm/digits_signed_c7_L66", "msm/msm_digits_signed_c7_B2_L66"),
    ("curve/proj_add_mixed", "msm/bucket_sums"),
    ("ntt/n32_inv1_coset1",),
])
def test_registry_subset_clean(subset):
    seen = []
    violations, checked = R.run_bounds(
        strict=True, names=list(subset),
        progress=lambda name, v: seen.append(name))
    assert checked >= len(subset), (subset, seen)
    assert [str(v) for v in violations] == []
    violations, _ = R.run_values(strict=True, names=list(subset))
    assert [str(v) for v in violations] == []


def test_registry_covers_every_family_and_kernel():
    names = [e.name for e in R.build_registry()]
    assert len(names) == len(set(names))
    for fam in ("field/", "ntt/", "msm/", "curve/", "eval/", "r3/"):
        assert any(n.startswith(fam) for n in names)
    card = [e for e in R.build_registry() if e.kernel is not None]
    kernels = {"mont_mul", "ntt", "msm_digits", "r3_gate_fold",
               "r3_sigma_fold", "r3_combine", "msm_finish", "poly_eval"}
    assert {e.launches for e in card} == kernels
    mains = R.card_entries()
    assert {e.launches for e in mains} == kernels
    assert all(e.card_only and e.kernel is not None for e in mains)
    # a card value pass needs a card: the host pass skips these
    assert all(e.check_values(device="cpu") is None for e in mains)


def test_declared_output_bound_is_enforced():
    v = B.check_fn("mutant", lambda a: a + a,
                   (B.Bound((4, 4), torch.int64, 0, (1 << 16) - 1),),
                   out_bounds=[(0, (1 << 16) - 1)])
    assert any(x.prim == "output" for x in v)


def test_narrowing_without_the_where_anchor_is_flagged():
    """_narrow's where() keeps each branch under its own condition; the
    same words narrowed without it can leave int32."""
    arg = (B.Bound((8, 4), torch.int64, 0, (1 << 32) - 1),)
    assert B.check_fn("narrow", F._narrow, arg) == []
    v = B.check_fn("mutant", lambda w: w.to(torch.int32), arg)
    assert any("narrowing to int32" in x.message for x in v)


def test_row_fill_of_an_empty_tensor_is_bounded_by_its_rows():
    def fill(x):
        out = torch.empty_like(x)
        for i in range(x.shape[0]):
            out[i] = x[i] & 0xFFFF
        return out * out           # 2^32 if the fill were not seen

    arg = (B.Bound((4, 3), torch.int64, 0, (1 << 62)),)
    assert B.check_fn("fill", fill, arg) == []

    def partial(x):
        out = torch.empty_like(x)
        out[0] = x[0] & 0xFFFF     # rows 1.. never written
        return out * out

    # rows 1.. read as the dtype's range (and, being garbage, differ
    # between the eager run and the trace)
    assert B.check_fn("partial", partial, arg) != []


def test_trace_refuses_a_graph_that_diverges_from_eager():
    """Functionalization takes contiguous() of an expanded tensor for the
    expand view and replays an in-place write through its inverse: the
    graph then computes other values than the function, and the trace
    says so instead of proving things about the wrong function."""
    def diverges(x):
        y = x[:, :1].expand(4, 3).contiguous()
        y[:, 0] = 7
        return y.reshape(12)

    with pytest.raises(B.TraceDiverged):
        B.trace(diverges, (torch.ones(4, 3, dtype=torch.int64),))
    v = B.check_fn("diverges", diverges,
                   (B.Bound((4, 3), torch.int64, 0, 5),))
    assert v and v[0].prim == "trace"


def test_exact_evaluation_reports_instead_of_wrapping():
    def wraps(x):
        return x * x                           # int64 products past 2^63

    x = torch.full((3,), 1 << 40, dtype=torch.int64)
    g = B.trace(wraps, (x,))
    with pytest.raises(V.UnsupportedOp, match="leaves int64"):
        V.run_exact(g, (x,))


# -- carry contracts -----------------------------------------------------------

def test_carry_contracts_hold_for_both_fields():
    assert B.check_contracts() == []
    assert len(F.CARRY_CONTRACTS) >= 8


def test_carry_contract_catches_bad_field_layout():
    class BadSpec:
        name = "Bad"
        mod = (1 << 255) + 1      # 2p > 2^256 at 8 words
        n_words = 8

    v = B.check_contracts(specs=(BadSpec,))
    assert v and any("reduce_once_fits" in x.kernel for x in v)
    assert any("cuh_cios_row_fits" in x.kernel for x in v)


def test_cuda_contracts_quote_their_lines():
    """Each csrc/field.cuh contract quotes the source at the lines it
    cites: a contract that drifts from its code fails here."""
    src = (ROOT / "distributed_plonk_tpu_torch" / "csrc" /
           "field.cuh").read_text().splitlines()
    cuh = [c for c in F.CARRY_CONTRACTS if c["where"].startswith("csrc/")]
    assert len(cuh) == 4
    for c in cuh:
        lo, _, hi = re.match(r"csrc/field.cuh:(\d+)(-(\d+))?",
                             c["where"]).group(1, 2, 3)
        lines = src[int(lo) - 1:int(hi or lo)]
        assert any(c["quote"] in line for line in lines), c["name"]
