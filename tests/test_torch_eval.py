"""Round 4's batched evaluation on the CPU: prover_torch.poly_eval's plain
version (poly_eval_ref, what a CPU tensor runs) and the split of kernel 8
(csrc/eval.cu), which runs only on the card. Tolerance 0 throughout:
every value is a canonical field element.

- poly_eval_many equals the JAX package's prover_jax.poly_eval_many_jit
  (jit on the CPU, as tests/test_prover_jax.py runs it) on the same seeded
  inputs, word for word: one polynomial of 1 and of 255 coefficients, and
  ten of uneven lengths padded as TorchBackend.eval_many_async pads them,
  at points that include 0 and 1.
- poly_eval_ref equals the port's host Horner, poly.poly_eval.
- split_eval, a Python mirror of the kernel's split (which coefficients
  each thread takes, the power of z each Horner runs in, the block's
  tree, the second launch over the blocks' partials), equals
  poly_eval_ref for thread counts above L, equal to L and not dividing L,
  and at the kernel's own geometry (eval_blocks) across two launches.
- poly_eval_cuda refuses CPU tensors and words that are not int32.

The kernel against the plain version on the card: tests/test_torch_cuda.py
(test_poly_eval_matches_plain).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_plonk_tpu.backend import prover_jax as PJ
from distributed_plonk_tpu_torch import poly as P
from distributed_plonk_tpu_torch.backend import field_torch as F
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend import prover_torch as PT
from distributed_plonk_tpu_torch.backend.torch_backend import TorchBackend
from distributed_plonk_tpu_torch.constants import R_MOD

torch.set_num_threads(1)


def _ints(rng, count):
    """Seeded canonical Fr ints, the corners 0, 1 and r - 1 first."""
    vals = [int.from_bytes(rng.bytes(40), "little") % R_MOD
            for _ in range(count)]
    return ([0, 1, R_MOD - 1] + vals)[:count]


def _pairs(seed, lengths, points):
    rng = np.random.default_rng(seed)
    return [(_ints(rng, L), z) for L, z in zip(lengths, points)]


def _port_operands(pairs):
    """(8, B, L) and (8, B, 1) Montgomery words on the CPU, each polynomial
    padded with zeros to the longest, as eval_many_async pads them."""
    L = max(len(cs) for cs, _ in pairs)
    polys = torch.stack([F.pad_words(TL.lift(cs, "cpu"), L)
                         for cs, _ in pairs], dim=1)
    zs = TL.lift([z for _, z in pairs], "cpu").reshape(8, len(pairs), 1)
    return polys, zs


# (seed, coefficient counts, points): B = 1 at L = 1 and 255; ten uneven
# polynomials at points 0, 1, r - 1 and seeded ones (B * L <= 3,000)
CASES = [
    (1, [1], [12345]),
    (2, [255], [0x1234567890abcdef << 128 | 99]),
    (3, [300, 299, 298, 1, 300, 17, 256, 255, 299, 300],
     [0, 1, R_MOD - 1, 5, 7 << 200, 11, 13, 2**128 + 3, 19, 23]),
]


@pytest.mark.parametrize("seed,lengths,points", CASES,
                         ids=["B1_L1", "B1_L255", "B10_uneven"])
def test_plain_equals_the_jax_poly_eval_many(seed, lengths, points):
    """TorchBackend(cpu).eval_many_h (eval_many_async: pad, stack, then
    poly_eval_many) against the JAX function on the same padded words."""
    pairs = _pairs(seed, lengths, points)
    polys, zs = _port_operands(pairs)
    jpolys = jnp.asarray(np.moveaxis(TL.to_jax_limbs(polys), 1, 0))
    jzs = jnp.asarray(np.moveaxis(TL.to_jax_limbs(zs), 1, 0))
    want = np.asarray(PJ.poly_eval_many_jit(jpolys, jzs))  # (16, B)
    be = TorchBackend(device="cpu")
    got = be.eval_many_h([(TL.lift(cs, "cpu"), z) for cs, z in pairs])
    assert got == TL.words_to_ints(TL.to_numpy(
        TL.from_jax_limbs(want, "cpu")))
    assert got == [P.poly_eval(cs, z) for cs, z in pairs]


@pytest.mark.parametrize("L,chunk", [(1, 256), (7, 256), (300, 8),
                                     (1030, 64)])
def test_plain_equals_the_host_horner(L, chunk):
    (cs, z), = _pairs(L, [L], [0x5eed << 100 | L])
    polys, zs = _port_operands([(cs, z)])
    got = PT.poly_eval_ref(polys, zs, chunk)
    assert TL.lower(got) == [P.poly_eval(cs, z)]
    # poly_eval on CPU tensors is the plain version
    assert torch.equal(PT.poly_eval(polys, zs, chunk), got)


def split_eval(cs, z, threads, blocks):
    """csrc/eval.cu's arithmetic on Python ints: dpt_poly_eval with
    `blocks` blocks of `threads` threads a polynomial (the kernel's
    threads are PT.EVAL_THREADS)."""
    def launch(coeffs, y, blocks):
        # eval_kernel over `blocks` blocks: thread r = x * threads + t
        # runs Horner over coefficients r, r + G, ... in base y^G; the
        # block's tree adds v[t + h] * y^h into v[t] at stride h
        G = threads * blocks
        y_g = pow(y, G, R_MOD)
        partials = []
        for x in range(blocks):
            v = []
            for t in range(threads):
                acc = 0
                for i in reversed(range(x * threads + t, len(coeffs), G)):
                    acc = (acc * y_g + coeffs[i]) % R_MOD
                v.append(acc)
            h = threads // 2
            while h:
                for t in range(h):
                    v[t] = (v[t] + v[t + h] * pow(y, h, R_MOD)) % R_MOD
                h //= 2
            partials.append(v[0])
        return partials

    partials = launch(cs, z, blocks)
    if blocks == 1:
        return partials[0]
    # the second launch: one block over the partials, in z^threads
    return launch(partials, pow(z, threads, R_MOD), 1)[0]


# (L, threads, blocks): G = threads * blocks above L, equal to L, not
# dividing L; one block, and more than one (a second launch)
SPLITS = [(5, 4, 2), (1, 4, 1), (8, 4, 2), (8, 8, 1), (13, 2, 2),
          (13, 4, 1), (37, 4, 4), (100, 8, 4)]


@pytest.mark.parametrize("L,threads,blocks", SPLITS)
def test_the_kernels_split_equals_the_plain_version(L, threads, blocks):
    for z in (0, 1, 0xabcdef << 180 | L):
        (cs, _), = _pairs(L + threads, [L], [z])
        polys, zs = _port_operands([(cs, z)])
        want, = TL.lower(PT.poly_eval_ref(polys, zs))
        assert split_eval(cs, z, threads, blocks) == want, z


def test_the_kernels_geometry():
    """eval_blocks: one block up to 2 * 256 * 32 - 1 coefficients (v1's
    n + 3), then a power of two so that a thread holds 32 or more; the
    split at that geometry, two launches, equals the plain version."""
    run = PT.EVAL_THREADS * PT.EVAL_RUN
    assert [PT.eval_blocks(L) for L in (1, 8195, 2 * run - 1, 2 * run,
                                        262147, 1048579)] \
        == [1, 1, 1, 2, 32, 128]
    for L in (1, 300, 262147, 1048579, (1 << 31) - 1):
        blocks = PT.eval_blocks(L)
        assert blocks * run <= L or blocks == 1
        assert 2 * blocks * run > L
    L = 2 * run + 3
    (cs, z), = _pairs(99, [L], [0xfeed << 150])
    polys, zs = _port_operands([(cs, z)])
    want, = TL.lower(PT.poly_eval_ref(polys, zs))
    assert split_eval(cs, z, PT.EVAL_THREADS, PT.eval_blocks(L)) == want


def test_poly_eval_cuda_refuses_cpu_tensors():
    polys, zs = _port_operands(_pairs(5, [3, 3], [2, 3]))
    with pytest.raises(ValueError, match="CUDA"):
        PT.poly_eval_cuda(polys, zs)
    with pytest.raises(TypeError, match="int32"):
        PT.poly_eval_cuda(polys.to(torch.int64), zs)
