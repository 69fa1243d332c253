"""Kernel 4's window finish (msm_torch.msm_finish, csrc/msm_finish.cu with
its warp-cooperative add, csrc/curve_coop.cuh) on the CPU:

- msm_finish_ref at unsigned c = 4 (64 windows of 16 buckets, the keys
  under 256 points) equals the JAX package's msm_jax.finish_batch in
  affine, on seeded bucket sums (the registry's sampler: multiples k G of
  the generator with random Z, some the identity), and meets the
  registry's _finish_value contract at 2 handles;
- msm_finish_cuda refuses a CPU tensor and a segmentation the kernel was
  not written for before it loads a library or counts a launch, and
  msm_finish on CPU tensors runs the plain version without a launch;
- every header a kernel source includes is in _build.HEADERS (the build's
  source hash covers it), and msm_finish.cu builds on the cooperative add
  alone, leaving msm_tail.cuh to curve_add.cu.

The kernel itself runs only on a card: tests/test_torch_cuda.py holds it
against msm_finish_ref limb for limb at msm24's batch, a round-1 batch,
33 handles, unsigned c = 4 and identity sums.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from distributed_plonk_tpu.backend import msm_jax as MJ
from distributed_plonk_tpu_torch.analysis import registry as AR
from distributed_plonk_tpu_torch.backend import _build
from distributed_plonk_tpu_torch.backend import curve_torch as CT
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend import msm_torch as M

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "distributed_plonk_tpu_torch",
                    "csrc")
# unsigned c = 4: 64 windows of 16 buckets (window_of for 64-255 points)
UNSIGNED = (64, 4, False)


def _sampled(B, seed):
    windows, c, signed = UNSIGNED
    ob = AR._finish_value(B, windows, c, signed)
    return ob, ob.sampler(np.random.default_rng(seed))


def test_window_of_gives_unsigned_c4_below_256_points():
    assert M.window_of(64)[:3] == (False, 4, 64)
    assert M.window_of(255)[:3] == (False, 4, 64)
    assert M.window_of(256)[:3] == (True, 7, M.W7)


def test_msm_finish_ref_unsigned_c4_matches_msm_jax_finish():
    """msm_finish_ref against msm_jax.finish_batch at unsigned c = 4, one
    handle, both to affine."""
    windows, c, signed = UNSIGNED
    _, args = _sampled(1, 3)
    planes = args[:3]
    assert planes[0].shape == (12, windows, 16)
    got = M.msm_finish_ref(*planes, windows, c, signed)
    want = jax.jit(MJ.finish_batch, static_argnums=(3, 4))(
        *(TL.to_jax_limbs(p) for p in planes), 1, signed)
    want = tuple(TL.from_jax_limbs(np.asarray(w), "cpu") for w in want)
    assert CT.proj_to_affine(got) == CT.proj_to_affine(want)


def test_finish_value_contract_unsigned_c4_two_handles():
    """The registry's contract for msm_finish at 2 handles of unsigned
    c = 4: each total is the multiple of G its sums encode."""
    windows, c, signed = UNSIGNED
    ob, args = _sampled(2, 4)
    got = M.msm_finish(*args[:3], windows, c, signed)
    assert got[0].shape == (12, 2)
    assert ob.contract(args, [np.asarray(g.numpy(), dtype=object)
                              for g in got]) == []
    # doubled totals break it
    bad = CT.proj_add_ref(got, got)
    assert ob.contract(args, [np.asarray(g.numpy(), dtype=object)
                              for g in bad]) != []


def _planes(lanes, nb):
    return tuple(p.contiguous() for p in CT.proj_inf((lanes, nb), "cpu"))


@pytest.mark.parametrize("lanes,nb,windows,match", [
    (2 * 37, 64, 37, "expected CUDA"),
    (75, 64, 37, "not handles x 37 windows"),
    (2 * 37, 48, 37, "power of two"),
    (2 * 37, 1, 37, "power of two"),
])
def test_msm_finish_cuda_refuses_before_any_launch(lanes, nb, windows,
                                                   match, monkeypatch):
    """A CPU tensor, a lane count that is not handles x windows and a
    bucket count the segmentation cannot cut: each raises before a library
    loads or a launch counts (no fallback to the plain version)."""
    def load():
        raise AssertionError("msm_finish_cuda loaded the kernels")

    monkeypatch.setattr(_build, "load", load)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        M.msm_finish_cuda(*_planes(lanes, nb), windows, 7, True)
    assert _build.LAUNCHES == before


def test_msm_finish_on_cpu_runs_the_plain_version():
    before = dict(_build.LAUNCHES)
    planes = _planes(2 * 3, 4)
    got = M.msm_finish(*planes, 3, 2, False)
    assert all(torch.equal(g, w) for g, w in
               zip(got, M.msm_finish_ref(*planes, 3, 2, False)))
    assert all(torch.equal(g, w) for g, w in zip(got, CT.proj_inf((2,),
                                                                  "cpu")))
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="not handles x 3 windows"):
        M.msm_finish(*_planes(7, 4), 3, 2, False)


def _includes(name):
    with open(os.path.join(CSRC, name)) as f:
        return re.findall(r'^#include "([^"]+)"', f.read(), re.M)


def test_every_included_header_is_hashed():
    """The build's source hash covers every header a source includes, so
    an edit to one rebuilds the libraries; the window finish builds on the
    cooperative add, and msm_tail.cuh stays curve_add.cu's."""
    seen = set()
    todo = list(_build.SOURCES.values())
    while todo:
        name = todo.pop()
        for inc in _includes(name):
            assert inc in _build.HEADERS, (name, inc)
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    assert seen == set(_build.HEADERS)
    assert _includes("msm_finish.cu") == ["curve_coop.cuh"]
    assert "msm_tail.cuh" in _includes("curve_add.cu")
    assert _includes("curve_coop.cuh") == ["curve.cuh"]

