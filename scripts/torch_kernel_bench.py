#!/usr/bin/env python3
"""Kernel microbenchmarks of the PyTorch port (the counterpart of
scripts/kernel_bench.py): Montgomery products, the NTT and the MSM.

    python3 scripts/torch_kernel_bench.py [fr|fq|ntt|msm|msm24|all]
        [--device cuda|cpu]

Modes, as in the JAX script:
  fr     kernel 1, Fr, 2^20 lanes: a chain of 8 dependent products
  fq     kernel 1, Fq, 2^18 lanes: the same chain
  ntt    kernel 2, a forward NTT of 2^20
  msm    the MSM at 2^16 and at 2^20 points; 2^20 on both key layouts
         (msm_torch: the window-shifted key and the base key), which must
         give the same point
  msm24  the MSM at 2^24 points on the base layout (BASELINE.json's
         configuration 5), with its window finish (msm_finish) timed
         alone on its bucket sums
  all    fr, fq, ntt and msm

The MSM's bases tile 2^11 distinct points (the reference's micro-test,
src/dispatcher.rs:188-196): [tau^i] G from the device SRS
(kzg.universal_setup_device, tau from Random(3)), tiled on the device;
its scalars are Montgomery handles drawn on the device from a seeded
torch.Generator. Every MSM is checked with the tiling identity
sum_i s_i P_(i mod 2^11) = sum_j (sum_(i = j mod 2^11) s_i mod r) P_j,
the right side by the shifted 2^11-point context. Each timing is a warm
call (after an untimed one) ending in a synchronize: `s_per_call` /
`s` per call, over `reps` calls.

Prints one JSON line: {"kernel": "cuda" | "plain", "platform", "card"
(the nvidia-smi name and power limit, on the card), and one record per
mode: fr / fq (kernel, n, chain, s_per_call, mul_per_s, ns_per_mul), ntt
(kernel, s, elements_per_s), msm_2p16 / msm_2p20 / msm_2p24 (kernel, n,
layout, s, points_per_s, key_build_s, tiling_identity, and on the card
key_peak_mib and peak_mib: the peak device memory after the key's build
and over the run; finish_ms, the window finish per call, on the base
layout); msm_2p20 also has `shifted` and `base`, one record per layout,
and `same_point`}.

Runs on the card unless --device cpu asks for the kernels' plain
versions; without a card and without --device cpu it exits non-zero
before it builds anything.
"""

import argparse
import json
import os
import random
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DISTINCT = 1 << 11


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, reps):
    """Seconds per call of fn() over `reps` calls after an untimed one,
    the device drained at both ends; and the last call's result."""
    out = fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps, out


def random_handles(spec, lanes, device, gen):
    """(words, lanes) field elements below 2^(32 words - 2), which every
    modulus here exceeds: drawn as int32 words from `gen`."""
    import torch
    v = torch.randint(-(1 << 31), 1 << 31, (spec.n_words, lanes),
                      dtype=torch.int32, device=device, generator=gen)
    top = 0x3FFFFFFF if spec.n_words == 8 else 0x0FFFFFFF
    v[-1] &= top
    return v


def _generator(device, seed):
    import torch
    return torch.Generator(device=device).manual_seed(seed)


def bench_mont_mul(spec_name, n, device, chain=8, reps=3):
    """A chain of `chain` dependent Montgomery products over n lanes."""
    from distributed_plonk_tpu_torch.backend import field_torch as F
    spec = F.FR if spec_name == "fr" else F.FQ
    gen = _generator(device, 0)
    a = random_handles(spec, n, device, gen)
    b = random_handles(spec, n, device, gen)

    def run():
        acc = a
        for _ in range(chain):
            acc = F.mont_mul(spec, acc, b)
        return acc

    dt, _ = _timed(run, device, reps)
    per_s = n * chain / dt
    return {"kernel": "mont_mul_%s" % spec_name, "n": n, "chain": chain,
            "s_per_call": round(dt, 6), "mul_per_s": round(per_s),
            "ns_per_mul": round(1e9 / per_s, 3)}


def bench_ntt(log_n, device, reps=3):
    """A forward NTT of 2^log_n elements."""
    from distributed_plonk_tpu_torch.backend import field_torch as F
    from distributed_plonk_tpu_torch.backend import ntt_torch as N
    n = 1 << log_n
    plan = N.get_plan(n, device)
    v = random_handles(F.FR, n, device, _generator(device, 2))[:, None]
    dt, _ = _timed(lambda: N.ntt(plan, v, False, False), device, reps)
    return {"kernel": "ntt_2p%d" % log_n, "s": round(dt, 6),
            "elements_per_s": round(n / dt)}


class MsmBench:
    """The MSM bench's distinct bases on one device and the shifted
    context over them that checks the tiling identity."""

    def __init__(self, device, distinct=DISTINCT):
        import torch
        from distributed_plonk_tpu_torch import kzg
        from distributed_plonk_tpu_torch.backend import curve_torch as CT
        from distributed_plonk_tpu_torch.backend import msm_torch as M
        self.device = device
        self.distinct = distinct
        srs = kzg.universal_setup_device(distinct - 1, rng=random.Random(3),
                                         device=device)
        self.ax, self.ay, self.inf = CT.batch_to_affine(srs.jac_powers)
        assert not bool(self.inf.any()), "a base at infinity"
        self.oracle = M.MsmContext.from_affine(self.ax, self.ay, self.inf,
                                               layout="shifted")
        self.torch = torch

    def _peak_mib(self):
        return round(self.torch.cuda.max_memory_allocated(self.device)
                     / 2**20, 1)

    def scalars(self, n, seed):
        """(8, 1, n) Montgomery handles from a seeded generator."""
        from distributed_plonk_tpu_torch.backend import field_torch as F
        return random_handles(F.FR, n, self.device,
                              _generator(self.device, seed))[:, None]

    def tiled_sum(self, v):
        """sum_(i = j mod distinct) s_i for each j: (8, distinct)."""
        from distributed_plonk_tpu_torch.backend import field_torch as F
        d = min(self.distinct, v.shape[-1])
        s = v.reshape(8, -1, d)
        while s.shape[1] > 1:           # n / d, a power of two
            s = F.add(F.FR, s[:, 0::2], s[:, 1::2])
        return s[:, 0]

    def context(self, n, layout):
        """An MsmContext over the bases tiled to n points in `layout` (the
        oracle itself for the shifted layout at n = distinct)."""
        from distributed_plonk_tpu_torch.backend import msm_torch as M
        if n == self.distinct and M.resolve_layout(layout, n) == "shifted":
            return self.oracle
        d = min(self.distinct, n)
        reps = n // d
        ax, ay = (t[:, :d].repeat(1, reps) for t in (self.ax, self.ay))
        inf = self.inf[:d].repeat(reps)
        return M.MsmContext.from_affine(ax, ay, inf, layout=layout)

    def run(self, log_n, layout="auto", reps=2, seed=5):
        """The warm MSM at 2^log_n tiled points in `layout` -> (record,
        affine point). Raises if it misses the tiling identity."""
        n = 1 << log_n
        cuda = self.device.type == "cuda"
        if cuda:
            self.torch.cuda.empty_cache()
            _sync(self.device)
            self.torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        ctx = self.context(n, layout)
        _sync(self.device)
        key_s = time.perf_counter() - t0
        rec = {"kernel": "msm_2p%d" % log_n, "n": n, "layout": ctx.layout,
               "key_build_s": round(key_s, 3)}
        if cuda:
            rec["key_peak_mib"] = self._peak_mib()
        v = self.scalars(n, seed)
        dt, got = _timed(lambda: ctx.msm_mont_limbs_many([v[:, 0]])[0],
                         self.device, reps)
        rec.update(s=round(dt, 4), points_per_s=round(n / dt))
        if cuda:
            rec["peak_mib"] = self._peak_mib()
        if ctx.layout == "base":
            # the window finish alone (kernel 4's msm_finish) on this
            # MSM's bucket sums; one call on the CPU, where its plain
            # version takes seconds
            planes = ctx.bucket_planes(ctx.stack([v[:, 0]]))
            fin_s, _ = _timed(lambda: ctx.tail(planes), self.device,
                              5 if cuda else 1)
            rec["finish_ms"] = round(1e3 * fin_s, 4)
            del planes
        del ctx
        want = self.oracle.msm_mont_limbs_many([self.tiled_sum(v)])[0]
        rec["tiling_identity"] = got == want
        if got != want:
            raise AssertionError("msm_2p%d (%s layout) misses the tiling "
                                 "identity" % (log_n, layout))
        return rec, got


def bench_msm_layouts(bench, log_n, reps=1):
    """The MSM at 2^log_n on the shifted and on the base layout: the
    shifted record, with both records and `same_point`."""
    shifted, p_s = bench.run(log_n, "shifted", reps)
    base, p_b = bench.run(log_n, "base", reps)
    rec = dict(shifted, shifted=shifted, base=base, same_point=p_s == p_b)
    if p_s != p_b:
        raise AssertionError("msm_2p%d: the layouts give different points"
                             % log_n)
    return rec


def kernel_bench(what, device, sizes=None):
    """The modes of `what` on `device` -> the result dict. sizes
    overrides the log2 widths: {"fr", "fq", "ntt", "msm": (small,
    layouts), "msm24", "distinct"}."""
    sizes = dict({"fr": 20, "fq": 18, "ntt": 20, "msm": (16, 20),
                  "msm24": 24, "distinct": 11}, **(sizes or {}))
    out = {"kernel": "cuda" if device.type == "cuda" else "plain",
           "platform": device.type}
    if device.type == "cuda":
        out["card"] = card_name()
    if what in ("fr", "all"):
        out["fr"] = bench_mont_mul("fr", 1 << sizes["fr"], device)
    if what in ("fq", "all"):
        out["fq"] = bench_mont_mul("fq", 1 << sizes["fq"], device)
    if what in ("ntt", "all"):
        out["ntt"] = bench_ntt(sizes["ntt"], device)
    if what in ("msm", "all", "msm24"):
        bench = MsmBench(device, 1 << sizes["distinct"])
        if what == "msm24":
            log_n = sizes["msm24"]
            out["msm_2p%d" % log_n] = bench.run(log_n, "base", reps=1)[0]
        else:
            small, both = sizes["msm"]
            if small != both:
                out["msm_2p%d" % small] = bench.run(small)[0]
            out["msm_2p%d" % both] = bench_msm_layouts(bench, both)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="?", default="all",
                    choices=("fr", "fq", "ntt", "msm", "msm24", "all"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from distributed_plonk_tpu_torch.backend.field_torch import \
        resolve_device
    try:
        device = resolve_device(args.device, "torch_kernel_bench")
    except RuntimeError as e:
        print("torch_kernel_bench: %s" % e, file=sys.stderr)
        return 1
    print(json.dumps(kernel_bench(args.what, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
