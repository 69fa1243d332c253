"""Kernel 4's full add (curve_torch.proj_add / proj_dbl, csrc/curve_add.cu's
cooperative body on csrc/curve_coop.cuh) on the CPU, every check exact:

- proj_add_ref equals the JAX package's curve_jax.proj_add on seeded
  points, the identity, P = Q and P = -Q among them;
- proj_dbl_ref at reps 1 and 7 equals that many successive
  curve_jax.proj_add(P, P), and proj_dbl on CPU tensors runs it with no
  launch;
- msm_torch.shifted_key on CPU tensors equals the key the loop of
  single doublings built;
- a Python model of add_coop_kernel (its staging into shared memory, the
  lane -> (group, product) map, the operand tables read from
  curve_coop.cuh, the repeats and the ragged last block's clamped loads
  and skipped stores) gives proj_add_ref's and proj_dbl_ref's limbs on
  Python ints, five groups a warp;
- the launch wrapper refuses CPU tensors, mismatched shapes and bad
  repeat counts before it loads a library or counts a launch;
- every header curve_add.cu includes is in _build.HEADERS.

The kernel itself runs only on a card: tests/test_torch_cuda.py's
test_add_kernels_match_plain holds both bodies against the plain versions
limb for limb.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from distributed_plonk_tpu import curve as C
from distributed_plonk_tpu.backend import curve_jax as CJ
from distributed_plonk_tpu.constants import FQ_MONT_R, Q_MOD, R_MOD
from distributed_plonk_tpu_torch.backend import _build
from distributed_plonk_tpu_torch.backend import curve_torch as CT
from distributed_plonk_tpu_torch.backend import field_torch as F
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend import msm_torch as M

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "distributed_plonk_tpu_torch",
                    "csrc")


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _host_points(count, seed):
    rng = np.random.default_rng(seed)
    return [C.g1_mul(C.G1_GEN, int(rng.integers(1, 1 << 62)) % R_MOD)
            for _ in range(count)]


def _port_proj(points):
    """Affine host points (None: the identity) -> port (12, n) planes."""
    p = CT.from_affine(*M.points_to_device(points, 0, "cpu"))
    return tuple(c.contiguous() for c in p)


def _operands(count, seed):
    """(P, Q) with general Z: sums of seeded points; lanes 1 and 2 hold
    Q = P and Q = -P, lane 3 Q = identity, lane 4 P = identity."""
    a, b, c = (_host_points(count, seed + k) for k in range(3))
    p = CT.proj_add_ref(_port_proj(a), _port_proj(b))
    q = CT.proj_add_ref(_port_proj(c), _port_proj(a))
    p, q = [t.clone() for t in p], [t.clone() for t in q]
    inf = CT.proj_inf((1,), "cpu")
    for k in range(3):
        q[k][:, 1] = p[k][:, 1]
        q[k][:, 3] = inf[k][:, 0]
        p[k][:, 4] = inf[k][:, 0]
    q[0][:, 2], q[2][:, 2] = p[0][:, 2], p[2][:, 2]
    q[1][:, 2:3] = F.sub(F.FQ, torch.zeros_like(p[1][:, 2:3]),
                         p[1][:, 2:3])
    return tuple(p), tuple(q)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _jax(t):
    return TL.to_jax_limbs(t)


def _from_jax(arrs):
    return tuple(TL.from_jax_limbs(np.asarray(a), "cpu") for a in arrs)


def test_proj_add_ref_matches_curve_jax_edge_cases():
    p, q = _operands(9, 11)
    want = jax.jit(CJ.proj_add)(tuple(_jax(c) for c in p),
                                tuple(_jax(c) for c in q))
    got = CT.proj_add_ref(p, q)
    assert _equal(got, _from_jax(want))
    affine = CT.proj_to_affine(got)
    assert affine[1] == C.g1_add_affine(*CT.proj_to_affine(
        tuple(c[:, 1:2] for c in p)) * 2)
    assert affine[2] is None                        # P + (-P)
    assert affine[3] == CT.proj_to_affine(tuple(c[:, 3:4] for c in p))[0]
    assert affine[4] == CT.proj_to_affine(tuple(c[:, 4:5] for c in q))[0]


@pytest.mark.parametrize("reps", [1, 7])
def test_proj_dbl_ref_matches_successive_curve_jax_adds(reps):
    p, _ = _operands(6, 21)

    def dbl(pt):
        return jax.lax.fori_loop(0, reps, lambda _, a: CJ.proj_add(a, a),
                                 pt)

    want = jax.jit(dbl)(tuple(_jax(c) for c in p))
    assert _equal(CT.proj_dbl_ref(p, reps), _from_jax(want))
    # on CPU tensors the entry runs the plain version and launches nothing
    before = dict(_build.LAUNCHES)
    assert _equal(CT.proj_dbl(p, reps), _from_jax(want))
    assert _build.LAUNCHES == before


def test_shifted_key_matches_the_loop_of_single_doublings():
    points = _host_points(10, 31) + [None, None]
    x, y, inf = M.points_to_device(points, 0, "cpu")
    c, windows = 7, 3
    got = M.shifted_key(x, y, inf, c, windows)
    # the key as the loop of c single P + P a window built it
    one = F.one_like(F.FQ, x)
    p = (x, F.select(inf, one, y), F.select(inf, torch.zeros_like(x), one))
    planes = [p]
    for _ in range(windows - 1):
        for _ in range(c):
            p = CT.proj_add(p, p)
        planes.append(p)
    stacked = tuple(torch.cat([pl[i] for pl in planes], dim=1)
                    for i in range(3))
    ax, ay, _ = CT.batch_to_affine(stacked, jacobian=False)
    assert torch.equal(got, M.point_major(ax, ay))


# --- a Python model of add_coop_kernel ---------------------------------------

_RINV = pow(FQ_MONT_R, -1, Q_MOD)
_MASK = (1 << 32) - 1


def _macros():
    """DPT_ADD_* of curve_add.cu, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"^#define (DPT_ADD_\w+) (.+?)(?://.*)?$",
                                 _src("curve_add.cu"), re.M):
        env[name] = eval(expr, {}, dict(env))
    return env


def _tables():
    """The operand tables of coop_add_at, in source order: level 1's
    coordinates i and j, level 2's slots a and b, stage A's three
    selectors."""
    body = _src("curve_coop.cuh")
    body = body[body.index("void coop_add_at("):body.index("void coop_add(")]
    # the conditions the model below takes as written
    for cond in ("fq_addsub(x2, y, x1, r <= 2)", "fq_addsub(y, y, x3, r == 5)",
                 "r == 2 ? x3[k] : (r >= 4 ? y[k] : x2[k])",
                 "slot_get(y, s, 1)", "fq_addsub(a, a, b, r == 0)",
                 "if (r >= 3)", "if (writer && r < 3)",
                 "fq_get(a, s + 12 * (2 * r))",
                 "fq_get(b, s + 12 * (2 * r + 1))"):
        assert cond in body, cond
    tabs = [int(t, 16) for t in re.findall(r"\(0x([0-9A-F]+) >> \(4 \* r\)\)",
                                           body)]
    assert len(tabs) == 7, tabs
    return tabs


def _nib(table, r):
    return (table >> (4 * r)) & 15


def _get(mem, base, stride):
    return sum(mem[base + k * stride] << (32 * k) for k in range(12))


def _put(mem, base, stride, v):
    for k in range(12):
        mem[base + k * stride] = (v >> (32 * k)) & _MASK


def _warp_add(mem, lanes, ps, tabs):
    """One coop_add_at by a whole warp; lanes: (r, writer, out, p, q, s)
    word offsets into mem. Each stage reads before any lane writes (the
    __syncwarp between stages)."""
    l1i, l1j, l2a, l2b, sa1, sa2, sa3 = tabs

    def slot(s, i):
        return 0 if i >= 12 else _get(mem, s + 12 * i, 1)

    def stage(fn, dst):
        vals = [fn(*lane) for lane in lanes]
        for lane, v in zip(lanes, vals):
            if lane[1] and dst(*lane) is not None:
                _put(mem, *dst(*lane), v)

    def level1(r, writer, out, p, q, s):
        i, j = _nib(l1i, r), _nib(l1j, r)
        a, b = _get(mem, p + 12 * ps * i, ps), _get(mem, q + 12 * ps * i, ps)
        if r >= 3:
            a = (a + _get(mem, p + 12 * ps * j, ps)) % Q_MOD
            b = (b + _get(mem, q + 12 * ps * j, ps)) % Q_MOD
        return a * b * _RINV % Q_MOD

    def stage_a(r, writer, out, p, q, s):
        x1 = (slot(s, _nib(sa1, r)) + slot(s, _nib(sa2, r))) % Q_MOD
        y = slot(s, _nib(sa3, r))
        x2 = (y - x1 if r <= 2 else y + x1) % Q_MOD
        x3 = 12 * x2 % Q_MOD
        y = (slot(s, 1) - x3 if r == 5 else slot(s, 1) + x3) % Q_MOD
        return x3 if r == 2 else (y if r >= 4 else x2)

    def level2(r, writer, out, p, q, s):
        return slot(s, _nib(l2a, r)) * slot(s, _nib(l2b, r)) * _RINV % Q_MOD

    def final(r, writer, out, p, q, s):
        a, b = slot(s, 2 * r), slot(s, 2 * r + 1)
        return (a - b if r == 0 else a + b) % Q_MOD

    stage(level1, lambda r, w, out, p, q, s: (s + 12 * r, 1))
    stage(stage_a, lambda r, w, out, p, q, s: (s + 12 * (6 + r), 1))
    stage(level2, lambda r, w, out, p, q, s: (s + 12 * r, 1))
    stage(final, lambda r, w, out, p, q, s:
          (out + 12 * ps * r, ps) if r < 3 else None)


def _model(p, q, reps):
    """add_coop_kernel on Python ints: (12, n) planes -> out planes; q is
    p (the identical tuple) for the doublings' one staged input."""
    env, tabs = _macros(), _tables()
    warps, groups = env["DPT_ADD_WARPS"], env["DPT_ADD_GROUPS"]
    points, ps = env["DPT_ADD_POINTS"], env["DPT_ADD_PS"]
    scr = 144                   # a group's CoopScratch: 12 Fq slots
    assert points == warps * groups and ps > points
    assert "__shared__ CoopScratch scratch[DPT_ADD_POINTS];" in \
        _src("curve_add.cu")
    n = p[0].shape[1]
    dbl = q is p
    ins = [[TL.words_to_ints(TL.to_numpy(c)) for c in pt] for pt in (p, q)]

    def word(k, l, i):
        return (ins[k][l // 12][i] >> (32 * (l % 12))) & _MASK

    out = [[[0] * 12 for _ in range(n)] for _ in range(3)]
    for p0 in range(0, n, points):
        # shared memory: pts[0], pts[1], then the groups' scratch
        mem = [0] * (2 * 36 * ps + points * scr)
        valid = min(points, n - p0)
        for t in range((1 if dbl else 2) * 36 * points):
            k, l, j = t // (36 * points), t // points % 36, t % points
            mem[k * 36 * ps + l * ps + j] = word(k, l, p0 + min(j, valid - 1))
        for warp in range(warps):
            lanes = []
            for lane in range(32):
                writer = lane < 6 * groups
                g = lane // 6 if writer else groups - 1
                r = lane - 6 * g if writer else 0
                j = warp * groups + g
                lanes.append((r, writer, j, j, (0 if dbl else 36 * ps) + j,
                              2 * 36 * ps + j * scr))
            for k in range(reps):
                _warp_add(mem, [(r, w, o, a, b if k == 0 else a, s)
                                for r, w, o, a, b, s in lanes], ps, tabs)
        for t in range(36 * points):
            l, j = t // points, t % points
            if j < valid:
                out[l // 12][p0 + j][l % 12] = mem[l * ps + j]
    return tuple(TL.to_tensor(np.asarray(c, dtype=np.uint32).T, "cpu")
                 for c in out)


@pytest.mark.parametrize("n,reps,dbl", [(43, 1, False), (12, 3, True)])
def test_coop_kernel_model_gives_the_plain_limbs(n, reps, dbl):
    """Two blocks, the second with 3 of its 40 points (n = 43), and a
    ragged single block of doublings with reps 3."""
    p, q = _operands(n, 41 + n)
    if dbl:
        assert _equal(_model(p, p, reps), CT.proj_dbl_ref(p, reps))
    else:
        assert _equal(_model(p, q, reps), CT.proj_add_ref(p, q))


# --- the wrapper ----------------------------------------------------------


def _no_load(monkeypatch):
    def load():
        raise AssertionError("proj_add loaded the kernels")

    monkeypatch.setattr(_build, "load", load)


@pytest.mark.parametrize("case,match", [
    ("cpu", "expected CUDA"),
    ("shapes", "share device and shape"),
    ("reps0", "reps"),
    ("reps_not_dbl", "reps"),
    ("reps_mixed", "reps"),
    ("dtype", "int32"),
])
def test_add_cuda_refuses_before_any_launch(case, match, monkeypatch):
    _no_load(monkeypatch)
    p = CT.proj_inf((6,), "cpu")
    q = tuple(c.clone() for c in p)
    args = {"cpu": (p, q), "shapes": (p, CT.proj_inf((5,), "cpu")),
            "reps0": (p, p, 0), "reps_not_dbl": (p, q, 7),
            "reps_mixed": (p, q[:2], 2),
            "dtype": (p, tuple(c.to(torch.int64) for c in q))}[case]
    before = dict(_build.LAUNCHES)
    with pytest.raises((ValueError, TypeError), match=match):
        CT._add_cuda(*args)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="reps"):
        CT.proj_dbl(p, 0)


def test_every_header_of_curve_add_is_hashed():
    seen, todo = set(), ["curve_add.cu"]
    while todo:
        for inc in re.findall(r'^#include "([^"]+)"', _src(todo.pop()),
                              re.M):
            assert inc in _build.HEADERS, inc
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    assert {"curve_coop.cuh", "curve.cuh", "field.cuh"} <= seen
