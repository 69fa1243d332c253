"""Radix-2 NTT / iNTT (+ coset variants) over Fr word tensors: the port of
backend/ntt_jax.py's NttPlan / get_plan.

Semantics are poly.Domain's: the same root of unity (fr_root_of_unity(n))
and coset shift (FR_GENERATOR), so every mode is bit-identical to the host
oracle and to ntt_jax in natural order:

  forward:  out[i] = sum_j v_j w^{ij}
  inverse:  out[j] = 1/n sum_i v_i w^{-ij}
  coset:    forward of v_j g^j / inverse followed by out_j g^{-j}

All at the Montgomery boundary (handles in, handles out), with a batch axis:
(8, B, n) -> (8, B, n). Kernel 2 (csrc/ntt.cu) runs one launch per
decimation-in-frequency stage plus one bit-reversal gather, the coset
pre-scale fused into the first stage and the inverse post-scale into the
last; `ntt_ref` is its plain version, stage for stage.
"""

import torch

from ..constants import R_MOD, FR_GENERATOR, FR_MONT_R, FR_WORDS
from ..fields import fr_inv, fr_root_of_unity
from . import _build
from . import field_torch as F
from .field_torch import FR
from .limbs import ints_to_words, to_tensor


def _powers(base, count, start=1):
    out = []
    acc = start % R_MOD
    for _ in range(count):
        out.append(acc)
        acc = acc * base % R_MOD
    return out


def _mont_table(values, device):
    return to_tensor(ints_to_words([v * FR_MONT_R % R_MOD for v in values],
                                   FR_WORDS), device)


def _bitrev(n):
    log_n = n.bit_length() - 1
    return [int(format(i, "0%db" % log_n)[::-1], 2) if log_n else 0
            for i in range(n)]


class NttPlan:
    """Twiddle, coset and post-scale tables for one domain size, on one
    device (None: the card), built once."""

    def __init__(self, n, device=None):
        assert n >= 2 and n & (n - 1) == 0, n
        self.n = n
        self.log_n = n.bit_length() - 1
        self.device = F.resolve_device(device, "NttPlan")
        w = fr_root_of_unity(n)
        self.perm_list = _bitrev(n)
        self.perm = torch.tensor(self.perm_list, dtype=torch.int64,
                                 device=self.device)
        # stage s reads tw[k << s]: w^0 .. w^(n/2 - 1)
        self.tw_fwd = _mont_table(_powers(w, n // 2), self.device)
        self.tw_inv = _mont_table(_powers(fr_inv(w), n // 2), self.device)
        g = FR_GENERATOR
        n_inv = fr_inv(n % R_MOD)
        self.coset_tab = _mont_table(_powers(g, n), self.device)
        # inverse post-scales, laid out in the last stage's bit-reversed
        # storage order: entry i scales natural index bitrev(i)
        inv_coset = _powers(fr_inv(g), n, start=n_inv)
        self.post_coset = _mont_table([inv_coset[j] for j in self.perm_list],
                                      self.device)
        self.post_plain = _mont_table([n_inv] * n, self.device)

    def tables(self, inverse, coset):
        """(twiddles, pre-scale or None, post-scale or None)."""
        tw = self.tw_inv if inverse else self.tw_fwd
        pre = self.coset_tab if (coset and not inverse) else None
        post = None
        if inverse:
            post = self.post_coset if coset else self.post_plain
        return tw, pre, post

    def kernel(self, inverse=False, coset=False):
        """(8, n) -> (8, n) Montgomery-boundary transform."""
        return lambda v: ntt(self, v[:, None, :], inverse, coset)[:, 0]

    def run_ints(self, values, inverse=False, coset=False):
        """Canonical int list (zero-padded to n) -> canonical int list."""
        from .limbs import lift, lower
        assert len(values) <= self.n
        v = lift(list(values) + [0] * (self.n - len(values)), self.device)
        return lower(self.kernel(inverse, coset)(v))


_PLANS = {}


def get_plan(n, device=None):
    """The cached NttPlan of size n on device (None: the card)."""
    device = F.resolve_device(device, "get_plan")
    key = (n, str(device))
    if key not in _PLANS:
        _PLANS[key] = NttPlan(n, device)
    return _PLANS[key]


def ntt_ref(plan, v, inverse=False, coset=False):
    """Plain torch version of kernel 2: the same DIF stages, fused scales
    and final bit-reversal gather, on (8, B, n) Montgomery words."""
    n, log_n = plan.n, plan.log_n
    tw_tab, pre, post = plan.tables(inverse, coset)
    mul = F.mont_mul_ref
    L, B = v.shape[0], v.shape[1]
    x = v
    for s in range(log_n):
        half = n >> (s + 1)
        xs = x.reshape(L, B, n // (2 * half), 2, half)
        u, w = xs[:, :, :, 0], xs[:, :, :, 1]
        if s == 0 and pre is not None:
            pv = pre.reshape(L, 1, 1, 2, half)
            u, w = mul(FR, u, pv[:, :, :, 0]), mul(FR, w, pv[:, :, :, 1])
        t = F.sub(FR, u, w)
        u = F.add(FR, u, w)
        tw = tw_tab[:, ::1 << s][:, :half].reshape(L, 1, 1, half)
        w = mul(FR, t, tw)
        if s == log_n - 1 and post is not None:
            qv = post.reshape(L, 1, n // 2, 2, 1)
            u, w = mul(FR, u, qv[:, :, :, 0]), mul(FR, w, qv[:, :, :, 1])
        x = torch.stack([u, w], dim=3).reshape(L, B, n)
    return x[:, :, plan.perm]


def ntt_cuda(plan, v, inverse=False, coset=False):
    """Kernel 2 launches on a contiguous (8, B, n) int32 CUDA tensor."""
    F._check_words(FR, v, "ntt")
    if v.dim() != 3 or v.shape[2] != plan.n:
        raise ValueError("ntt: expected (8, B, %d), got %s"
                         % (plan.n, tuple(v.shape)))
    if v.device != plan.device or v.device.type != "cuda":
        raise ValueError("ntt: tensor and plan must lie on one CUDA device")
    tw, pre, post = plan.tables(inverse, coset)
    B = v.shape[1]
    x = v.clone()
    lib = _build.load()["ntt"]
    stream = F._stream(v)
    with torch.cuda.device(v.device):
        for s in range(plan.log_n):
            p0 = pre.data_ptr() if (s == 0 and pre is not None) else None
            p1 = (post.data_ptr()
                  if (s == plan.log_n - 1 and post is not None) else None)
            rc = lib.dpt_ntt_stage(x.data_ptr(), tw.data_ptr(), p0, p1,
                                   plan.log_n, s, B, stream)
            _build.check(rc, "ntt stage %d" % s)
            _build.LAUNCHES["ntt"] += 1
        out = torch.empty_like(x)
        rc = lib.dpt_ntt_bitrev(out.data_ptr(), x.data_ptr(), plan.log_n, B,
                                stream)
    _build.check(rc, "ntt bit-reversal")
    _build.LAUNCHES["ntt"] += 1
    return out


def ntt(plan, v, inverse=False, coset=False):
    """(8, B, n) Montgomery words -> their (i)(coset)NTT along the last
    axis. CUDA tensors launch kernel 2, CPU tensors run the plain version."""
    if v.device.type == "cpu":
        return ntt_ref(plan, v, inverse, coset)
    return ntt_cuda(plan, v.contiguous(), inverse, coset)
