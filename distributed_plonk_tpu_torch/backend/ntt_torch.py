"""Radix-2 NTT / iNTT (+ coset variants) over Fr word tensors: the port of
backend/ntt_jax.py's NttPlan / get_plan.

Semantics are poly.Domain's: the same root of unity (fr_root_of_unity(n))
and coset shift (FR_GENERATOR), so every mode is bit-identical to the host
oracle and to ntt_jax in natural order:

  forward:  out[i] = sum_j v_j w^{ij}
  inverse:  out[j] = 1/n sum_i v_i w^{-ij}
  coset:    forward of v_j g^j / inverse followed by out_j g^{-j}

All at the Montgomery boundary (handles in, handles out), with a batch axis:
(8, B, n) -> (8, B, n). Kernel 2 (csrc/ntt.cu) runs ceil(log2 n / R)
passes of up to R radix-2 stages each in shared memory (R = MAX_LOG_ROWS):
a Cooley-Tukey split of n into digits n_1 ... n_P, the column DFTs of one
digit per pass, a per-pass twiddle table between passes, natural order
out of the last pass's stores. The coset pre-scale rides the first pass,
the inverse post-scale the last. `NttPlan` holds each pass's geometry and
tables; `ntt_ref`, the plain version, runs the same passes with the same
tables and index maps.

R and the tile width (TILE_LOG_COLS) are runtime arguments of the
kernel: `plan_params` resolves them per size (an explicit argument, else
the active kernel plan of backend/autotune.py, else these constants), and
every split gives the same output words. The scale tables, which do not
depend on the split, are built once per size and device and shared by
its plans.
"""

import ctypes
import threading

import torch

from ..constants import R_MOD, FR_GENERATOR, FR_MONT_R, FR_WORDS
from ..fields import fr_inv, fr_root_of_unity
from . import _build
from . import field_torch as F
from .autotune import resolve
from .field_torch import FR
from .limbs import ints_to_words, to_tensor

MAX_LOG_ROWS = 8    # radix-2 stages per pass: 2^8 rows x 32 B = 8 KB a column
TILE_LOG_COLS = 2   # a block's tile: 4 neighbouring columns
# dynamic shared memory a block may opt in to on compute capability 9.0
SMEM_MAX = 227 * 1024


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


def _bitrev(k, bits):
    return int(format(k, "0%db" % bits)[::-1], 2)


def split_digits(log_n, max_log_rows=MAX_LOG_ROWS):
    """log2 of the digit sizes n_1 .. n_P, the fewest passes of at most
    max_log_rows stages, larger digits first (2^13 -> [7, 6])."""
    passes = -(-log_n // max_log_rows)
    base, extra = divmod(log_n, passes)
    return [base + 1] * extra + [base] * (passes - extra)


def plan_params(n, max_log_rows=None, tile_log_cols=None):
    """(max_log_rows, tile_log_cols) of an n-point plan: the explicit
    arguments, else the active kernel plan's cell nearest n, else
    MAX_LOG_ROWS and TILE_LOG_COLS."""
    return (resolve(max_log_rows, "ntt", "max_log_rows", n, MAX_LOG_ROWS),
            resolve(tile_log_cols, "ntt", "tile_log_cols", n,
                    TILE_LOG_COLS))


def _log_cols(n, digits, p, tile_log_cols):
    """log2 of pass p's tile width: up to tile_log_cols, within the
    columns the pass has (the sub-transforms before the last pass, the
    first digit's values in the last)."""
    if p < len(digits) - 1:
        cols = (n >> sum(digits[:p])) >> digits[p]
        return min(tile_log_cols, cols.bit_length() - 1)
    return min(tile_log_cols, digits[0] if len(digits) > 1 else 0)


def pass_shapes(n, max_log_rows, tile_log_cols):
    """[(log_rows, log_cols)] of each pass of an n-point plan."""
    digits = split_digits(n.bit_length() - 1, max_log_rows)
    return [(d, _log_cols(n, digits, p, tile_log_cols))
            for p, d in enumerate(digits)]


def pass_smem_bytes(log_rows, log_cols):
    """Dynamic shared memory of one block of a pass (csrc/ntt.cu: two
    tile buffers of 8 words by slots_per_word)."""
    slots = (1 << (log_rows + log_cols)) + ((1 << log_rows)
                                            >> (5 - log_cols))
    return 2 * 8 * 4 * slots


class NttPass:
    """One pass of kernel 2: the column DFTs of one index digit over tiles
    of neighbouring columns, where each tile's elements come from and go
    to (NttPass in csrc/ntt.cu, field for field), and the pass's tables:
    stage twiddles, the twiddle table before the next pass (all but the
    last pass) and the natural offsets of the last pass's middle index."""

    ORDER = ("log_rows", "log_cols", "mids", "tiles_per_mid", "tiles", "n",
             "word_stride", "in_mid", "in_tile", "in_col", "in_row",
             "out_mid", "out_tile", "out_col", "out_row", "tw_row",
             "tw_tile", "tw_words", "stage_words")

    def __init__(self, n, digits, p, w, device, tile_log_cols):
        self.n = n
        self.log_rows = digits[p]
        self.log_cols = _log_cols(n, digits, p, tile_log_cols)
        rows = 1 << self.log_rows
        self.last = p == len(digits) - 1
        sub = n >> sum(digits[:p])                  # N_p, this sub-DFT
        w_rows = pow(w, n >> self.log_rows, R_MOD)  # root of order n_p
        # stage st's twiddles w_rows^(k 2^st), k < 2^(log_rows - st - 1)
        self.stage_table = _mont_table(
            [pow(w_rows, k << st, R_MOD) for st in range(self.log_rows)
             for k in range(rows >> (st + 1))], device)
        self.stage_words = rows - 1
        self.tw_table = self.lv_table = None
        self.tw_row = self.tw_tile = self.tw_words = 0
        if not self.last:
            cols = sub >> self.log_rows                 # S
            self.mids = n // sub
            self.tiles_per_mid = cols >> self.log_cols
            self.in_mid, self.in_tile = sub, 1 << self.log_cols
            self.in_col, self.in_row = 1, cols
            self.out_mid, self.out_tile = self.in_mid, self.in_tile
            self.out_col, self.out_row = self.in_col, self.in_row
            # output (k, s) times w_sub^(k s), at table index k * S + s:
            # row k is the powers of w_sub^k, a product an entry (a pow
            # an entry took a minute at 2^21)
            w_sub = pow(w, n // sub, R_MOD)
            self.tw_row, self.tw_tile, self.tw_words = (
                cols, 1 << self.log_cols, sub)
            tw, step = [], 1
            for _ in range(rows):
                tw += _powers(step, cols)
                step = step * w_sub % R_MOD
            self.tw_table = _mont_table(tw, device)
        else:
            # the columns are the sub-transforms; a tile takes neighbouring
            # values of the first digit k_1 (neighbours in natural order)
            first = digits[0] if len(digits) > 1 else 0
            self.mids = n >> (first + self.log_rows)     # digits 2 .. P-1
            self.tiles_per_mid = (1 << first) >> self.log_cols
            self.in_mid, self.in_row = rows, 1
            self.in_col = n >> first
            self.in_tile = self.in_col << self.log_cols
            self.out_mid, self.out_tile = 0, 1 << self.log_cols
            self.out_col, self.out_row = 1, n >> self.log_rows
            self.lv_table = torch.tensor(
                [self._natural(v, digits[1:-1]) << first
                 for v in range(self.mids)], dtype=torch.int64,
                device=device)

    @staticmethod
    def _natural(v, mid_digits):
        """Middle index v holds k_2 .. k_{P-1} high digit first (the order
        the passes stored them in); in natural order k_2 is the low digit:
        k_2 + n_2 (k_3 + n_3 (...))."""
        ks = []
        for d in reversed(mid_digits):       # k_{P-1} first
            ks.append(v & ((1 << d) - 1))
            v >>= d
        nat = 0
        for k, d in zip(ks, reversed(mid_digits)):
            nat = (nat << d) | k
        return nat

    def geometry(self, batch):
        """The 19 integers dpt_ntt_pass reads, for a batch of B rows."""
        per_batch = {"tiles": batch * self.mids * self.tiles_per_mid,
                     "word_stride": batch * self.n}
        return [per_batch[k] if k in per_batch else getattr(self, k)
                for k in self.ORDER]

    def index_maps(self, device):
        """(in, out, twiddle) element indices of every (mid, tile, column,
        row or output k), shaped (mids, tiles, cols, rows): the kernel's
        address arithmetic, written out for the plain version."""
        def ar(m, axis):
            shape = [1, 1, 1, 1]
            shape[axis] = m
            return torch.arange(m, dtype=torch.int64,
                                device=device).reshape(shape)

        mid, t = ar(self.mids, 0), ar(self.tiles_per_mid, 1)
        c, r = ar(1 << self.log_cols, 2), ar(1 << self.log_rows, 3)
        src = (mid * self.in_mid + t * self.in_tile + c * self.in_col
               + r * self.in_row)
        base = (self.lv_table.to(device).reshape(-1, 1, 1, 1)
                if self.lv_table is not None else mid * self.out_mid)
        dst = base + t * self.out_tile + c * self.out_col + r * self.out_row
        tw = (r * self.tw_row + t * self.tw_tile + c
              if self.tw_table is not None else None)
        return src, dst, tw


_SCALES = {}
_SCALES_LOCK = threading.Lock()


def _scale_tables(n, device):
    """(coset pre-scale g^i, post-scale g^-i / n, post-scale 1/n) of size
    n on device: independent of the pass split, built once and shared by
    every plan of that size."""
    key = (n, str(device))
    with _SCALES_LOCK:
        tabs = _SCALES.get(key)
        if tabs is None:
            g = FR_GENERATOR
            n_inv = fr_inv(n % R_MOD)
            tabs = _SCALES[key] = (
                _mont_table(_powers(g, n), device),
                _mont_table(_powers(fr_inv(g), n, start=n_inv), device),
                _mont_table([n_inv] * n, device))
    return tabs


class NttPlan:
    """Pass geometry and tables for one domain size, on one device (None:
    the card), built once: the passes for the forward and for the inverse
    root; the coset pre-scale g^i; the inverse post-scales 1/n and
    g^-i / n, in natural order. max_log_rows and tile_log_cols: see
    plan_params."""

    def __init__(self, n, device=None, max_log_rows=None,
                 tile_log_cols=None):
        assert n >= 2 and n & (n - 1) == 0, n
        self.n = n
        self.log_n = n.bit_length() - 1
        self.device = F.resolve_device(device, "NttPlan")
        self.max_log_rows, self.tile_log_cols = plan_params(
            n, max_log_rows, tile_log_cols)
        self.digits = split_digits(self.log_n, self.max_log_rows)
        w = fr_root_of_unity(n)
        self.passes = {
            inverse: [NttPass(n, self.digits, p, root, self.device,
                              self.tile_log_cols)
                      for p in range(len(self.digits))]
            for inverse, root in ((False, w), (True, fr_inv(w)))}
        self.coset_tab, self.post_coset, self.post_plain = \
            _scale_tables(n, self.device)
        self._maps = {}

    def tables(self, inverse, coset):
        """(passes, pre-scale or None, post-scale or None)."""
        pre = self.coset_tab if (coset and not inverse) else None
        post = None
        if inverse:
            post = self.post_coset if coset else self.post_plain
        return self.passes[inverse], pre, post

    def index_maps(self, inverse, p):
        """Pass p's index maps (NttPass.index_maps), built once."""
        key = (inverse, p)
        if key not in self._maps:
            self._maps[key] = self.passes[inverse][p].index_maps(
                self.device)
        return self._maps[key]

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
_PLANS_LOCK = threading.Lock()


def get_plan(n, device=None, max_log_rows=None, tile_log_cols=None):
    """The cached NttPlan of size n on device (None: the card), its pass
    split and tile resolved by plan_params. The cache keys on the
    resolved values, which are all a plan depends on: a reloaded kernel
    plan reaches a plan of its own split, and the splits it shares with
    the previous one keep their tables (at 2^21 they take tens of seconds
    to build). Safe under concurrent first use (a fleet worker serves each
    connection on its own thread): the plan is built once, under the
    lock."""
    device = F.resolve_device(device, "get_plan")
    max_log_rows, tile_log_cols = plan_params(n, max_log_rows,
                                              tile_log_cols)
    key = (n, str(device), max_log_rows, tile_log_cols)
    with _PLANS_LOCK:
        plan = _PLANS.get(key)
        if plan is None:
            plan = _PLANS[key] = NttPlan(n, device, max_log_rows,
                                         tile_log_cols)
    return plan


def _column_dft(ps, x):
    """Radix-2 DIF along the last axis (the rows of each column), with the
    pass's stage twiddles; output k lands at row bitrev(k), as in shared
    memory."""
    rows = 1 << ps.log_rows
    shape = x.shape
    off = 0
    for st in range(ps.log_rows):
        half = rows >> (st + 1)
        xs = x.reshape(shape[:-1] + (rows // (2 * half), 2, half))
        u, v = xs[..., 0, :], xs[..., 1, :]
        d = F.sub(FR, u, v)
        u = F.add(FR, u, v)
        tw = ps.stage_table[:, off:off + half]
        v = F.mont_mul_ref(FR, d, tw.reshape((FR_WORDS,)
                                             + (1,) * (d.dim() - 2)
                                             + (half,)))
        x = torch.stack([u, v], dim=-2).reshape(shape)
        off += half
    return x


def ntt_ref(plan, v, inverse=False, coset=False):
    """Plain torch version of kernel 2: the same passes, tables and index
    maps, on (8, B, n) Montgomery words."""
    passes, pre, post = plan.tables(inverse, coset)
    L, B, n = v.shape
    x = v
    for p, ps in enumerate(passes):
        src, dst, tw = plan.index_maps(inverse, p)
        t = x[:, :, src]                          # (8, B, mids, T, C, rows)
        if p == 0 and pre is not None:
            t = F.mont_mul_ref(FR, t, pre[:, src][:, None])
        t = _column_dft(ps, t)
        rows = 1 << ps.log_rows
        perm = [_bitrev(k, ps.log_rows) for k in range(rows)]
        t = t[..., perm]                          # output k at position k
        if ps.tw_table is not None:
            t = F.mont_mul_ref(FR, t, ps.tw_table[:, tw][:, None])
        if ps.last and post is not None:
            t = F.mont_mul_ref(FR, t, post[:, dst][:, None])
        out = torch.empty_like(x)
        out[:, :, dst] = t
        x = out
    return x


def ntt_cuda(plan, v, inverse=False, coset=False):
    """Kernel 2 launches, one per pass, on a contiguous (8, B, n) int32
    CUDA tensor."""
    F._check_words(FR, v, "ntt")
    if v.dim() != 3 or v.shape[2] != plan.n:
        raise ValueError("ntt: expected (8, B, %d), got %s"
                         % (plan.n, tuple(v.shape)))
    if v.device != plan.device or v.device.type != "cuda":
        raise ValueError("ntt: tensor and plan must lie on one CUDA device")
    passes, pre, post = plan.tables(inverse, coset)
    B = v.shape[1]
    out = torch.empty_like(v)
    # a middle pass works in place; the first reads v, the last writes out
    scratch = torch.empty_like(v) if len(passes) > 1 else None
    fn = _build.load()["ntt"].dpt_ntt_pass
    stream = F._stream(v)
    src = v
    with torch.cuda.device(v.device):
        for p, ps in enumerate(passes):
            dst = out if ps.last else scratch
            geo = (ctypes.c_longlong * 19)(*ps.geometry(B))
            rc = fn(geo, dst.data_ptr(), src.data_ptr(),
                    ps.stage_table.data_ptr(),
                    ps.tw_table.data_ptr() if ps.tw_table is not None
                    else None,
                    pre.data_ptr() if (p == 0 and pre is not None) else None,
                    post.data_ptr() if (ps.last and post is not None)
                    else None,
                    ps.lv_table.data_ptr() if ps.lv_table is not None
                    else None, stream)
            _build.check(rc, "ntt pass %d" % p)
            _build.count("ntt")
            src = dst
    _build.count("ntt", _build.CALLS)
    return out


def ntt(plan, v, inverse=False, coset=False):
    """(8, B, n) Montgomery words -> their (i)(coset)NTT along the last
    axis. CUDA tensors launch kernel 2, CPU tensors run the plain version."""
    if v.device.type == "cpu":
        return ntt_ref(plan, v, inverse, coset)
    return ntt_cuda(plan, v.contiguous(), inverse, coset)
