"""Batched stage panels of the sharded 4-step FFT for a port fleet worker:
the port of the JAX package's runtime/jax_stages.py.

A worker's FFT1 frame is a (16, B, r) canonical 16-bit-limb panel of B
stage-1 rows, its FFT2 input the (16, B, c) panel of its stage-2 columns
(the wire's layout, runtime/protocol.py). `StageKernels` runs a whole
panel on the device at once:

    from_jax_limbs -> to_mont -> [pre-scale] -> (i)NTT of every row
    -> [mid-scale] -> [post-scale] -> from_mont -> to_jax_limbs

The conversions and scales are kernel 1 (`field_torch.mont_mul` over the
(8, B, L) panel, one table entry per element) and the row transforms are
kernel 2 (`ntt_torch.ntt`, batched over B). A whole panel is one K2 call:
at 2^21 over 4 workers B is 512 stage-1 rows of 1,024 or 256 stage-2
columns of 2,048, and K2's blocks walk the batch's tiles in a grid-stride
loop, so no batch limit applies (TorchBackend's NTT_BATCH bounds round 3's
memory, not the kernel). CPU tensors run both kernels' plain versions.

The stage math equals worker._stage1_row / _stage2_row (the reference's
fft1/fft2 helpers, reference src/worker.rs:66-115) value for value:

  stage 1, row j2:   coset forward: x[j1] *= g^(j2 + c*j1)
                     r-point (i)NTT
                     mid twiddle:   y[k1] *= w^(+-j2*k1)
  stage 2, col k1:   c-point (i)NTT
                     inverse coset: y[k2] *= g^-(k1 + r*k2)

where w is the n-th root of unity and g the coset generator. Kernel 2's
inverse applies its 1/size itself (1/r in stage 1 and 1/c in stage 2,
whose product is the 1/n of the whole iNTT), as the int path's
backend.ifft does, so no table carries a size factor: the JAX stage core
omits it and folds 1/r and 1/c into its mid and post tables instead.

The tables are gathers from one table of powers of w, w^-1, g or g^-1 per
domain, built on the device by a prefix-product ladder of kernel 1
(backend/tables_torch.py), so no table is built from host ints.
"""

import threading

import torch

from ..constants import FR_GENERATOR
from ..fields import fr_inv, fr_root_of_unity
from ..backend import field_torch as F
from ..backend import limbs, ntt_torch
from ..backend.tables_torch import gather, powers
from ..backend.field_torch import FR


class StageKernels:
    """Per-worker cache of stage tables and the panel transform."""

    _TABLE_CAP = 8  # (n, mode, range) table sets kept resident

    def __init__(self, device=None):
        self.device = F.resolve_device(device, "StageKernels")
        self._tables = {}
        self._lock = threading.Lock()

    def _cached(self, key, build):
        """self._tables[key], built on a miss outside the lock; the oldest
        entry goes first when the cache is full."""
        with self._lock:
            hit = self._tables.get(key)
        if hit is not None:
            return hit
        built = build()
        with self._lock:
            hit = self._tables.get(key)
            if hit is None:
                if len(self._tables) >= self._TABLE_CAP:
                    self._tables.pop(next(iter(self._tables)))
                # analysis: ok(generic helper; each _cached call is linted)
                hit = self._tables[key] = built
        return hit

    def _arange(self, lo, hi):
        return torch.arange(lo, hi, dtype=torch.int64, device=self.device)

    def _stage1_tables(self, task, rs, re):
        """(pre or None, mid) tables for global rows j2 in [rs, re)."""
        def build():
            n, r, c = task.n, task.r, task.c
            j2 = self._arange(rs, re)[:, None]
            j1 = self._arange(0, r)[None, :]
            pre = None
            if task.coset and not task.inverse:
                pre = gather(powers(FR_GENERATOR, n, self.device),
                              j2 + c * j1)
            w = fr_root_of_unity(n)
            mid = gather(powers(fr_inv(w) if task.inverse else w, n,
                                  self.device), j2 * j1)
            return pre, mid
        return self._cached(("s1", task.n, task.inverse, task.coset, rs, re),
                            build)

    def _stage2_tables(self, task, cs, ce):
        """post table (or None) for global columns k1 in [cs, ce): the
        inverse coset's g^-(k1 + r*k2)."""
        if not (task.inverse and task.coset):
            return None

        def build():
            k1 = self._arange(cs, ce)[:, None]
            k2 = self._arange(0, task.c)[None, :]
            return gather(powers(fr_inv(FR_GENERATOR), task.n,
                                   self.device), k1 + task.r * k2)
        return self._cached(("s2", task.n, task.inverse, task.coset, cs, ce),
                            build)

    def panel_words(self, v, size, inverse, pre=None, mid=None, post=None,
                    plain=False):
        """(8, B, size) canonical words on the device -> the staged
        canonical words: to_mont, pre-scale, the size-point (i)NTT of every
        row, mid- and post-scale, from_mont. plain=True runs the kernels'
        plain versions on the same tensors (what the card's parity check
        holds the kernels against)."""
        mul = F.mont_mul_ref if plain else F.mont_mul
        ntt = ntt_torch.ntt_ref if plain else ntt_torch.ntt
        v = mul(FR, v, F.const(FR, FR.mont_r2, v.device, v.dim()))
        if pre is not None:
            v = mul(FR, v, pre)
        v = ntt(ntt_torch.get_plan(size, self.device), v, inverse)
        for scale in (mid, post):
            if scale is not None:
                v = mul(FR, v, scale)
        return mul(FR, v, F.const(FR, 1, v.device, v.dim()))

    def panel(self, panel, size, inverse, **tables):
        """(16, B, size) canonical limb panel (numpy uint32, the wire's
        layout) -> its staged panel in the same layout."""
        v = limbs.from_jax_limbs(panel, self.device)
        return limbs.to_jax_limbs(self.panel_words(v, size, inverse,
                                                   **tables))

    def stage1_panel(self, task, first_row, panel):
        """(16, B, r) canonical limb panel of rows [first_row, first_row +
        B) -> its staged panel (numpy)."""
        pre, mid = self._stage1_tables(task, first_row,
                                       first_row + panel.shape[1])
        return self.panel(panel, task.r, task.inverse, pre=pre, mid=mid)

    def stage2_panel(self, task, cols_panel):
        """(16, ce - cs, c) canonical columns panel -> the staged output
        panel (numpy), ready for the wire."""
        post = self._stage2_tables(task, task.cs, task.ce)
        return self.panel(cols_panel, task.c, task.inverse, post=post)

