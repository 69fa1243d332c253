"""Sharded 4-step NTT over a mesh: the port of the JAX package's
parallel/ntt_mesh.py.

The counterpart of the reference's distributed FFT (its dispatcher,
reference src/dispatcher2.rs:731-787; worker stage kernels
src/worker.rs:66-115; peer all-to-all src/worker.rs:293-344,412-438). For N = r*c, w = w_N
(Bailey's 4-step decomposition, reference src/playground.rs:21-80):

  X[k1 + r*k2] = sum_{j2<c} w^{j2 k1} w_c^{j2 k2}
                   [ sum_{j1<r} x[j2 + c*j1] w_r^{j1 k1} ]

  1. A[j2, j1] = x[j2 + c*j1]; r-point NTT per row j2   (sharded over j2)
  2. A[j2, k1] *= w^{j2*k1}                             (elementwise)
  3. transpose -> B[k1, j2]                             (the all-to-all)
  4. c-point NTT per row k1                             (sharded over k1)
  output: X[k1 + r*k2] = B_hat[k1, k2].

Shard s holds rows j2 in [s c/D, (s+1) c/D) of A and rows k1 in
[s r/D, (s+1) r/D) of B. Its body runs, on its own device:

  the coset pre-scale (kernel 1); the r-point NTT of its c/D rows, one
  batched kernel-2 call; the mid twiddle (kernel 1); the all-to-all, tile
  (s, t) = its columns k1 in shard t's block, copied straight into shard
  t's buffer at rows j2 of block s, transposed on the way (the local
  transpose); the c-point NTT of its r/D rows (kernel 2); the inverse
  coset post-scale (kernel 1).

Kernel 2's inverse applies 1/size itself (1/r in step 1, 1/c in step 4,
whose product is the 1/n of the whole iNTT), so no table here carries a
size factor: the JAX tables fold n_inv into the post-scale instead.
Every table is a gather from one table of powers of w, w^-1, g or g^-1,
built on the shard's device (backend/tables_torch.py), once per mode.

Handles enter and leave on the lead device in natural order, (8, B, n)
Montgomery words, the layout of TorchBackend's handles: the scatter of A's
row blocks to the shards and the gather of B's row blocks back are plain
copies (views where a shard shares the lead's device).

On a multi-process mesh (mesh.init_multihost) every process holds the
same input and runs this body for the shards it holds: the tiles move in
one all-to-all per call (the tiles between its own shards ride the send
buffer too, so the result always passes through the collective), and
one all-gather of every process's B row blocks leaves the whole output
on every process.
"""

import torch

from ..constants import FR_GENERATOR
from ..fields import fr_inv, fr_root_of_unity
from ..backend import field_torch as F
from ..backend import limbs, ntt_torch
from ..backend.field_torch import FR
from ..backend.tables_torch import gather, powers


def _split_rc(n):
    """n = r*c with r = 2^floor(log2(n)/2) (the reference's split,
    reference src/worker.rs:142-155)."""
    log_n = n.bit_length() - 1
    r = 1 << (log_n // 2)
    return r, n // r


def divides(mesh_size, n):
    """Whether an n-point NTT shards over mesh_size shards (r and c both
    divisible by the shard count)."""
    r, c = _split_rc(n)
    return r % mesh_size == 0 and c % mesh_size == 0


class MeshNttPlan:
    """The tables of one (mesh, N) pair, built per mode on first use."""

    def __init__(self, mesh, n):
        if n < 4 or n & (n - 1):
            raise ValueError("MeshNttPlan: n must be a power of two >= 4")
        self.mesh = mesh
        self.n = n
        self.r, self.c = _split_rc(n)
        d = mesh.size
        if not divides(d, n):
            raise ValueError("mesh size %d must divide both r=%d and c=%d"
                             % (d, self.r, self.c))
        self.rows_a = self.c // d      # rows j2 of A per shard
        self.rows_b = self.r // d      # rows k1 of B per shard
        self._tables = {}

    def _arange(self, lo, hi, dev):
        return torch.arange(lo, hi, dtype=torch.int64, device=dev)

    def tables(self, inverse, coset):
        """Per shard this process holds, in mesh.shards() order (pre or
        None, mid, post or None): (8, 1, c/D, r) stage-1 tables at
        A[j2, j1] / A[j2, k1], the (8, 1, r/D, c) stage-2 table at
        B[k1, k2] (axis 1 broadcasts over the batch)."""
        key = (inverse, coset)
        if key in self._tables:
            return self._tables[key]
        n, r, c = self.n, self.r, self.c
        w = fr_root_of_unity(n)
        bases = {"mid": fr_inv(w) if inverse else w}
        if coset:
            bases["scale"] = fr_inv(FR_GENERATOR) if inverse \
                else FR_GENERATOR
        per_device = {}     # one table of powers per base and device
        out = []
        for s, dev in self.mesh.shards():
            if dev not in per_device:
                per_device[dev] = {k: powers(b, n, dev)
                                   for k, b in bases.items()}
            pw = per_device[dev]
            j2 = self._arange(s * self.rows_a, (s + 1) * self.rows_a,
                              dev)[None, :, None]
            j1 = self._arange(0, r, dev)[None, None, :]
            mid = gather(pw["mid"], j2 * j1)            # w^{+-j2 k1}
            pre = post = None
            if coset and not inverse:
                pre = gather(pw["scale"], j2 + c * j1)  # g^{j2 + c j1}
            if coset and inverse:
                k1 = self._arange(s * self.rows_b, (s + 1) * self.rows_b,
                                  dev)[None, :, None]
                k2 = self._arange(0, c, dev)[None, None, :]
                post = gather(pw["scale"], k1 + r * k2)  # g^-(k1 + r k2)
            out.append((pre, mid, post))
        self._tables[key] = out
        return out

    def ntt(self, v, inverse=False, coset=False):
        """(8, B, n) Montgomery words on the lead device (the same values in
        every process of a multi-process mesh) -> their (i)(coset)NTT,
        natural order, on the lead device (in every process)."""
        n, r, c = self.n, self.r, self.c
        shards = self.mesh.shards()
        lead = self.mesh.lead
        if v.dim() != 3 or v.shape[0] != FR.n_words or v.shape[2] != n:
            raise ValueError("mesh ntt: expected (8, B, %d), got %s"
                             % (n, tuple(v.shape)))
        B = v.shape[1]
        ra, rb = self.rows_a, self.rows_b
        tabs = self.tables(inverse, coset)
        plan_r = [ntt_torch.get_plan(r, dev) for _, dev in shards]
        plan_c = [ntt_torch.get_plan(c, dev) for _, dev in shards]
        a_all = v.reshape(FR.n_words, B, r, c).transpose(2, 3)  # A[j2, j1]

        # stage 1 on every shard held here: pre-scale, r-point rows, mid
        # twiddle
        stage1 = []
        for i, (s, dev) in enumerate(shards):
            pre, mid, _ = tabs[i]
            a = a_all[:, :, s * ra:(s + 1) * ra].contiguous().to(dev)
            if pre is not None:
                a = F.mont_mul(FR, a, pre)
            a = ntt_torch.ntt(plan_r[i], a.reshape(FR.n_words, B * ra, r),
                              inverse)
            stage1.append(F.mont_mul(FR, a.reshape(FR.n_words, B, ra, r),
                                     mid))

        # the all-to-all: shard s's columns k1 of block t land in shard t's
        # rows j2 of block s, transposed to B[k1, j2]
        stage2 = [torch.empty((FR.n_words, B, rb, c), dtype=torch.int32,
                              device=dev) for _, dev in shards]
        if self.mesh.transport is None:
            for t, dst in enumerate(stage2):
                for s, src in enumerate(stage1):
                    tile = src[:, :, :, t * rb:(t + 1) * rb]
                    dst[:, :, :, s * ra:(s + 1) * ra].copy_(
                        tile.transpose(2, 3))
        else:
            self._exchange(stage1, stage2)
        del stage1

        # stage 2 on every shard held here: c-point rows, inverse coset
        # post-scale; then B's row blocks to the lead in natural order
        out = torch.empty((FR.n_words, B, n), dtype=torch.int32,
                          device=lead)
        x_all = out.reshape(FR.n_words, B, c, r)    # X[k1 + r k2] at [k2, k1]
        ys = []
        for i, (t, dev) in enumerate(shards):
            _, _, post = tabs[i]
            y = ntt_torch.ntt(plan_c[i], stage2[i].reshape(
                FR.n_words, B * rb, c), inverse).reshape(FR.n_words, B, rb,
                                                         c)
            if post is not None:
                y = F.mont_mul(FR, y, post)
            if self.mesh.transport is None:
                x_all[:, :, :, t * rb:(t + 1) * rb].copy_(y.transpose(2, 3))
            else:
                ys.append(y.to(lead))
        if ys:
            # every process's row blocks, (D, 8, B, r/D, c) in shard order
            blocks = self.mesh.transport.all_gather(torch.stack(ys)).reshape(
                self.mesh.size, FR.n_words, B, rb, c)
            x_all.view(FR.n_words, B, c, self.mesh.size, rb).copy_(
                blocks.permute(1, 2, 4, 0, 3))
        return out

    def _exchange(self, stage1, stage2):
        """The all-to-all across processes: every tile (s, t) of the shards
        s held here goes, transposed, into slot rank(t) of one send buffer
        ((W, k, k, 8, B, r/D, c/D), packed in (s, t) order), one collective
        moves the slots, and each received tile lands at rows j2 of block s
        of shard t's B. Tiles between shards of this process ride the
        buffer's own slot, so the result always passes the collective."""
        mesh = self.mesh
        w, k = mesh.world, len(stage1)
        B = stage1[0].shape[1]
        ra, rb = self.rows_a, self.rows_b
        send = torch.empty((w, k, k, FR.n_words, B, rb, ra),
                           dtype=torch.int32, device=mesh.lead)
        for i, src in enumerate(stage1):
            # (8, B, c/D, r) -> its tiles by destination shard (q, j)
            send[:, i].copy_(src.view(FR.n_words, B, ra, w, k, rb)
                             .permute(3, 4, 0, 1, 5, 2))
        recv = mesh.transport.all_to_all(send)
        for j, dst in enumerate(stage2):
            # tiles (p, i) -> rows of block s = p k + i
            dst.view(FR.n_words, B, rb, w, k, ra).copy_(
                recv[:, :, j].permute(2, 3, 4, 0, 1, 5))

    def kernel(self, inverse=False, coset=False):
        """(8, n) -> (8, n) Montgomery-boundary transform on the lead."""
        return lambda h: self.ntt(h[:, None, :], inverse, coset)[:, 0]

    def run_ints(self, values, inverse=False, coset=False):
        """Canonical int list (zero-padded to n) -> canonical int list."""
        if len(values) > self.n:
            raise ValueError("run_ints: %d values for n = %d"
                             % (len(values), self.n))
        h = limbs.lift(list(values) + [0] * (self.n - len(values)),
                       self.mesh.lead)
        return limbs.lower(self.kernel(inverse, coset)(h))
