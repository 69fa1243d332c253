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

A batch enters either whole, (8, B, n) Montgomery words on the lead
device (the same in every process), or as lane blocks: shard s holds
lanes [s n/D, (s+1) n/D) of each polynomial on its own device (the
layout of parallel/sharded.py's handles). Lane blocks are not A's row
blocks: lane block s' holds rows j1 of block s' of A^T and every j2, so
the entry is one more tile exchange, tile (s', s) = its columns j2 of
block s. The output leaves whole (B's row blocks copied into one tensor
on the lead; across processes, one all-gather of every process's row
blocks) or as lane blocks: lane block u holds X[k1 + r k2] for k2 in
block u and every k1, so the exit is a third tile exchange, tile (t, u)
= shard t's rows k1 at columns k2 of block u. All three exchanges are
the same transposing tile move (`_transpose`); the JAX package pays the
entry and exit as GSPMD collectives (its with_sharding_constraint, JAX
parallel/ntt_mesh.py:201-211). With lane blocks in and out, no whole
(8, B, n) tensor is built anywhere.

On a multi-process mesh (mesh.init_multihost) every process runs this
body for the shards it holds: each exchange is one all-to-all (the tiles
between its own shards ride the send buffer too, so the result always
passes the collective), and a whole output takes one all-gather.
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

    def ntt(self, v, inverse=False, coset=False, sharded=False):
        """The (i)(coset)NTT of a batch of B polynomials, in natural order.

        v: (8, B, n) Montgomery words on the lead device (the same values
        in every process), or a list of this process's lane blocks: one
        (8, B, n/D) tensor per shard it holds (mesh.shards() order), shard
        s holding lanes [s n/D, (s+1) n/D) of each polynomial on its
        device. The list is consumed (emptied), so each stage's blocks
        free as the next stage takes them: the call holds at most two
        copies of the batch. Returns the whole (8, B, n) on the lead (in
        every process), or, with sharded=True, the output's lane blocks as
        a list like v."""
        n, r, c = self.n, self.r, self.c
        shards = self.mesh.shards()
        ra, rb = self.rows_a, self.rows_b
        if isinstance(v, torch.Tensor):
            if v.dim() != 3 or v.shape[0] != FR.n_words or v.shape[2] != n:
                raise ValueError("mesh ntt: expected (8, B, %d), got %s"
                                 % (n, tuple(v.shape)))
            B = v.shape[1]
            a_all = v.reshape(FR.n_words, B, r, c).transpose(2, 3)
            # shard s's rows j2 of A[j2, j1], sliced from the whole
            blocks = [a_all[:, :, s * ra:(s + 1) * ra].contiguous().to(dev)
                      for s, dev in shards]
        else:
            B = v[0].shape[1]
            want = (FR.n_words, B, n // self.mesh.size)
            if len(v) != len(shards) or \
                    any(tuple(x.shape) != want for x in v):
                raise ValueError("mesh ntt: expected %d lane blocks %s, "
                                 "got %s" % (len(shards), want, [
                                     tuple(x.shape) for x in v]))
            # the entry relayout: lane block s' = rows j1 of block s' of
            # A^T; tile (s', s) is its columns j2 of block s
            blocks = self._transpose(v, rb, ra)
        tabs = self.tables(inverse, coset)
        plan_r = [ntt_torch.get_plan(r, dev) for _, dev in shards]
        plan_c = [ntt_torch.get_plan(c, dev) for _, dev in shards]

        # stage 1 on every shard held here: pre-scale, r-point rows, mid
        # twiddle
        stage1 = []
        for i in range(len(blocks)):
            pre, mid, _ = tabs[i]
            a, blocks[i] = blocks[i].reshape(FR.n_words, B, ra, r), None
            if pre is not None:
                a = F.mont_mul(FR, a, pre)
            a = ntt_torch.ntt(plan_r[i], a.reshape(FR.n_words, B * ra, r),
                              inverse)
            stage1.append(F.mont_mul(FR, a.reshape(FR.n_words, B, ra, r),
                                     mid))
        del a

        # the all-to-all: shard s's columns k1 of block t land in shard t's
        # rows j2 of block s, transposed to B[k1, j2]
        stage2 = self._transpose(stage1, ra, rb)

        # stage 2 on every shard held here: c-point rows, inverse coset
        # post-scale
        ys = []
        for i in range(len(stage2)):
            _, _, post = tabs[i]
            b, stage2[i] = stage2[i], None
            y = ntt_torch.ntt(plan_c[i], b.reshape(FR.n_words, B * rb, c),
                              inverse).reshape(FR.n_words, B, rb, c)
            del b
            if post is not None:
                y = F.mont_mul(FR, y, post)
            ys.append(y)
        del y
        if sharded:
            # the exit relayout: lane block u holds X[k1 + r k2] for k2 in
            # block u, at [k2, k1]; tile (t, u) is shard t's rows k1 at
            # columns k2 of block u
            return [x.reshape(FR.n_words, B, n // self.mesh.size)
                    for x in self._transpose(ys, rb, ra)]
        # B's row blocks to the lead in natural order
        lead = self.mesh.lead
        out = torch.empty((FR.n_words, B, n), dtype=torch.int32,
                          device=lead)
        x_all = out.reshape(FR.n_words, B, c, r)    # X[k1 + r k2] at [k2, k1]
        if self.mesh.transport is None:
            for (t, _), y in zip(shards, ys):
                x_all[:, :, :, t * rb:(t + 1) * rb].copy_(y.transpose(2, 3))
        else:
            # every process's row blocks, (D, 8, B, r/D, c) in shard order
            blocks = self.mesh.transport.all_gather(torch.stack(
                [y.to(lead) for y in ys])).reshape(
                    self.mesh.size, FR.n_words, B, rb, c)
            x_all.view(FR.n_words, B, c, self.mesh.size, rb).copy_(
                blocks.permute(1, 2, 4, 0, 3))
        return out

    def _transpose(self, srcs, p, q):
        """The tile exchange of all three relayouts. srcs: per shard held
        here, a tensor of (8, B, p, D, q) layout, consumed (the list is
        emptied as the tiles leave); returns per shard held here the (8,
        B, q, D, p) tensor whose tile [:, :, :, s] is source s's tile
        [:, :, :, t] transposed (t the destination). In one process: D x D
        tile copies between the shards' devices. Across
        processes: every tile goes, transposed, into slot rank(t) of one
        send buffer ((W, k, k, 8, B, q, p), packed in (s, t) order), one
        all_to_all moves the slots, and each received tile lands in block
        s of shard t (tiles between this process's own shards ride its
        own slot, so the result always passes the collective)."""
        mesh = self.mesh
        d = mesh.size
        B = srcs[0].shape[1]
        outs = [torch.empty((FR.n_words, B, q, d, p), dtype=torch.int32,
                            device=dev) for _, dev in mesh.shards()]
        w, k = mesh.world, len(srcs)
        if mesh.transport is None:
            for s in range(k):
                src, srcs[s] = srcs[s].reshape(FR.n_words, B, p, d, q), None
                for t, dst in enumerate(outs):
                    dst[:, :, :, s].copy_(src[:, :, :, t].transpose(2, 3))
            return outs
        send = torch.empty((w, k, k, FR.n_words, B, q, p),
                           dtype=torch.int32, device=mesh.lead)
        for i in range(k):
            # (8, B, p, D, q) -> its tiles by destination shard (rank, j)
            src, srcs[i] = srcs[i], None
            send[:, i].copy_(src.reshape(FR.n_words, B, p, w, k, q)
                             .permute(3, 4, 0, 1, 5, 2))
        del src
        recv = mesh.transport.all_to_all(send)
        del send
        for j, dst in enumerate(outs):
            # tiles (rank, i) -> block s = rank k + i
            dst.view(FR.n_words, B, q, w, k, p).copy_(
                recv[:, :, j].permute(2, 3, 4, 0, 1, 5))
        return outs

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
