"""Range-sharded variable-base MSM over a mesh: the port of the JAX
package's parallel/msm_mesh.py.

The counterpart of the reference's distributed MSM (reference
src/dispatcher2.rs:834-893, src/worker.rs:159-185): shard s holds a
range of the bases. The ranges line up with the lane blocks of the
handles the key commits (parallel/sharded.py), so a sharded handle's
piece feeds its shard's kernel 3 as it is: a key of N points (a
circuit's n + 3 powers padded to 32) serves circuits of domain n, the
largest power of two below N, whose handles of n to n + 3 lanes all have
blocks of b = n / D lanes. Shard s holds the points [s b, (s+1) b), then
its slice [D b + s e, D b + (s+1) e) of the N - D b points past the
blocks, e = ceil((N - D b) / D) (a handle's lanes past its blocks are on
every process); every range is padded with the identity to local_n =
b + e points (padding never changes a sum), so the shards share one
window and one bucket-plane shape. Each
device builds the window-shifted key of the ranges it holds (kernel 4's
proj_add, msm_torch.shifted_key), and each shard, per commitment batch,
runs kernel 3 (msm_digits, bucket_sums) on its range of the scalars,
padded on its own device. The D bucket planes then go to the lead device
and fold there with kernel 4's proj_add, and one msm_tail (kernel 4)
finishes the batch: the counterpart of the JAX package's all_gather +
fold + finish, and of the reference's host-side sum of partial totals
(dispatcher2.rs:888-890). On a multi-process mesh each process builds the
keys of only the shards it holds and folds their planes; one all-gather
then brings every process's planes to every process, which folds them in
rank order (the JAX package's all_gather). G1 addition is not a ring sum,
so the fold adds points, never words.

Each shard's window is the port's (msm_torch.MsmContext on its range:
signed c = 7 from 256 points, else unsigned); the JAX mesh uses c = 8.
Both give the same group element, and so the same affine commitment.
"""

import torch

from ..backend import curve_torch as CT
from ..backend import msm_torch as M
from ..backend.limbs import lift
from ..backend.msm_torch import DeviceCommitKey, MsmContext
from .sharded import take_many


def key_block(n_points, n_shards):
    """The lane block of the handles an n_points key commits: n / D, n the
    largest power of two below n_points (0 for a key of one point)."""
    if n_points < 2:
        return 0
    return (1 << ((n_points - 1).bit_length() - 1)) // n_shards


class MeshMsmContext:
    """A commit key range-sharded over a mesh, reused across commitments."""

    BATCH_CHUNK = MsmContext.BATCH_CHUNK

    def __init__(self, mesh, bases):
        self.mesh = mesh
        d = mesh.size
        n = len(bases)
        self.n = n
        self.block = b = key_block(n, d)
        self.extra = -(-(n - d * b) // d)      # e: past-block points a shard
        self.local_n = loc = b + self.extra
        self.padded_n = d * loc
        # one key build per device over the ranges of the shards it holds
        # (the build is elementwise per point, then one batch inversion),
        # split into each shard's (W * local_n, 24) key
        _, c, windows, _ = M.window_of(loc)
        held = {}
        for s, dev in mesh.shards():
            held.setdefault(dev, []).append(s)
        self.shards = {}
        for dev, ss in held.items():
            x, y, f = (torch.cat(parts, dim=-1).to(dev) for parts in zip(
                *[self._affine_range(bases, s) for s in ss]))
            key = M.shifted_key(x, y, f, c, windows).reshape(
                windows, len(ss), loc, -1)
            for i, s in enumerate(ss):
                part = slice(i * loc, (i + 1) * loc)
                self.shards[s] = MsmContext.from_affine(
                    x[:, part], y[:, part], f[part],
                    key[:, i].reshape(windows * loc, -1).contiguous())

    def _extra_range(self, s):
        """Shard s's points past the blocks, [lo, hi)."""
        lo = min(self.mesh.size * self.block + s * self.extra, self.n)
        return lo, min(lo + self.extra, self.n)

    def _affine_range(self, bases, s):
        """Shard s's points, identity-padded to local_n, as (12, local_n)
        affine Montgomery x, y and the (local_n,) infinity mask, on the
        lead device (a device key is normalized on its own device)."""
        b = self.block
        lo, hi = self._extra_range(s)
        pad = self.local_n - b - (hi - lo)
        if isinstance(bases, DeviceCommitKey):
            # a device-built key (Jacobian, arbitrary Z): the range
            # normalized once, then padded
            ax, ay, inf = CT.batch_to_affine(tuple(
                torch.cat([t[:, s * b:(s + 1) * b], t[:, lo:hi]], dim=1)
                for t in bases.point))
            ax, ay = (torch.nn.functional.pad(t, (0, pad)) for t in (ax, ay))
            inf = torch.nn.functional.pad(inf, (0, pad), value=True)
            return ax, ay, inf
        return M.points_to_device(list(bases[s * b:(s + 1) * b])
                                  + list(bases[lo:hi]), pad, self.mesh.lead)

    def stack(self, hs):
        """Handles of at most n lanes (whole tensors or Sharded) -> the
        batch's scalars per shard held here: one (8, B, local_n) tensor on
        the shard's device, its range's lanes zero-padded there. A Sharded
        handle's pieces are copied shard to shard; across processes only
        lanes whose shard lies in another process move."""
        for h in hs:
            if h.shape[1] > self.n:
                raise ValueError("commit: %d coefficients for a key of %d"
                                 % (h.shape[1], self.n))
        b, base = self.block, self.mesh.size * self.block
        pieces, tail = take_many(self.mesh, hs, 0, self.n, b,
                                 width=self.local_n)
        for (s, _), p in zip(self.mesh.shards(), pieces):
            lo, hi = self._extra_range(s)
            p[:, :, b:b + hi - lo].copy_(tail[:, :, lo - base:hi - base])
        return pieces

    def bucket_planes(self, blocks):
        """stack()'s per-shard scalars (the same values in every process)
        -> the bucket sums of the whole key, folded on the lead:
        ((12, B, n_buckets),)*3. The planes of the shards held here fold
        in shard order; across processes, each process's folded planes
        are all-gathered and folded in rank order, the same order in every
        process, so every process holds the same projective sums."""
        planes = [ctx.bucket_planes(v) for ctx, v in zip(
            (self.shards[s] for s, _ in self.mesh.shards()), blocks)]
        lead = self.mesh.lead
        acc = planes[0]
        for p in planes[1:]:
            acc = CT.proj_add(acc, tuple(c.to(lead) for c in p))
        if self.mesh.transport is None:
            return acc
        ranks = self.mesh.transport.all_gather(torch.stack(
            [c.to(lead) for c in acc]))             # (W, 3, 12, B, buckets)
        acc = tuple(ranks[0])
        for q in range(1, self.mesh.world):
            acc = CT.proj_add(acc, tuple(ranks[q]))
        return acc

    def msm_mont_limbs_many_async(self, hs):
        """Enqueue the commitments of Montgomery Fr coefficient handles of
        at most n lanes (whole or Sharded), BATCH_CHUNK per launch
        sequence; returns force() -> affine
        host points (the transfers and the host decode)."""
        tail = self.shards[self.mesh.first].tail
        totals = [tail(self.bucket_planes(
            self.stack(hs[i:i + self.BATCH_CHUNK])))
            for i in range(0, len(hs), self.BATCH_CHUNK)]

        def force():
            return [p for t in totals for p in CT.proj_to_affine(t)]
        return force

    def msm_mont_limbs_many(self, hs):
        """Commit Montgomery Fr coefficient handles of at most n lanes
        (whole or Sharded) -> affine host points."""
        return self.msm_mont_limbs_many_async(hs)()

    def msm_mont_limbs(self, h):
        return self.msm_mont_limbs_many([h])[0]

    def msm_many(self, scalar_lists):
        """B MSMs over host int scalar lists."""
        return self.msm_mont_limbs_many([lift(s, self.mesh.lead)
                                         for s in scalar_lists])

    def msm(self, scalars):
        """sum_i scalars_i * bases_i -> affine point (host ints) or None."""
        return self.msm_many([scalars])[0]
