"""Range-sharded variable-base MSM over a mesh: the port of the JAX
package's parallel/msm_mesh.py.

The counterpart of the reference's distributed MSM (reference
src/dispatcher2.rs:834-893, src/worker.rs:159-185): shard s holds the
contiguous range [s L, (s+1) L) of the bases, L = padded_n / D, with the
key padded by the identity to a multiple of 16 D (padding never changes a
sum). Each device builds the window-shifted key of the ranges it holds
(kernel 4's proj_add, msm_torch.shifted_key), and each shard, per
commitment batch, runs kernel 3 (msm_digits, bucket_sums) on its range
of the scalars. The D bucket planes then go to the lead device and fold
there with kernel 4's proj_add, and one msm_tail (kernel 4) finishes the
batch: the counterpart of the JAX package's all_gather + fold + finish,
and of the reference's host-side sum of partial totals
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


class MeshMsmContext:
    """A commit key range-sharded over a mesh, reused across commitments."""

    BATCH_CHUNK = MsmContext.BATCH_CHUNK

    def __init__(self, mesh, bases):
        self.mesh = mesh
        d = mesh.size
        n = len(bases)
        self.n = n
        self.padded_n = n + (-n) % (16 * d)
        self.local_n = loc = self.padded_n // d
        # the ranges of the shards this process holds, [lo, hi) of the
        # padded key: only they are normalized and shifted here
        lo = mesh.first * loc
        hi = lo + len(mesh.devices) * loc
        ax, ay, inf = self._affine_range(bases, lo, hi)
        # one key build per device over the ranges of the shards it holds
        # (the build is elementwise per point, then one batch inversion),
        # split into each shard's (W * local_n, 24) key
        _, c, windows, _ = M.window_of(loc)
        held = {}
        for s, dev in mesh.shards():
            held.setdefault(dev, []).append(s)
        self.shards = {}
        for dev, ss in held.items():
            x, y, f = (torch.cat([t[..., (s - mesh.first) * loc:
                                    (s - mesh.first + 1) * loc]
                                  for s in ss], dim=-1).to(dev)
                       for t in (ax, ay, inf))
            key = M.shifted_key(x, y, f, c, windows).reshape(
                windows, len(ss), loc, -1)
            for i, s in enumerate(ss):
                part = slice(i * loc, (i + 1) * loc)
                self.shards[s] = MsmContext.from_affine(
                    x[:, part], y[:, part], f[part],
                    key[:, i].reshape(windows * loc, -1).contiguous())

    def _affine_range(self, bases, lo, hi):
        """Columns [lo, hi) of the identity-padded key as (12, hi - lo)
        affine Montgomery x, y and the (hi - lo,) infinity mask, on the
        lead device (a device key is normalized on its own device)."""
        top = min(hi, self.n)
        if top <= lo:       # identity padding only
            return M.points_to_device([], hi - lo, self.mesh.lead)
        pad = hi - top
        if isinstance(bases, DeviceCommitKey):
            # a device-built key (Jacobian, arbitrary Z): the range
            # normalized once, then padded
            ax, ay, inf = CT.batch_to_affine(
                tuple(t[:, lo:top] for t in bases.point))
            ax, ay = (torch.nn.functional.pad(t, (0, pad)) for t in (ax, ay))
            inf = torch.nn.functional.pad(inf, (0, pad), value=True)
            return ax, ay, inf
        return M.points_to_device(bases[lo:top], pad, self.mesh.lead)

    def stack(self, hs):
        """(8, L <= n) handles -> one (8, B, padded_n) zero-padded batch on
        the lead device."""
        for h in hs:
            if h.shape[1] > self.n:
                raise ValueError("commit: %d coefficients for a key of %d"
                                 % (h.shape[1], self.n))
        return torch.stack([torch.nn.functional.pad(
            h.to(self.mesh.lead), (0, self.padded_n - h.shape[1]))
            for h in hs], dim=1)

    def bucket_planes(self, v):
        """(8, B, padded_n) scalars on the lead (the same in every process)
        -> the bucket sums of the whole key, folded on the lead:
        ((12, B, n_buckets),)*3. The planes of the shards held here fold
        in shard order; across processes, each process's folded planes
        are all-gathered and folded in rank order, the same order in every
        process, so every process holds the same projective sums."""
        loc = self.local_n
        planes = [ctx.bucket_planes(v[:, :, s * loc:(s + 1) * loc]
                                    .to(ctx.device))
                  for s, ctx in self.shards.items()]
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
        """Enqueue the commitments of (8, L <= n) Montgomery Fr coefficient
        handles, BATCH_CHUNK per launch sequence; returns force() -> affine
        host points (the transfers and the host decode)."""
        tail = self.shards[self.mesh.first].tail
        totals = [tail(self.bucket_planes(
            self.stack(hs[i:i + self.BATCH_CHUNK])))
            for i in range(0, len(hs), self.BATCH_CHUNK)]

        def force():
            return [p for t in totals for p in CT.proj_to_affine(t)]
        return force

    def msm_mont_limbs_many(self, hs):
        """Commit (8, L <= n) Montgomery Fr coefficient handles -> affine
        host points."""
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
