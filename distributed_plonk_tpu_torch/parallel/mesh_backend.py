"""MeshBackend: the 5-round prover over a mesh, the port of the JAX
package's parallel/mesh_backend.py.

The mesh counterpart of the reference's fully-distributed v2 prover
(reference src/dispatcher2.rs:192-713), which drives per-FFT and per-MSM
fan-outs to workers (dispatcher2.rs:731-787, 834-893). Here one process
drives the mesh's devices:

  - NTTs run as the 4-step mesh NTT (ntt_mesh.MeshNttPlan: each shard's
    rows on kernels 1 and 2, one all-to-all of tiles between them);
  - commitments run as the range-sharded MSM (msm_mesh.MeshMsmContext:
    kernel 3 on each shard's range, the bucket planes folded on the lead
    device with kernel 4);
  - the round math (permutation product, quotient evaluation, blinding,
    evaluation, linear combination, synthetic division) is TorchBackend's,
    on the lead device, where every handle lives between calls. The JAX
    package lets GSPMD shard it once a shard holds 1,024 coefficients;
    that changes placement, not values.

Domains too small to shard (r or c of the 4-step split not divisible by
the shard count) use TorchBackend's single-device NTT on the lead device,
as the JAX backend does. Counters say which path took every call:
`mesh_ntt_calls` and `replicated_ntt_calls` count transformed polynomials
by domain size, `mesh_msm_calls` committed handles; a mesh that fell back
everywhere would still prove the same bytes, so a run reads them.

The mesh shards; it does not stream: `quotient_poly_streamed` and
`quotient_streamed` are None (as the JAX MeshBackend sets them), so round
3 runs one-shot (25 coset planes, each NTT on the mesh) and no fold
slices a sharded plane.

On a multi-process mesh (parallel/mesh.init_multihost) every process
constructs a MeshBackend and runs the same preprocess and prove with the
same rng: each computes its own shards, the mesh NTT's all-to-all and the
MSM's plane fold run as collectives, and the round math is replicated on
every process's lead device (the JAX package's replicated shardings), so
every process ends with the same proof bytes and the same counters. Every
process must issue the same collectives in the same order from one
thread, so `issues_collectives` tells the round pipeline
(prover.PipelinedProver), whose executor thread enqueues launches, to
refuse the backend; `prove` and `prove_many` drive it.
"""

import collections

import torch

from ..backend.autotune import cache_key
from ..backend.torch_backend import TorchBackend
from .msm_mesh import MeshMsmContext
from .ntt_mesh import MeshNttPlan, divides


class MeshBackend(TorchBackend):
    """Backend whose NTTs and commitments run sharded over a mesh; its
    handles are (8, L) Montgomery word tensors on the mesh's lead device."""

    name = "mesh"
    quotient_poly_streamed = None
    quotient_streamed = None

    def __init__(self, mesh):
        super().__init__(device=mesh.lead)
        self.mesh = mesh
        self._mesh_plans = {}
        self.mesh_ntt_calls = collections.Counter()
        self.replicated_ntt_calls = collections.Counter()
        self.mesh_msm_calls = 0

    @property
    def issues_collectives(self):
        """Whether its NTTs and commitments call collectives (a mesh over a
        process group), which every process must issue in one order."""
        return self.mesh.transport is not None

    def _plan(self, n):
        """The MeshNttPlan of size n, or None where n does not shard."""
        return self._cached(self._mesh_plans, n, lambda: (
            MeshNttPlan(self.mesh, n) if divides(self.mesh.size, n)
            else False)) or None

    # --- NTTs ----------------------------------------------------------------

    def _ntt_batches(self, domain, hs, inverse, coset, width):
        plan = self._plan(domain.size)
        if plan is None:
            self.replicated_ntt_calls[domain.size] += len(hs)
            yield from super()._ntt_batches(domain, hs, inverse, coset,
                                            width)
            return
        for i in range(0, len(hs), width):
            batch = torch.stack([self._pad(h, domain.size)
                                 for h in hs[i:i + width]], dim=1)
            self.mesh_ntt_calls[domain.size] += batch.shape[1]
            yield plan.ntt(batch, inverse, coset)

    def _run_ints(self, domain, values, inverse, coset):
        plan = self._plan(domain.size)
        if plan is None:
            self.replicated_ntt_calls[domain.size] += 1
            return super()._run_ints(domain, values, inverse, coset)
        self.mesh_ntt_calls[domain.size] += 1
        return plan.run_ints(values, inverse, coset)

    # --- commitments ---------------------------------------------------------

    def _ctx(self, ck):
        # keyed on the kernel plan's revision too: each shard's context
        # resolved its chunk when it was built
        return self._cached(self._msm_ctxs, cache_key(id(ck)),
                            lambda: (ck, MeshMsmContext(self.mesh, ck)))[1]

    def commit_many_h(self, ck, hs):
        self.mesh_msm_calls += len(hs)
        return super().commit_many_h(ck, hs)

    def commit_many_async(self, ck, hs):
        self.mesh_msm_calls += len(hs)
        return super().commit_many_async(ck, hs)

    def msm(self, bases, scalars):
        self.mesh_msm_calls += 1
        return super().msm(bases, scalars)
