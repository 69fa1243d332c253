"""The collectives of a multi-process mesh (parallel/mesh.init_multihost).

The counterpart of the reference's FFT exchange between worker peers
(reference src/worker.rs:293-344,412-438) and of the JAX package's
lax.all_to_all / all_gather over a multi-host mesh (JAX
parallel/ntt_mesh.py:168, parallel/msm_mesh.py:203). Two operations, both
over the mesh's torch.distributed process group:

  all_to_all(send)  send is (W, ...): slot q goes to rank q; returns the
                    (W, ...) tensor whose slot p came from rank p (an
                    equal-split all_to_all_single);
  all_gather(t)     returns (W, *t.shape), slot p rank p's t.

The transport follows the group's backend, which the caller fixed: NCCL
takes the CUDA tensors as they are; gloo stages each tensor through one
contiguous host buffer and copies the result back to the tensor's device,
so the path does not depend on which collectives gloo accepts on CUDA
tensors. There is no fallback between the two. Each call adds its bytes
(the tensor handed to the collective) and its seconds (host clock, from
the staging copy until the result is on the caller's device, waiting for
the other ranks included) to `stats`.
"""

import collections
import time

import torch
import torch.distributed as dist


class Transport:
    """Equal-split all-to-all and all-gather over one process group."""

    def __init__(self, group, backend):
        if backend not in ("nccl", "gloo"):
            raise ValueError("transport: unsupported backend %r" % (backend,))
        self.group = group
        self.backend = backend
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        # op -> {"calls", "bytes", "seconds"}
        self.stats = collections.defaultdict(
            lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})

    def reset_stats(self):
        self.stats.clear()

    def _stage(self, t):
        """The tensor the collective takes: t itself under NCCL (a CUDA
        tensor, made contiguous), else a contiguous host copy."""
        if self.backend == "nccl":
            if t.device.type != "cuda":
                raise ValueError("transport: NCCL needs CUDA tensors, got %s"
                                 % t.device)
            return t.contiguous()
        return t.to("cpu").contiguous()

    def _finish(self, op, out, like, t0):
        out = out.to(like.device)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        rec = self.stats[op]
        rec["calls"] += 1
        rec["bytes"] += like.numel() * like.element_size()
        rec["seconds"] += time.perf_counter() - t0
        return out

    def all_to_all(self, send):
        if send.shape[0] != self.world:
            raise ValueError("all_to_all: %d slots for %d ranks"
                             % (send.shape[0], self.world))
        t0 = time.perf_counter()
        src = self._stage(send)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return self._finish("all_to_all", out, send, t0)

    def all_gather(self, t):
        t0 = time.perf_counter()
        src = self._stage(t)
        out = torch.empty((self.world,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
        dist.all_gather(list(out.unbind(0)), src, group=self.group)
        return self._finish("all_gather", out, t, t0)
