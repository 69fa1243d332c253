"""Device meshes: the port of the JAX package's parallel/mesh.py.

Where the reference enumerates worker socket addresses (its
config/network.json), a mesh enumerates the devices of one shard axis.
The JAX package builds a jax.sharding.Mesh and lets XLA place each shard;
here a `Mesh` is a plain tuple of torch devices, one per shard, driven by
one process (single controller). A device may appear more than once: four
shards on one card run the 4-way sharded code with every kernel on that
card, as the JAX tests run an 8-device mesh on virtual CPU devices.

The JAX module's `pallas_guard` has no counterpart: the port has no SPMD
partitioner for a kernel to break, each shard's kernels run on that
shard's own tensors.
"""

import torch

from ..backend import field_torch as F


class Mesh:
    """A 1-D mesh: `devices[s]` holds shard s; the lead device (shard 0's)
    holds the prover's handles and runs the round math."""

    def __init__(self, devices):
        devs = tuple(F.device_of(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError("a mesh's devices must be of one type: %s"
                             % (devs,))
        self.devices = devs

    @property
    def size(self):
        return len(self.devices)

    @property
    def lead(self):
        return self.devices[0]

    def __repr__(self):
        return "Mesh(%s)" % ", ".join(str(d) for d in self.devices)


def init_multihost(coordinator, num_processes, process_id,
                   local_device_ids=None):
    """Multi-host meshes (the JAX package joins hosts through
    jax.distributed) wait for a port on torch.distributed."""
    raise NotImplementedError("init_multihost: not ported")


def make_submesh(devices):
    """1-D mesh over an explicit device list (the placement scheduler's
    construction hook in the JAX package)."""
    return Mesh(list(devices))


def make_mesh(n_shards=None, device=None):
    """1-D mesh of n_shards shards.

    device None: the visible CUDA cards, dealt round robin (n_shards None:
    one shard per card); raises without a card. device "cuda:k" or "cpu":
    every shard on that one device (n_shards None: one shard)."""
    if device is None:
        F.resolve_device(None, "make_mesh")
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        count = len(cards) if n_shards is None else n_shards
        return Mesh([cards[s % len(cards)] for s in range(count)])
    dev = F.resolve_device(device, "make_mesh")
    return Mesh([dev] * (1 if n_shards is None else n_shards))
