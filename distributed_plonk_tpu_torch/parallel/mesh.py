"""Device meshes: the port of the JAX package's parallel/mesh.py.

Where the reference enumerates worker socket addresses (its
config/network.json), a mesh enumerates the devices of one shard axis.
The JAX package builds a jax.sharding.Mesh and lets XLA place each shard;
here a `Mesh` is a plain tuple of torch devices, one per shard this
process holds. A device may appear more than once: four shards on one
card run the 4-way sharded code with every kernel on that card, as the
JAX tests run an 8-device mesh on virtual CPU devices.

One process drives a mesh (single controller) unless init_multihost has
joined a torch.distributed group first (multi-controller, the counterpart
of jax.distributed): make_mesh then builds the group's global mesh, every
process runs the same program on the shards it holds, and the cross-shard
steps run as collectives (parallel/transport.py).

The JAX module's `pallas_guard` has no counterpart: the port has no SPMD
partitioner for a kernel to break, each shard's kernels run on that
shard's own tensors.
"""

import datetime
import socket

import torch
import torch.distributed as dist

from ..backend import field_torch as F
from .transport import Transport

# seconds a rendezvous or a collective may wait for the other ranks before
# it raises
DEFAULT_TIMEOUT_S = 300


class Mesh:
    """A 1-D mesh of `size` shards; this process holds shards
    [first, first + len(devices)), shard first + i on devices[i]. The lead
    device (devices[0]) holds what is not sharded: handles too short to
    shard, a sharded handle's lanes past its blocks, the MSM's folded
    bucket planes (parallel/sharded.py, mesh_backend.py).

    transport None: one process holds every shard and no collective runs.
    Otherwise the mesh spans transport.world processes, each holding as
    many shards, and rank q holds shards [q k, (q + 1) k)."""

    def __init__(self, devices, transport=None):
        devs = tuple(F.device_of(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError("a mesh's devices must be of one type: %s"
                             % (devs,))
        self.devices = devs
        self.transport = transport
        self.rank = 0 if transport is None else transport.rank
        self.world = 1 if transport is None else transport.world
        self.first = self.rank * len(devs)
        self.size = self.world * len(devs)

    @property
    def lead(self):
        return self.devices[0]

    def shards(self):
        """(global shard index, device) of each shard this process holds."""
        return [(self.first + i, d) for i, d in enumerate(self.devices)]

    def __repr__(self):
        if self.transport is None:
            return "Mesh(%s)" % ", ".join(str(d) for d in self.devices)
        return "Mesh(rank %d of %d, shards %d-%d of %d on %s, %s)" % (
            self.rank, self.world, self.first,
            self.first + len(self.devices) - 1, self.size,
            ", ".join(str(d) for d in self.devices), self.transport.backend)


class _Group:
    """What init_multihost joined: the transport and this process's
    devices."""

    def __init__(self, transport, devices, device_count):
        self.transport = transport
        self.devices = devices
        self.device_count = device_count


_joined = None      # the _Group of init_multihost, until shutdown_multihost


def _local_devices(local_device_ids, device):
    """This process's devices: CUDA cards by index, or CPU shard slots."""
    dev = F.resolve_device(device, "init_multihost")
    if dev.type == "cpu":
        count = 1 if local_device_ids is None else len(list(local_device_ids))
        return [dev] * count
    visible = torch.cuda.device_count()
    ids = range(visible) if local_device_ids is None \
        else list(local_device_ids)
    for i in ids:
        if not 0 <= i < visible:
            raise ValueError("init_multihost: no card %r (%d visible)"
                             % (i, visible))
    return [torch.device("cuda", i) for i in ids]


def init_multihost(coordinator, num_processes, process_id,
                   local_device_ids=None, device=None, backend=None,
                   timeout_s=DEFAULT_TIMEOUT_S):
    """Join a multi-process mesh group: after this, make_mesh() builds the
    global mesh over every process's devices, and the mesh NTT, MSM and
    MeshBackend run as one program in every process, the cross-shard steps
    as collectives.

    The multi-controller replacement for the reference's dispatcher ->
    worker star + worker <-> worker peer mesh (reference
    config/network.json, src/worker.rs:441-536), as jax.distributed is in
    the JAX package.

    coordinator: "host:port" of process 0 (its TCP rendezvous).
    local_device_ids: the CUDA indices this process drives (None: every
    visible card); with device="cpu", the CPU shard slots it contributes
    (None: one). backend: "nccl" (the default for cards) or "gloo" (the
    default for the CPU; cards too, through host buffers); a backend that
    cannot form raises. Two ranks that drive one card under NCCL raise
    here. timeout_s bounds the rendezvous and every collective.

    Returns (process count, global device count)."""
    global _joined
    if not isinstance(num_processes, int) or num_processes < 1:
        raise ValueError("init_multihost: num_processes must be a positive "
                         "int, got %r" % (num_processes,))
    if not isinstance(process_id, int) or \
            not 0 <= process_id < num_processes:
        raise ValueError("init_multihost: process_id %r outside [0, %d)"
                         % (process_id, num_processes))
    host, _, port = str(coordinator).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError("init_multihost: coordinator must be host:port, "
                         "got %r" % (coordinator,))
    if _joined is not None:
        raise RuntimeError("init_multihost: this process already joined a "
                           "group (shutdown_multihost first)")
    devices = _local_devices(local_device_ids, device)
    if not devices:
        raise ValueError("init_multihost: no local device")
    kind = devices[0].type
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError("init_multihost: unsupported backend %r"
                         % (backend,))
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("init_multihost: NCCL needs CUDA devices")
        if not dist.is_nccl_available():
            raise RuntimeError("init_multihost: this torch has no NCCL")
        torch.cuda.set_device(devices[0])
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    try:
        # the ranks' devices, exchanged over gloo before any NCCL call, so
        # a duplicate card raises here and not in NCCL's own set-up
        control = dist.new_group(backend="gloo", timeout=timeout) \
            if backend == "nccl" else dist.group.WORLD
        mine = {"host": socket.gethostname(), "kind": kind,
                "slots": len(devices),
                "cards": [str(torch.cuda.get_device_properties(d).uuid)
                          for d in dict.fromkeys(devices)]
                if kind == "cuda" else []}
        ranks = [None] * num_processes
        dist.all_gather_object(ranks, mine, group=control)
        kinds = {r["kind"] for r in ranks}
        if len(kinds) != 1:
            raise RuntimeError("init_multihost: ranks drive different "
                               "device types %s" % sorted(kinds))
        if backend == "nccl":
            owner = {}
            for q, r in enumerate(ranks):
                for card in r["cards"]:
                    p = owner.setdefault((r["host"], card), q)
                    if p != q:
                        raise RuntimeError(
                            "init_multihost: ranks %d and %d both drive "
                            "card %s on %s; NCCL needs one card per rank "
                            "(ranks that share a card need backend='gloo')"
                            % (p, q, card, r["host"]))
    except BaseException:
        dist.destroy_process_group()
        raise
    _joined = _Group(Transport(dist.group.WORLD, backend), devices,
                     sum(r["slots"] for r in ranks))
    return num_processes, _joined.device_count


def shutdown_multihost():
    """Leave the group init_multihost joined (destroy_process_group); a
    no-op where none was joined."""
    global _joined
    if _joined is None:
        return
    _joined = None
    dist.destroy_process_group()


def make_submesh(devices):
    """1-D one-process mesh over an explicit device list (the placement
    scheduler's construction hook in the JAX package)."""
    return Mesh(list(devices))


def _global_mesh(group, n_shards, device):
    """The global mesh over a joined group (see make_mesh)."""
    world = group.transport.world
    count = group.device_count if n_shards is None else n_shards
    if count < world or count % world:
        raise ValueError("make_mesh: %d shards do not divide over %d "
                         "processes" % (count, world))
    local = group.devices
    if device is not None:
        dev = F.resolve_device(device, "make_mesh")
        if dev not in local:
            raise ValueError("make_mesh: %s is not among this process's "
                             "devices %s" % (dev, local))
        local = [dev]
    k = count // world
    return Mesh([local[i % len(local)] for i in range(k)], group.transport)


def make_mesh(n_shards=None, device=None):
    """1-D mesh of n_shards shards.

    After init_multihost: the group's global mesh, n_shards (None: the
    group's device count) divisible by the process count; each process's
    k = n_shards / processes shards dealt round robin over its devices
    (device: one of them, to put its k shards there).

    Otherwise one process holds every shard. device None: the visible CUDA
    cards, dealt round robin (n_shards None: one shard per card); raises
    without a card. device "cuda:k" or "cpu": every shard on that one
    device (n_shards None: one shard)."""
    if _joined is not None:
        return _global_mesh(_joined, n_shards, device)
    if device is None:
        F.resolve_device(None, "make_mesh")
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        count = len(cards) if n_shards is None else n_shards
        return Mesh([cards[s % len(cards)] for s in range(count)])
    dev = F.resolve_device(device, "make_mesh")
    return Mesh([dev] * (1 if n_shards is None else n_shards))
