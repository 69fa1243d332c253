"""Sharded poly handles: the port of the JAX MeshBackend's placement
(JAX parallel/mesh_backend.py:77-104: `_MIN_LOCAL`, `_sharding1`,
`_lift_arr`, `_lift_tab`).

The JAX package lays a (16, L) handle out P(None, "shards") once each of
the D devices would hold at least _MIN_LOCAL coefficients, and keeps it
so across rounds. Here a `Sharded` handle holds, for each shard this
process holds, an (8, b) int32 Montgomery word tensor on that shard's
device, b = L // D: shard s holds lanes [s b, (s+1) b). The L - D b < D
lanes past the last block (the tail) are an (8, L - D b) tensor on the
lead device, the same in every process. The prover's blinded wire
polynomials (n + 2 lanes), its permutation polynomial (n + 3), the split
quotient pieces and the openings (n + 2) divide by no shard count above
2; with the tail they keep the blocks of their n-lane sources, so the
blinding, the split, the linear combination and the division run on the
shards, and no handle is gathered between rounds.

The rule (`block_of`): an L-lane handle shards when L // D >= min_local
(MeshBackend's constructor argument, the JAX `_MIN_LOCAL` = 1024 by
default); otherwise it is a plain (8, L) tensor on the lead device,
replicated in every process.

  shard(mesh, h, block)        whole -> Sharded (copies: the whole tensor
                               can be freed);
  gather(h)                    Sharded -> whole on the lead (one
                               all_gather across processes): for host
                               reads and checkpoints;
  take_many / take             a relayout: lanes [off, off + length) of
                               each handle (zero past its end, or read
                               modulo its length), laid out with a new
                               block; across processes one all_to_all
                               carries only the lanes that cross ranks;
  collect(mesh, values)        one small value per shard -> all D of
                               them, in shard order (the carries of
                               scans and sums across shards);
  dump_h / load_h              checkpoints: the whole handle's bytes.
"""

import torch

from ..backend import field_torch as F
from ..backend import limbs
from ..backend.field_torch import FR

WORDS = FR.n_words


def block_of(length, size, min_local):
    """The block of an L-lane handle over `size` shards, or None where it
    stays whole: L // size lanes a shard once that is at least min_local
    (and at least 1)."""
    b = length // size
    return b if b >= max(min_local, 1) else None


class Sharded:
    """An (8, length) poly handle kept in lane shards (module docstring).
    pieces: one (8, block) word tensor per shard this process holds, in
    mesh.shards() order, each on its shard's device; tail: the (8, length
    - size * block) lanes past the blocks, on the lead. Immutable: every
    operation makes new tensors, and handles may share pieces."""

    __slots__ = ("mesh", "length", "block", "pieces", "tail")

    def __init__(self, mesh, length, block, pieces, tail):
        if len(pieces) != len(mesh.devices):
            raise ValueError("Sharded: %d pieces for %d held shards"
                             % (len(pieces), len(mesh.devices)))
        if tail.shape[-1] != length - mesh.size * block:
            raise ValueError("Sharded: a tail of %d lanes for length %d, "
                             "block %d over %d shards" % (
                                 tail.shape[-1], length, block, mesh.size))
        self.mesh = mesh
        self.length = length
        self.block = block
        self.pieces = list(pieces)
        self.tail = tail

    @property
    def shape(self):
        return (WORDS, self.length)

    def shard_bytes(self):
        """{global shard: bytes of its piece held here}; the tail counts
        under the lead's shard (the first held)."""
        out = {}
        for (s, _), p in zip(self.mesh.shards(), self.pieces):
            out[s] = p.numel() * p.element_size()
        out[self.mesh.first] += self.tail.numel() * self.tail.element_size()
        return out

    def __repr__(self):
        return "Sharded(length %d, block %d, tail %d, shards %s)" % (
            self.length, self.block, self.tail.shape[-1],
            [s for s, _ in self.mesh.shards()])


def _own(t, dev):
    """A fresh contiguous copy of t on dev: a view would keep its whole
    source alive."""
    out = torch.empty(t.shape, dtype=t.dtype, device=dev)
    out.copy_(t)
    return out


def shard(mesh, h, block):
    """A whole (8, L) tensor on the lead (the same in every process) ->
    the Sharded handle with `block`, each held shard's lanes copied to its
    device; block None: h itself."""
    if block is None:
        return h
    d = mesh.size
    pieces = [_own(h[:, s * block:(s + 1) * block], dev)
              for s, dev in mesh.shards()]
    return Sharded(mesh, h.shape[1], block, pieces,
                   _own(h[:, d * block:], mesh.lead))


def gather(h):
    """The whole (8, L) tensor of a handle on the lead device (in every
    process: one all_gather across processes); a whole handle itself."""
    if not isinstance(h, Sharded):
        return h
    mesh = h.mesh
    lead = mesh.lead
    if mesh.transport is None:
        parts = [p.to(lead) for p in h.pieces]
    else:
        got = mesh.transport.all_gather(torch.stack(
            [p.to(lead) for p in h.pieces]))        # (W, k, 8, block)
        parts = list(got.reshape(-1, WORDS, h.block).unbind(0))
    return torch.cat(parts + [h.tail], dim=1)


def collect(mesh, values):
    """One equal-shape tensor per shard held here (mesh.shards() order) ->
    the list of all mesh.size of them in global shard order, on the lead
    (one all_gather across processes)."""
    lead = mesh.lead
    if mesh.transport is None:
        return [v.to(lead) for v in values]
    got = mesh.transport.all_gather(torch.stack([v.to(lead)
                                                 for v in values]))
    return list(got.reshape((mesh.size,) + tuple(values[0].shape))
                .unbind(0))


def _sources(h):
    """Every segment of h's lanes, held here or not: (shard or None, lo,
    hi); None marks lanes every process holds (a whole handle, or the
    tail)."""
    if not isinstance(h, Sharded):
        return [(None, 0, h.shape[-1])]
    b, d = h.block, h.mesh.size
    return [(s, s * b, (s + 1) * b) for s in range(d)] + \
        [(None, d * b, h.length)]


def _source_tensor(h, s):
    """The tensor holding segment s of h in this process."""
    if not isinstance(h, Sharded):
        return h
    if s is None:
        return h.tail
    return h.pieces[s - h.mesh.first]


def _overlaps(hs, off, length, block, d, wrap):
    """Every copy of a relayout, in every process alike: (handle index,
    source shard or None, source lane, destination shard or None (the
    tail), destination lane, count), lanes relative to their segment."""
    dsts = [(t, off + t * block, off + (t + 1) * block) for t in range(d)]
    dsts.append((None, off + d * block, off + length))
    out = []
    for i, h in enumerate(hs):
        L = h.shape[-1]
        shifts = (0, L) if wrap else (0,)
        for t, d_lo, d_hi in dsts:
            for s, lo, hi in _sources(h):
                for shift in shifts:
                    a, b = max(d_lo, lo + shift), min(d_hi, hi + shift)
                    if a < b:
                        out.append((i, s, a - shift - lo, t, a - d_lo,
                                    b - a))
    return out


def take_many(mesh, hs, off, length, block, width=None, wrap=False):
    """Lanes [off, off + length) of each handle of hs (whole or Sharded;
    zero past a handle's end, or read modulo its length with wrap), laid
    out with `block` and stacked on axis 1: (pieces, tail), one (8, B,
    width) tensor per shard held here (lanes [0, block) the shard's,
    the rest zero; width None: block) and the (8, B, length - D block)
    tail on the lead. In one process every copy is local; across
    processes, one all_to_all carries the lanes whose source shard and
    destination lie in different processes (every process needs the
    tail), in slots of the longest such run."""
    d, k, first = mesh.size, len(mesh.devices), mesh.first
    width = block if width is None else width
    B = len(hs)
    held = mesh.shards()
    lead = mesh.lead
    pieces = [torch.zeros((WORDS, B, width), dtype=torch.int32, device=dev)
              for _, dev in held]
    tail = torch.zeros((WORDS, B, length - d * block), dtype=torch.int32,
                       device=lead)
    ovs = _overlaps(hs, off, length, block, d, wrap)

    def here(s):
        return s is None or first <= s < first + k

    def dst_tensor(t):
        return tail if t is None else pieces[t - first]

    remote = []
    for ov in ovs:
        i, s, s_lo, t, t_lo, cnt = ov
        if not here(t):
            continue
        if here(s):
            src = _source_tensor(hs[i], s)
            dst_tensor(t)[:, i, t_lo:t_lo + cnt].copy_(
                src[:, s_lo:s_lo + cnt])
        else:
            remote.append(ov)
    if mesh.transport is None:
        return pieces, tail
    # the runs that cross processes: shard s -> shard t of another
    # process, or shard s -> the tail (every other process); the same
    # list, and so the same slot, in every process
    rank = mesh.rank
    cross = [ov for ov in ovs if ov[1] is not None and (
        ov[3] is None or ov[1] // k != ov[3] // k)]
    slot = max((ov[5] for ov in cross), default=0)
    if not slot:
        return pieces, tail
    w = mesh.world
    send = torch.zeros((w, k, k + 1, B, WORDS, slot), dtype=torch.int32,
                       device=lead)
    for i, s, s_lo, t, _, cnt in cross:
        if not first <= s < first + k:
            continue
        run = hs[i].pieces[s - first][:, s_lo:s_lo + cnt]
        if t is None:
            for q in range(w):
                if q != rank:
                    send[q, s - first, k, i, :, :cnt].copy_(run)
        else:
            send[t // k, s - first, t % k, i, :, :cnt].copy_(run)
    recv = mesh.transport.all_to_all(send)
    for i, s, s_lo, t, t_lo, cnt in remote:
        j = k if t is None else t - first
        dst_tensor(t)[:, i, t_lo:t_lo + cnt].copy_(
            recv[s // k, s % k, j, i, :, :cnt])
    return pieces, tail


def take(mesh, h, off, length, block, wrap=False):
    """One handle's lanes [off, off + length) laid out with `block` (None:
    whole, on the lead) -> a new handle. A Sharded h of that block read
    from lane 0 shares its pieces (only the tail is cut or padded)."""
    if block is None:
        return _lanes(gather(h), off, length, wrap)
    if isinstance(h, Sharded) and h.block == block and not off and \
            not wrap:
        tail = _lanes(h.tail, 0, length - mesh.size * block, False)
        return Sharded(mesh, length, block, h.pieces, tail)
    pieces, tail = take_many(mesh, [h], off, length, block, wrap=wrap)
    return Sharded(mesh, length, block, [p[:, 0] for p in pieces],
                   tail[:, 0])


def _lanes(t, off, length, wrap):
    """Lanes [off, off + length) of a whole (8, L) tensor: zero past its
    end, or modulo L with wrap."""
    L = t.shape[-1]
    if wrap and L:
        idx = torch.arange(off, off + length, device=t.device) % L
        return t.index_select(1, idx)
    part = t[:, min(off, L):min(off + length, L)]
    return F.pad_words(part, length) if part.shape[1] < length \
        else part.contiguous()


def dump_h(h):
    """Canonical (16, L) uint32 16-bit limbs of a handle (host numpy),
    exactly what TorchBackend.dump_h writes for the whole tensor."""
    return limbs.to_jax_limbs(F.from_mont(FR, gather(h)))


def load_h(mesh, arr, block):
    """dump_h's limbs -> a handle laid out with `block`."""
    return shard(mesh, F.to_mont(FR, limbs.from_jax_limbs(arr, mesh.lead)),
                 block)
