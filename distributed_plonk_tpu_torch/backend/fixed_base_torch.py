"""Fixed-base batch scalar multiplication on the card: the SRS generator
(the port of backend/fixed_base.py).

The reference gets its SRS from jf-plonk's `universal_setup` (reference
src/dispatcher2.rs:1279), a serial walk [tau^0]G, [tau^1]G, ... on the
host: at the reference's v2 size (2^18 + 3 powers) that is the set-up's
scale blocker. Here a windowed table of the one public base is built once
on the host (32 windows x 256 multiples d * 2^(8w) * G, normalized to
affine with one batch inversion), and [s_i]G for all N scalars is a walk
of 32 steps over the batch: each step gathers every lane's table row for
its 8-bit digit and makes ONE complete projective mixed add (RCB15,
kernel 4 on the card) from the identity, with the table's infinity flag
(digit 0) as q_inf. The steps run in the JAX walk's `lax.scan` order and
the result converts to Jacobian (XZ, YZ^2, Z) through kernel 1, so the
coordinates equal the JAX package's limb for limb (`limbs.from_jax_limbs`
maps them).

The digits are computed on the host with numpy (msm_jax.digits_of_scalars
at c = 8: the little-endian bytes of each canonical scalar). The walk
itself is plain torch around the two kernels, as the JAX package's is XLA
around its Pallas add.
"""

import functools

import numpy as np
import torch

from ..constants import FQ_WORDS, Q_MOD, R_MOD
from .. import curve as C
from . import curve_torch as CT
from . import field_torch as F
from .field_torch import FQ
from .msm_torch import points_to_device

WINDOW_BITS = 8
N_WINDOWS = 256 // WINDOW_BITS      # 32
N_BUCKETS = 1 << WINDOW_BITS        # 256


@functools.lru_cache(maxsize=4)
def _host_window_table(base_affine):
    """(N_WINDOWS, N_BUCKETS) table of d * 2^(8w) * base as host AFFINE
    tuples (None at index 0); one batched inversion normalizes the whole
    Jacobian walk. Cached per base: it is the same for every device."""
    inf = (1, 1, 0)
    table = []
    b = C.g1_to_jac(base_affine)
    for _ in range(N_WINDOWS):
        row = [inf]
        acc = inf
        for _ in range(N_BUCKETS - 1):
            acc = C.g1_jac_add(acc, b)
            row.append(acc)
        table.append(row)
        for _ in range(WINDOW_BITS):
            b = C.g1_jac_double(b)
    # batch-invert all Z coordinates (Montgomery's trick, host ints)
    flat = [p for row in table for p in row]
    zs = [p[2] if p[2] else 1 for p in flat]
    prefix = [1]
    for z in zs:
        prefix.append(prefix[-1] * z % Q_MOD)
    inv_total = pow(prefix[-1], Q_MOD - 2, Q_MOD)
    invs = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        invs[i] = prefix[i] * inv_total % Q_MOD
        inv_total = inv_total * zs[i] % Q_MOD
    out = []
    for p, zi in zip(flat, invs):
        if p[2] == 0:
            out.append(None)
        else:
            zi2 = zi * zi % Q_MOD
            out.append((p[0] * zi2 % Q_MOD, p[1] * zi2 * zi % Q_MOD))
    return tuple(tuple(out[w * N_BUCKETS:(w + 1) * N_BUCKETS])
                 for w in range(N_WINDOWS))


def digits_of_scalars(scalars):
    """Host int scalars -> (N_WINDOWS, N) uint8 numpy radix-256 digits of
    the canonical scalars, window w = byte w (little-endian)."""
    buf = b"".join((s % R_MOD).to_bytes(32, "little") for s in scalars)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(scalars), 32).T


def walk(table, digits):
    """The batch walk: table ((12, W, B) x, (12, W, B) y, (W, B) inf) and
    (W, N) int64 digits on one device -> ((12, N),)*3 Jacobian Montgomery
    (X*Z, Y*Z^2, Z) of the projective sum over the windows."""
    tx, ty, tinf = table
    acc = CT.proj_inf((digits.shape[1],), digits.device)
    for w in range(digits.shape[0]):
        dg = digits[w]
        acc = CT.proj_add_mixed(acc, (tx[:, w, dg], ty[:, w, dg]),
                                tinf[w, dg])
    X, Y, Z = acc
    # projective (X : Y : Z) == Jacobian (X*Z, Y*Z^2, Z)
    xz = F.mont_mul(FQ, X, Z)
    z2 = F.mont_mul(FQ, Z, Z)
    yz2 = F.mont_mul(FQ, Y, z2)
    return xz, yz2, Z


class FixedBaseContext:
    """Device-resident windowed table for one base point; reusable across
    batches (device None: the card)."""

    # lanes per walk: the walk holds about 1 KB a lane on the card (the
    # accumulator, the gathered rows and the add's output), so the 2^18 + 3
    # powers of the reference's v2 SRS fit one chunk
    CHUNK = 1 << 19

    def __init__(self, base_affine, device=None):
        self.device = F.resolve_device(device, "FixedBaseContext")
        flat = [p for row in _host_window_table(tuple(base_affine))
                for p in row]
        x, y, inf = points_to_device(flat, 0, self.device)
        self.table = (x.reshape(FQ_WORDS, N_WINDOWS, N_BUCKETS),
                      y.reshape(FQ_WORDS, N_WINDOWS, N_BUCKETS),
                      inf.reshape(N_WINDOWS, N_BUCKETS))

    def batch_mul(self, scalars):
        """[s_i]base for host int scalars -> ((12, N),)*3 device Jacobian
        Montgomery words."""
        digits = digits_of_scalars(scalars)
        parts = []
        for i0 in range(0, len(scalars), self.CHUNK):
            dg = torch.from_numpy(np.ascontiguousarray(
                digits[:, i0:i0 + self.CHUNK])).to(self.device).long()
            parts.append(walk(self.table, dg))
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat([p[i] for p in parts], dim=1)
                     for i in range(3))


_G1_CTXS = {}


def g1_batch_mul(scalars, device=None):
    """[s_i]G1 on a device (None: the card), with the G1 context cached per
    device."""
    device = F.resolve_device(device, "g1_batch_mul")
    ctx = _G1_CTXS.get(device)
    if ctx is None:
        ctx = _G1_CTXS[device] = FixedBaseContext(C.G1_GEN, device)
    return ctx.batch_mul(scalars)
