"""Fr tables built on the device: powers of one element by a prefix-product
ladder of kernel 1, and gathers from them.

The 4-step NTT's scale tables (runtime/torch_stages.py for a fleet worker's
stage panels, parallel/ntt_mesh.py for the mesh) are all entries of one
table of powers of w, w^-1, g or g^-1: gathering them from that table on
the device costs log2(n) full-width products, where a table of n entries
built from host ints costs n Python multiplications and a transfer.
"""

import torch

from . import field_torch as F
from . import limbs
from .field_torch import FR


def powers(base, n, device):
    """(8, n) Montgomery words of base^0 .. base^(n-1), on the device."""
    one = F.one_like(FR, torch.empty((FR.n_words, 1), dtype=torch.int32,
                                     device=device))
    b = limbs.lift_scalar(base, device)
    return F.cumprod(FR, torch.cat([one, b.expand(FR.n_words, n - 1)],
                                   dim=1))


def gather(table, index):
    """table[:, index] for an int64 index of any shape -> (8, *shape)
    words."""
    return table[:, index.reshape(-1)].reshape(
        (table.shape[0],) + tuple(index.shape))
