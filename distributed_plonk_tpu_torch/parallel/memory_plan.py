"""Per-device and per-process memory plan of the mesh NTT, MSM and round
3: the port of the JAX package's parallel/memory_plan.py, re-based on the
port's layout.

The reference's v2 workload pushes the quotient domain to 2^21 (reference
src/dispatcher2.rs:246) and shards it over workers whose footprint is
O(N/P) rows + O(N/P) columns (reference src/worker.rs:223-227). These
functions give the same budget for the port's mesh, from shapes alone,
so a configuration can be checked before it allocates.

Layout (ntt_mesh.MeshNttPlan): N = r*c, rows sharded over the mesh;
every Fr element is (8,) int32 words, 32 B. Kernel 1 works in registers
and allocates nothing beyond its output, so no product transient is
budgeted (the JAX plan budgets XLA's un-fused f32 byte-product tensor).
The round math runs on the lead device (mesh_backend), so round 3's
planes are resident there, not sharded.
"""

from ..backend.msm_torch import window_of
from .ntt_mesh import _split_rc

FR_BYTES = 8 * 4    # (8,) int32 words per Fr element
FQ_BYTES = 12 * 4   # (12,) per Fq coordinate


def _local_shards(n_shards, n_processes):
    if n_shards % n_processes:
        raise ValueError("%d shards do not divide over %d processes"
                         % (n_shards, n_processes))
    return n_shards // n_processes


def ntt_mesh_plan(n, n_shards, batch=1, n_processes=1):
    """Byte budget per shard of a batch-B mesh NTT of size n.

    data: the shard's (8, B, c/D, r) block of A (and, after the all-to-all,
    its (8, B, r/D, c) block of B: the same size); tables: mid twiddles and
    a coset pre- or post-scale, (8, c/D, r) or (8, r/D, c) each; total: the
    block, its kernel output and the all-to-all's receive buffer, beside
    the tables. per_process: the shards one of n_processes processes holds
    (local_shards) times total."""
    r, c = _split_rc(n)
    local = n // n_shards
    data = FR_BYTES * batch * local
    tables = 2 * FR_BYTES * local
    held = _local_shards(n_shards, n_processes)
    return {"r": r, "c": c, "local_elems": local, "data": data,
            "tables": tables, "total": 3 * data + tables,
            "local_shards": held, "per_process": held * (3 * data + tables)}


def round3_mesh_plan(n, m, n_shards, n_processes=1):
    """Round 3's one-shot quotient: bytes resident on the lead device (the
    25 coset planes, the stacked selector, sigma and wire copies of the
    quotient evaluation, 3 domain tables and the n-scale state: pk
    polynomials, wire polynomials; every process of a multi-process mesh
    holds them on its lead), per shard (the NTT of one batch of
    TorchBackend.NTT_BATCH planes, from ntt_mesh_plan) and per process
    (the shards it holds times the per-shard bytes)."""
    planes = 25 * FR_BYTES * m
    stacks = 23 * FR_BYTES * m
    tables = 3 * FR_BYTES * m
    base = 28 * FR_BYTES * n
    ntt = ntt_mesh_plan(m, n_shards, batch=25, n_processes=n_processes)
    return {"planes": planes, "stacks": stacks, "tables": tables,
            "base": base, "lead": planes + stacks + tables + base,
            "shard": ntt["total"], "per_process": ntt["per_process"]}


def msm_mesh_plan(n, n_shards, batch=1, n_processes=1):
    """Byte budget per shard of a batch-B mesh MSM over an n-point key:
    the window-shifted key (W copies of the range, 96 B a point), op words
    and sort keys (4 B each per handle, window and point), the sort's
    order and the chunk partials, and the bucket planes ((12, B, buckets)
    projective, folded on the lead); per_process: the shards one of
    n_processes processes holds times the per-shard total."""
    local = -(-n // (16 * n_shards)) * 16
    _, c, windows, buckets = window_of(local)
    key = windows * local * 2 * FQ_BYTES
    entries = batch * windows * local
    digits = 2 * 4 * entries
    sort = 4 * entries + 8 * entries       # sorted keys, int64 order
    partials = 36 * 4 * (entries // 32 + batch * buckets)
    planes = 3 * FQ_BYTES * batch * buckets
    total = key + digits + sort + partials + planes
    held = _local_shards(n_shards, n_processes)
    return {"local_points": local, "c": c, "windows": windows, "key": key,
            "digits": digits, "sort": sort, "partials": partials,
            "planes": planes, "total": total, "local_shards": held,
            "per_process": held * total}
