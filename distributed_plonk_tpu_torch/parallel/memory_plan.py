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
MeshBackend keeps every handle of at least D x min_local lanes in lane
shards and runs the round math shard by shard (parallel/sharded.py), so
each device holds its shards' part of round 3's planes and tables, not
the whole of them.
"""

from ..backend.msm_torch import window_of
from .msm_mesh import key_block
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
    """Round 3's one-shot quotient per shard, every handle sharded: the
    shard's lanes of the 25 coset planes (planes), of the plane copies
    and temporaries of the quotient evaluation (stacks: 23 planes' worth,
    what a stacked evaluation copies; the mesh reads a few planes at a
    time), of the 3 domain tables (tables) and of the n-lane state, pk
    and wire polynomials (base); resident: the four
    together, what a shard holds while the quotient evaluates; ntt: the
    mesh NTT of one batch of the 25 planes (ntt_mesh_plan's per-shard
    total); shard: base beside the larger of the NTT's working set and
    the resident planes, stacks and tables, the shard's peak; per_process:
    the shards one of n_processes processes holds times shard."""
    d = n_shards
    planes = 25 * FR_BYTES * m // d
    stacks = 23 * FR_BYTES * m // d
    tables = 3 * FR_BYTES * m // d
    base = 28 * FR_BYTES * n // d
    ntt = ntt_mesh_plan(m, d, batch=25, n_processes=n_processes)
    shard = base + max(ntt["total"], planes + stacks + tables)
    return {"planes": planes, "stacks": stacks, "tables": tables,
            "base": base, "resident": planes + stacks + tables + base,
            "ntt": ntt["total"], "shard": shard,
            "local_shards": ntt["local_shards"],
            "per_process": ntt["local_shards"] * shard}


def msm_mesh_plan(n, n_shards, batch=1, n_processes=1):
    """Byte budget per shard of a batch-B mesh MSM over an n-point key,
    split as MeshMsmContext splits it (a block of key_block(n, D) points
    and an equal share of the rest a shard): the window-shifted key (W
    copies of the range, 96 B a
    point), op words and sort keys (4 B each per handle, window and
    point), the sort's order and the chunk partials, and the bucket
    planes ((12, B, buckets) projective, folded on the lead);
    per_process: the shards one of n_processes processes holds times the
    per-shard total."""
    b = key_block(n, n_shards)
    local = b + -(-(n - n_shards * b) // n_shards)
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
