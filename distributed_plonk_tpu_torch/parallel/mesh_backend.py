"""MeshBackend: the 5-round prover over a mesh, the port of the JAX
package's parallel/mesh_backend.py.

The mesh counterpart of the reference's fully-distributed v2 prover
(reference src/dispatcher2.rs:192-713), which drives per-FFT and per-MSM
fan-outs to workers (dispatcher2.rs:731-787, 834-893). As in the JAX
package (its mesh_backend.py:1-36), the prover state lives SHARDED on
the mesh for all five rounds, resident across rounds instead of
re-scattered per call:

  - a handle of L lanes is a `sharded.Sharded` once each shard would hold
    L // D >= min_local lanes (the JAX `_MIN_LOCAL`, 1024 by default; a
    constructor argument): shard s holds lanes [s b, (s+1) b) on its own
    device, b = L // D, and the < D lanes past the blocks ride beside
    them on the lead. Shorter handles are whole (8, L) tensors on the
    lead, replicated in every process (parallel/sharded.py);
  - NTTs run as the 4-step mesh NTT (ntt_mesh.MeshNttPlan), lane blocks
    in and lane blocks out: each shard's rows on kernels 1 and 2, three
    tile exchanges between them, no whole tensor on the lead;
  - commitments run as the range-sharded MSM (msm_mesh.MeshMsmContext):
    each handle's piece feeds its shard's kernel 3, the bucket planes
    fold on the lead with kernel 4;
  - the round math (the JAX `_no_pallas` list) runs on each shard's own
    lanes and device with the same prover_torch functions (kernel 1 for
    every product); consecutive shards on one device run as one lane
    range (a run: four shards of one card take one call, not four).
    Elementwise: `lin_comb_h`, `quotient` (over the coset planes the
    mesh NTT returns sharded, each plane's run read when the evaluation
    reads it, and quotient-domain tables built for each run's lanes on
    its device, the JAX `_domain_tables`). Across shard boundaries, with
    one small carry each (a loop over the runs, and one all-gather of a
    word per shard across processes): `perm_product` (each run's prefix
    products, then an exclusive scan of the shard totals), `synth_div_h`
    (the suffix sums carried from each run to the one before, times
    powers of the point),
    `eval_h` / `eval_many_h` / `eval_many_async` (each shard's partial
    sum times z^(s b), summed in shard order), `degree_is` (the shard
    holding the index decides, the others' higher lanes are zero),
    `blind` (only the lanes [0, d) and [n, n + d) change) and `split`
    (each piece relaid to its own blocks, one all-to-all of the lanes
    that cross processes).

Host values are read from a whole handle: commitments and evaluations
return host points and ints, the same in every process; `lower`,
`dump_h` (checkpoints, the whole tensor's bytes) and `run_ints` gather.
Nothing else is gathered.

Domains too small to shard (r or c of the 4-step split not divisible by
the shard count) use TorchBackend's single-device NTT on the lead
device, as the JAX backend does. Counters say which path took every
call: `mesh_ntt_calls` and `replicated_ntt_calls` count transformed
polynomials by domain size, `mesh_msm_calls` committed handles, and
`sharded_handles` / `replicated_handles` every handle the backend made,
by length; a mesh that fell back everywhere would still prove the same
bytes, so a run reads them.

The mesh shards; it does not stream: `quotient_poly_streamed` and
`quotient_streamed` are None (as the JAX MeshBackend sets them), so round
3 runs one-shot (25 coset planes, each NTT on the mesh) and no fold
slices a sharded plane.

On a multi-process mesh (parallel/mesh.init_multihost) every process
constructs a MeshBackend and runs the same preprocess and prove with the
same rng: each computes its own shards, the exchanges and carries run as
collectives, and every process ends with the same proof bytes and the
same counters. Every process must issue the same collectives in the
same order from one thread, so `issues_collectives` tells the round
pipeline (prover.PipelinedProver), whose executor thread enqueues
launches, to refuse the backend; `prove` and `prove_many` drive it.
"""

import collections

import torch

from ..constants import FR_GENERATOR, FR_WORDS, R_MOD
from ..circuit import NUM_WIRE_TYPES
from ..backend import field_torch as F
from ..backend import limbs
from ..backend import prover_torch as PT
from ..backend.autotune import cache_key
from ..backend.field_torch import FR
from ..backend.torch_backend import TorchBackend, _DevicePending
from .msm_mesh import MeshMsmContext
from .ntt_mesh import MeshNttPlan, divides
from .sharded import (Sharded, block_of, collect, gather, shard, take,
                      take_many)
from . import sharded as S


class MeshBackend(TorchBackend):
    """Backend whose handles are kept in lane shards over a mesh (whole
    (8, L) tensors on the lead below min_local lanes a shard) and whose
    NTTs, commitments and round math run shard by shard."""

    name = "mesh"
    quotient_poly_streamed = None
    quotient_streamed = None
    # lanes a shard must hold for a handle to shard (JAX _MIN_LOCAL)
    MIN_LOCAL = 1024

    def __init__(self, mesh, min_local=MIN_LOCAL):
        super().__init__(device=mesh.lead)
        self.mesh = mesh
        self.min_local = min_local
        self._mesh_plans = {}
        self.mesh_ntt_calls = collections.Counter()
        self.replicated_ntt_calls = collections.Counter()
        self.mesh_msm_calls = 0
        self.sharded_handles = collections.Counter()
        self.replicated_handles = collections.Counter()

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

    # --- placement ------------------------------------------------------------

    def _block(self, length):
        return block_of(length, self.mesh.size, self.min_local)

    def _made(self, h):
        """Count a handle this backend hands out, by length."""
        if isinstance(h, Sharded):
            self.sharded_handles[h.length] += 1
        else:
            self.replicated_handles[h.shape[1]] += 1
        return h

    def _placed(self, h):
        """Whether a handle is in the layout of its length."""
        blk = self._block(h.shape[1])
        return h.block == blk if isinstance(h, Sharded) else blk is None

    def _place(self, h):
        """A handle (whole or Sharded) in the layout of its length."""
        if self._placed(h):
            return h
        blk = self._block(h.shape[1])
        if isinstance(h, Sharded):
            return take(self.mesh, h, 0, h.length, blk)
        return shard(self.mesh, h, blk)

    def _empty_tail(self):
        return torch.empty((FR_WORDS, 0), dtype=torch.int32,
                           device=self.mesh.lead)

    def _words(self, values):
        """Host ints -> a whole (8, k) tensor on the lead (scalars and
        coefficients, never placed)."""
        return TorchBackend.lift(self, values)

    def lift(self, values):
        return self._made(self._place(self._words(values)))

    def lift_many(self, value_lists):
        """B equal-length int lists -> B placed handles, in ONE upload."""
        n = len(value_lists[0])
        assert all(len(v) == n for v in value_lists)
        h = self._words([x for vs in value_lists for x in vs])
        return [self._made(self._place(h[:, i * n:(i + 1) * n]))
                for i in range(len(value_lists))]

    def lower(self, h):
        self.lowers += 1
        return limbs.lower(gather(h))

    def dump_h(self, h):
        self.lowers += 1
        return S.dump_h(h)

    def load_h(self, arr):
        self.lifts += 1
        return self._made(S.load_h(self.mesh, arr, self._block(
            arr.shape[1])))

    def register_pk_polys(self, pk, sel_h, sig_h):
        super().register_pk_polys(pk, [self._place(h) for h in sel_h],
                                  [self._place(h) for h in sig_h])

    def pk_polys(self, pk):
        """The key's 18 handles, placed: a key another backend built on the
        lead device arrives whole and is sharded here once."""
        sel, sig = super().pk_polys(pk)
        if not all(self._placed(h) for h in sel + sig):
            sel = [self._made(self._place(h)) for h in sel]
            sig = [self._made(self._place(h)) for h in sig]
            super().register_pk_polys(pk, sel, sig)
        return sel, sig

    # --- NTTs ----------------------------------------------------------------

    def _ntt_many(self, domain, hs, inverse, coset):
        size = domain.size
        plan = self._plan(size)
        if plan is None:
            self.replicated_ntt_calls[size] += len(hs)
            outs = super()._ntt_many(domain, [gather(h) for h in hs],
                                     inverse, coset)
            return [self._made(self._place(h)) for h in outs]
        blk = self._block(size)
        outs = []
        for i in range(0, len(hs), self.NTT_BATCH):
            batch = hs[i:i + self.NTT_BATCH]
            self.mesh_ntt_calls[size] += len(batch)
            if blk is None:
                res = plan.ntt(torch.stack([self._pad(h, size)
                                            for h in batch], dim=1),
                               inverse, coset)
                outs.extend(self._made(res[:, j])
                            for j in range(res.shape[1]))
                continue
            # every handle's lanes [0, size) as lane blocks, one batch a
            # shard; the output's blocks split into one handle each
            blocks, _ = take_many(self.mesh, batch, 0, size, blk)
            res = plan.ntt(blocks, inverse, coset, sharded=True)
            outs.extend(self._made(Sharded(
                self.mesh, size, blk, [r[:, j] for r in res],
                self._empty_tail()))
                for j in range(len(batch)))
        return outs

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

    # --- round math -----------------------------------------------------------

    def _segments(self, h):
        """(global lo, tensor) of every segment of h held here: each held
        shard's piece, then the tail."""
        d, b = self.mesh.size, h.block
        return [(s * b, p) for (s, _), p in zip(self.mesh.shards(),
                                                h.pieces)] + \
            [(d * b, h.tail)]

    def _runs(self):
        """Maximal runs of consecutive held shards on one device, as
        (device, [piece indices]): a run's pieces are one contiguous lane
        range, so a scan or sum over their concatenation is one over that
        range, in one batch of launches (four shards of one card: one
        run)."""
        runs = []
        for i, (_, dev) in enumerate(self.mesh.shards()):
            if runs and runs[-1][0] == dev:
                runs[-1][1].append(i)
            else:
                runs.append((dev, [i]))
        return runs

    def _run_slots(self, values, at_last):
        """One carry slot per held shard: each run's value in its last
        (at_last) or first shard's slot, `fill` of its kind elsewhere;
        values: [(run value, fill)] in run order."""
        slots = []
        for (_, idx), (v, fill) in zip(self._runs(), values):
            own = len(idx) - 1 if at_last else 0
            slots.extend(v if j == own else fill for j in range(len(idx)))
        return slots

    def _patch(self, h, lo, vals, op):
        """h with lanes [lo, lo + k) replaced by op(those lanes, vals), vals
        a whole (8, k) tensor: only the segments holding them change."""
        hi = lo + vals.shape[1]
        new = []
        for s_lo, t in self._segments(h):
            a, c = max(lo, s_lo), min(hi, s_lo + t.shape[1])
            if a < c:
                t = t.clone()
                t[:, a - s_lo:c - s_lo] = op(t[:, a - s_lo:c - s_lo],
                                             vals[:, a - lo:c - lo].to(
                                                 t.device))
            new.append(t)
        return Sharded(self.mesh, h.length, h.block, new[:-1], new[-1])

    def blind(self, h, blinds, n):
        b = self._words(blinds)
        length = n + b.shape[1]
        blk = self._block(length)
        if blk is None:
            return self._made(PT.add_vanishing_blind(gather(h), b, n))
        # coeffs + blind(X) (X^n - 1): out[i] -= b_i, out[n + i] += b_i
        out = take(self.mesh, h, 0, length, blk)
        out = self._patch(out, 0, b, lambda x, v: F.sub(FR, x, v))
        return self._made(self._patch(out, n, b,
                                      lambda x, v: F.add(FR, x, v)))

    def _lift_circuit_tables(self, circuit):
        """Witness, identity-permutation and sigma-mapped identity values
        as (8, w, lanes) tables per run of held shards (_runs), each lifted
        on its run's device (the JAX `_lift_tab`); whole (8, w, n) on the
        lead where n does not shard."""
        n = len(circuit.wire_variables[0])
        blk = self._block(n)
        w = NUM_WIRE_TYPES
        wires = [circuit.wire_values(i) for i in range(w)]
        ids = [circuit.extended_id_permutation[i] for i in range(w)]
        sig = [[circuit.extended_id_permutation[pi][pj]
                for pi, pj in circuit.wire_permutation[i]]
               for i in range(w)]
        tabs = {"n": n, "block": blk}
        for key, rows in (("wires", wires), ("id", ids), ("sig", sig)):
            if blk is None:
                tabs[key] = self._words(
                    [v for row in rows for v in row]).reshape(FR_WORDS, w, n)
                continue
            assert n == self.mesh.size * blk, (n, blk)
            parts = []
            for dev, idx in self._runs():
                self.lifts += 1
                lo = (self.mesh.first + idx[0]) * blk
                hi = lo + len(idx) * blk
                parts.append(limbs.lift([v for row in rows
                                         for v in row[lo:hi]], dev)
                             .reshape(FR_WORDS, w, hi - lo))
            tabs[key] = parts
        return tabs

    def wire_values(self, circuit):
        tabs = self._circuit_tables(circuit)
        if tabs["block"] is None:
            return [self._made(tabs["wires"][:, i])
                    for i in range(NUM_WIRE_TYPES)]
        blk = tabs["block"]
        return [self._made(Sharded(
            self.mesh, tabs["n"], blk,
            [t[:, i, j * blk:(j + 1) * blk]
             for t, (_, idx) in zip(tabs["wires"], self._runs())
             for j in range(len(idx))], self._empty_tail()))
            for i in range(NUM_WIRE_TYPES)]

    def perm_product(self, circuit, beta, gamma, n):
        tabs = self._circuit_tables(circuit)
        assert tabs["n"] == n
        blk = tabs["block"]
        if blk is None:
            return self._made(PT.perm_product(
                tabs["wires"], tabs["id"], tabs["sig"],
                limbs.lift_scalar(beta, self.device, 3),
                limbs.lift_scalar(gamma, self.device, 3)))
        # z[j] = prod_{t<j} ratio_t: each run's exclusive prefix products
        # times the product of the shards before it (a run's total sits in
        # its last shard's slot, one in the others')
        bg = limbs.lift([beta, gamma], self.mesh.lead).reshape(
            FR_WORDS, 2, 1, 1)
        runs, totals = [], []
        for t, (dev, _) in enumerate(self._runs()):
            b_g = bg.to(dev)
            ratio = PT.perm_ratio(tabs["wires"][t], tabs["id"][t],
                                  tabs["sig"][t], b_g[:, 0], b_g[:, 1])
            run = PT.cumprod(ratio)
            runs.append(torch.cat([F.one_like(FR, run[:, :1]),
                                   run[:, :-1]], dim=1))
            totals.append((run[:, -1:], F.one_like(FR, run[:, -1:])))
        carry = F.one_like(FR, totals[0][0].to(self.mesh.lead))
        carries = []
        for t in collect(self.mesh, self._run_slots(totals, True)):
            carries.append(carry)
            carry = F.mont_mul(FR, carry, t)
        pieces = []
        for run, (_, idx) in zip(runs, self._runs()):
            z = F.mont_mul(FR, run, carries[self.mesh.first + idx[0]].to(
                run.device))
            pieces.extend(z[:, j * blk:(j + 1) * blk]
                          for j in range(len(idx)))
        return self._made(Sharded(self.mesh, n, blk, pieces,
                                  self._empty_tail()))

    def _domain_tables(self, m, n, group_gen):
        """Round 3's quotient-domain tables: per run of held shards
        (_runs), its lanes' tables built on its device (the JAX
        `_domain_tables` pins them to the mesh); whole on the lead where m
        does not shard."""
        blk = self._block(m)
        if blk is None:
            return super()._domain_tables(m, n, group_gen)
        # analysis: ok(group_gen generates the size-m domain: a function of m)
        return self._cached(self._domain_tabs, (m, n), lambda: [
            PT.domain_tables(m, n, FR_GENERATOR, group_gen, dev,
                             lo=(self.mesh.first + idx[0]) * blk,
                             count=len(idx) * blk)
            for dev, idx in self._runs()])

    def quotient(self, n, m, quot_domain, k, beta, gamma, alpha,
                 alpha_sq_div_n, selectors_coset, sigmas_coset, wires_coset,
                 z_coset, pi_coset):
        tabs = self._domain_tables(m, n, quot_domain.group_gen)
        ratio = m // n
        # the scalars in one upload (an upload waits for the queued work)
        consts = self._words(list(k) + [beta, gamma, alpha, alpha_sq_div_n])

        def evals(sel, sig, wir, z, pi, tab, dev, z_next=None):
            c = consts.to(dev)
            return PT.quotient_evals(
                sel, sig, wir, z, pi, tab,
                c[:, :len(k)].reshape(FR_WORDS, len(k), 1),
                *[c[:, j:j + 1] for j in range(len(k), len(k) + 4)], ratio,
                z_next=z_next)

        if not isinstance(z_coset, Sharded):
            return self._made(evals(*(torch.stack(hs, dim=1) for hs in (
                selectors_coset, sigmas_coset, wires_coset)), z_coset,
                pi_coset, tabs, self.mesh.lead))
        # one evaluation a run of shards, over the run's lanes; z_next = z
        # rolled by -ratio (each shard's lanes, the first `ratio` from the
        # next shard); a plane is concatenated from its pieces when the
        # evaluation reads it, so only a few run-wide planes live at once
        z_next = take(self.mesh, z_coset, ratio, m, z_coset.block, wrap=True)
        blk = z_coset.block
        pieces = []
        for (dev, idx), tab in zip(self._runs(), tabs):
            out = evals(_RunPlanes(selectors_coset, idx),
                        _RunPlanes(sigmas_coset, idx),
                        _RunPlanes(wires_coset, idx), _run_lanes(z_coset, idx),
                        _run_lanes(pi_coset, idx), tab, dev,
                        z_next=_run_lanes(z_next, idx))
            pieces.extend(out[:, j * blk:(j + 1) * blk]
                          for j in range(len(idx)))
        return self._made(Sharded(self.mesh, m, blk, pieces,
                                  self._empty_tail()))

    def degree_is(self, h, d):
        if not isinstance(h, Sharded):
            return super().degree_is(h, d)
        if h.length <= d:
            return False
        # per segment: (every lane above d zero, lane d held and nonzero)
        lead = self.mesh.lead
        flags = []
        for lo, t in self._segments(h):
            zero = t[:, max(d + 1 - lo, 0):].eq(0).all()
            here = lo <= d < lo + t.shape[1]
            nonzero = t[:, d - lo].ne(0).any() if here \
                else torch.zeros((), dtype=torch.bool, device=t.device)
            flags.append(torch.stack([zero, nonzero]).to(
                device=lead, dtype=torch.int32))
        shards = collect(self.mesh, flags[:-1])
        got = torch.stack(shards + [flags[-1]])
        return bool(got[:, 0].all()) and bool(got[:, 1].any())

    def split(self, h, size, count, total):
        assert count * size >= total
        blk = self._block(size)
        return [self._made(take(self.mesh, h, i * size, size, blk))
                for i in range(count)]

    def eval_many_async(self, pairs):
        """[(handle, point)] -> pending evaluations. Whole handles evaluate
        in one batch on the lead; sharded ones grouped by block, each
        device's shards in one batched Horner, each shard's partial sum
        times z^(s b), summed in shard order with the tail's."""
        acc = [None] * len(pairs)
        whole = [j for j, (h, _) in enumerate(pairs)
                 if not isinstance(h, Sharded)]
        if whole:
            L = max(pairs[j][0].shape[1] for j in whole)
            polys = torch.stack([self._pad(pairs[j][0], L) for j in whole],
                                dim=1)
            zs = self._words([pairs[j][1] for j in whole]).reshape(
                FR_WORDS, len(whole), 1)
            got = PT.poly_eval(polys, zs)
            for i, j in enumerate(whole):
                acc[j] = got[:, i]
        groups = collections.defaultdict(list)
        for j, (h, _) in enumerate(pairs):
            if isinstance(h, Sharded):
                groups[h.block].append(j)
        for blk in sorted(groups):
            for j, v in zip(groups[blk], self._eval_sharded(
                    [pairs[j] for j in groups[blk]], blk)):
                acc[j] = v
        out = F.from_mont(FR, torch.stack(acc, dim=1))      # (8, B)

        def force():
            self.lowers += 1
            return limbs.words_to_ints(limbs.to_numpy(out))
        return _DevicePending(force)

    def _eval_sharded(self, pairs, blk):
        """Montgomery p(z) on the lead for Sharded handles of one block."""
        mesh = self.mesh
        d, B = mesh.size, len(pairs)
        pts = [z for _, z in pairs]
        shards = mesh.shards()
        # the points, then z^(s b) for each held shard s and z^(D b) for
        # the tail, in one upload (an upload waits for the queued work)
        up = self._words(pts + [pow(z, s * blk, R_MOD) for s, _ in shards
                                for z in pts]
                         + [pow(z, d * blk, R_MOD) for z in pts])
        by_dev = collections.defaultdict(list)
        for i, (_, dev) in enumerate(shards):
            by_dev[dev].append(i)
        partial = {}
        for dev, held in by_dev.items():
            polys = torch.cat([torch.stack([h.pieces[i] for h, _ in pairs],
                                           dim=1) for i in held], dim=1)
            u = up.to(dev)
            zs = u[:, :B].repeat(1, len(held)).reshape(
                FR_WORDS, B * len(held), 1)
            got = PT.poly_eval(polys, zs).reshape(FR_WORDS, len(held), B)
            for r, i in enumerate(held):
                partial[i] = F.mont_mul(FR, got[:, r],
                                        u[:, (i + 1) * B:(i + 2) * B])
        sums = collect(mesh, [partial[i] for i in range(len(shards))])
        total = sums[0]
        for p in sums[1:]:
            total = F.add(FR, total, p)
        width = max(h.tail.shape[1] for h, _ in pairs)
        if width:
            tails = torch.stack([self._pad(h.tail, width) for h, _ in pairs],
                                dim=1)
            got = PT.poly_eval(tails, up[:, :B].reshape(FR_WORDS, B, 1))
            total = F.add(FR, total, F.mont_mul(FR, got, up[:, -B:]))
        return [total[:, j] for j in range(B)]

    def lin_comb_h(self, polys, coeffs):
        L = max(p.shape[1] for p in polys)
        blk = self._block(L)
        cf = self._words(coeffs).reshape(FR_WORDS, len(coeffs), 1)
        if blk is None:
            stacked = torch.stack([self._pad(gather(p), L) for p in polys],
                                  dim=1)
            return self._made(PT.lin_comb(stacked, cf))
        # every operand in the output's blocks (a Sharded one of that block
        # shares its pieces), then one linear combination a run of shards
        ops = [take(self.mesh, p, 0, L, blk) for p in polys]
        pieces = []
        for dev, idx in self._runs():
            out = PT.lin_comb(torch.stack([_run_lanes(o, idx) for o in ops],
                                          dim=1), cf.to(dev))
            pieces.extend(out[:, j * blk:(j + 1) * blk]
                          for j in range(len(idx)))
        tail = torch.stack([o.tail for o in ops], dim=1)
        tail = PT.lin_comb(tail, cf) if tail.shape[2] else tail[:, 0]
        return self._made(Sharded(self.mesh, L, blk, pieces, tail))

    def synth_div_h(self, h, point):
        if not isinstance(h, Sharded):
            return self._made(PT.synthetic_divide(
                h, limbs.lift_scalar(point, self.device)))
        # q_j = S_{j+1} z^-(j+1), S_t = sum_{u >= t} c_u z^u: each run's
        # suffix sums plus the totals of the lanes after it; u_t = S_t
        # z^-t in h's layout, then q = lanes [1, L) of u
        zinv = pow(point, R_MOD - 2, R_MOD)
        b, d = h.block, self.mesh.size
        segs = [(dev, (self.mesh.first + idx[0]) * b, _run_lanes(h, idx))
                for dev, idx in self._runs()]
        if h.tail.shape[1]:
            segs.append((self.mesh.lead, d * b, h.tail))
        # every segment's first powers of z and 1/z, in one upload
        starts = self._words([pow(x, lo, R_MOD) for _, lo, _ in segs
                              for x in (point, zinv)] + [point, zinv])

        def powers(i, x, count, dev):
            """x^lo .. x^(lo + count - 1) of segment i, x = z (0), 1/z (1),
            as (8, count) Montgomery."""
            start = starts[:, 2 * i + x:2 * i + x + 1].to(dev)
            col = starts.shape[1] - 2 + x
            rep = starts[:, col:col + 1].to(dev).expand(FR_WORDS, count - 1)
            return torch.cat([start, F.mont_mul(
                FR, PT.cumprod(rep.contiguous()), start)], dim=1)

        sums = [F.cumsum(FR, F.mont_mul(FR, t, powers(i, 0, t.shape[1], dev)),
                         reverse=True)
                for i, (dev, _, t) in enumerate(segs)]
        runs = len(self._runs())
        zero = torch.zeros((FR_WORDS, 1), dtype=torch.int32,
                           device=self.mesh.lead)
        # a run's total sits in its first shard's slot, zero in the others
        totals = collect(self.mesh, self._run_slots(
            [(x[:, :1], torch.zeros_like(x[:, :1])) for x in sums[:runs]],
            False))
        totals.append(sums[runs][:, :1] if len(sums) > runs else zero)
        after = [None] * len(totals)          # sum of the totals after each
        carry = zero
        for i in range(len(totals) - 1, -1, -1):
            after[i] = carry
            carry = F.add(FR, carry, totals[i].to(carry.device))
        last = [self.mesh.first + idx[-1] for _, idx in self._runs()] + [d]
        us = [F.mont_mul(FR, F.add(FR, x, after[last[i]].to(x.device)),
                         powers(i, 1, x.shape[1], dev))
              for i, (x, (dev, _, _)) in enumerate(zip(sums, segs))]
        pieces = [u[:, j * b:(j + 1) * b]
                  for u, (_, idx) in zip(us, self._runs())
                  for j in range(len(idx))]
        u = Sharded(self.mesh, h.length, b, pieces,
                    us[runs] if len(us) > runs else h.tail)
        return self._made(take(self.mesh, u, 1, h.length - 1,
                               self._block(h.length - 1)))


def _run_lanes(h, idx):
    """A Sharded handle's lanes over one run of held shards (piece indices
    idx), concatenated on the run's device."""
    if len(idx) == 1:
        return h.pieces[idx[0]]
    return torch.cat([h.pieces[i] for i in idx], dim=1)


class _RunPlanes:
    """Sharded planes read as prover_torch.quotient_evals reads a stacked
    (8, k, lanes) tensor: planes[:, i] is plane i's lanes over one run,
    concatenated when read. The evaluation reads each selector and sigma
    plane once, so a few run-wide planes live at a time where a stack
    would copy all of them."""

    def __init__(self, handles, idx):
        self.handles = handles
        self.idx = idx

    def __getitem__(self, key):
        _, i = key
        return _run_lanes(self.handles[i], self.idx)
