"""Single-device PyTorch backend: the prover's poly-handle protocol on one
CUDA card (the port of backend/jax_backend.py).

Poly handles are (8, L) int32 Montgomery Fr word tensors that stay on the
device across all five rounds: NTTs (kernel 2), commitments (digit
extraction on device, buckets in kernel 3, the tail in kernel 4), and the
round math (prover_torch: products in kernel 1, round 3's folds one
kernel each, csrc/round3.cu). Host transfers during a
prove are the witness upload, commitment results and transcript scalars.

Beside the synchronous method set, the prover picks up optional hooks
with getattr: the fused round 3 (`quotient_poly_streamed`, the default),
the streamed round 3 (`quotient_streamed`, `release_circuit_tables`) and
the async commitments and evaluations (`commit_many_async`,
`eval_many_async`). Set a hook to None on an instance to run the
prover's path without it. The pipelined prover
launches from a worker thread, so the caches are filled under a lock;
every launch goes to the calling thread's current CUDA stream (the
default stream on a fresh thread), so device work runs in enqueue order.

The int-list methods (`fft`, `ifft`, `coset_fft`, `coset_ifft`, `msm`,
`eval_h`) are what a fleet worker (runtime/worker.py) serves: host ints in,
host ints out, the same kernels in between.

Every device cache (MSM contexts, pk polynomials, circuit tables,
quotient-domain tables) holds at most `_CACHE_CAP` entries and evicts the
oldest first, as the JAX backend does: a long-lived process (a fleet
worker, a service) proves many shapes through one backend.

`TorchBackend()` runs on "cuda" and raises without a card; pass
device="cpu" to run every kernel's plain torch version instead (the tests).
"""

import threading

import torch

from ..constants import FR_GENERATOR, FR_WORDS
from ..circuit import NUM_WIRE_TYPES
from . import field_torch as F
from . import limbs
from . import ntt_torch
from . import prover_torch as PT
from .field_torch import FR
from .msm_torch import DeviceCommitKey, MsmContext, resolve_chunk


class _DevicePending:
    """Dispatched-but-unforced device result (commit_many_async /
    eval_many_async): the launches are enqueued; force() does the transfer
    and the host decode. The pipelined prover forces only at the owning
    member's host-finalize."""

    __slots__ = ("force",)

    def __init__(self, force):
        self.force = force


class TorchBackend:
    """Backend over the port's kernels on one device."""

    name = "torch"

    # polynomials per NTT launch (the batch axis of kernel 2)
    NTT_BATCH = 32
    # the streamed round 3: at most this many quotient-domain elements per
    # coset-FFT launch (4 planes at m = 2^21, the NTT_BATCH cap at 2^16),
    # and the lanes of one slice of the final combine
    STREAM_ELEMS = 1 << 23
    QUOT_SLICE = 1 << 20
    # below this n the witness/permutation tables stay cached across
    # proves; above it round 3 takes their memory back
    RELEASE_TABLES_MIN = 1 << 19
    # entries per device cache (jax_backend's _CACHE_CAP)
    _CACHE_CAP = 4

    def __init__(self, device=None, msm_layout="auto"):
        self.device = F.resolve_device(device, "TorchBackend")
        # the commit keys' MSM layout (msm_torch.resolve_layout): auto,
        # shifted or base
        self.msm_layout = msm_layout
        self._msm_ctxs = {}      # id(ck) -> (ck, MsmContext)
        self._pk_polys = {}      # id(pk) -> (pk, selectors, sigmas)
        self._circuit_tabs = {}  # id(circuit) -> (circuit, tables)
        self._domain_tabs = {}   # (m, n) -> quotient-domain tables
        self._cache_lock = threading.Lock()
        # host-boundary transfers: lifts (uploads), lowers (handle and
        # evaluation downloads; commitments are counted by neither)
        self.lifts = 0
        self.lowers = 0

    # --- handles ------------------------------------------------------------

    def lift(self, values):
        self.lifts += 1
        return limbs.lift(values, self.device)

    def lift_many(self, value_lists):
        """B equal-length int lists -> B handles, in ONE upload."""
        n = len(value_lists[0])
        assert all(len(v) == n for v in value_lists)
        h = self.lift([x for vs in value_lists for x in vs])
        return [h[:, i * n:(i + 1) * n] for i in range(len(value_lists))]

    def lower(self, h):
        self.lowers += 1
        return limbs.lower(h)

    def _cache_put(self, cache, key, value):
        """cache[key] = value, the oldest entry evicted first when the cache
        is full (self._cache_lock held)."""
        if key not in cache and len(cache) >= self._CACHE_CAP:
            cache.pop(next(iter(cache)))
        cache[key] = value

    def _cached(self, cache, key, build):
        """cache[key], built on a miss outside the lock: a concurrent hit
        never waits on a build, and a lost race costs one duplicate
        build."""
        with self._cache_lock:
            hit = cache.get(key)
        if hit is None:
            built = build()
            with self._cache_lock:
                hit = cache.get(key)
                if hit is None:
                    # analysis: ok(generic helper; each _cached call is linted)
                    self._cache_put(cache, key, built)
                    hit = built
        return hit

    # checkpoint dump/load (checkpoint.py): CANONICAL (16, L) uint32 16-bit
    # limb arrays, exactly what JaxBackend.dump_h writes, so a snapshot
    # resumes on either package
    def dump_h(self, h):
        self.lowers += 1
        return limbs.to_jax_limbs(F.from_mont(FR, h))

    def load_h(self, arr):
        self.lifts += 1
        return F.to_mont(FR, limbs.from_jax_limbs(arr, self.device))

    def wire_values(self, circuit):
        tabs = self._circuit_tables(circuit)
        return [tabs["wires"][:, i] for i in range(NUM_WIRE_TYPES)]

    def pk_polys(self, pk):
        """The proving key's 18 coefficient handles on this device: the
        handles preprocess left on the key when it ran on this device
        (another backend's, e.g. the service's key build), else lifted
        from its host lists once."""
        def build():
            dev = getattr(pk, "device_polys", None)
            # a mesh's key build leaves sharded handles: not this backend's
            if dev is not None and dev[0] == self.device and all(
                    isinstance(h, torch.Tensor) for h in dev[1] + dev[2]):
                return pk, list(dev[1]), list(dev[2])
            return (pk, [self.lift(s) for s in pk.selectors],
                    [self.lift(s) for s in pk.sigmas])
        hit = self._cached(self._pk_polys, id(pk), build)
        return hit[1], hit[2]

    def register_pk_polys(self, pk, sel_h, sig_h):
        """Seed the pk-poly cache with the handles preprocess computed on
        device, so the prover never re-lifts them through the host."""
        with self._cache_lock:
            # analysis: ok(sel_h, sig_h are pk's polys, made from pk)
            self._cache_put(self._pk_polys, id(pk),
                            (pk, list(sel_h), list(sig_h)))

    def warm_stages(self, domain_size, ck=None):
        """Build what a prove at this domain size needs before its first
        job arrives (the service's WARMUP with aot, store.aot_warmup): the
        kernels (nvcc, on the card), the NttPlans at n and at the
        quotient domain, round 3's quotient-domain tables, and, given the
        commit key, its window-shifted MSM context. Returns what it
        built."""
        from ..poly import Domain
        from . import _build
        n = domain_size
        quot = Domain((NUM_WIRE_TYPES + 1) * (n + 1) + 1)
        out = {"backend": self.name, "device": str(self.device),
               "kernels": [], "ntt_plans": [n, quot.size]}
        if self.device.type == "cuda":
            _build.load()
            out["kernels"] = sorted(_build.SOURCES)
        for size in out["ntt_plans"]:
            ntt_torch.get_plan(size, self.device)
        self._domain_tables(quot.size, n, quot.group_gen)
        if ck is not None:
            self._ctx(ck)
            out["commit_key_points"] = len(ck)
        return out

    # --- int-list compute API (the fleet worker's surface) -------------------

    def _run_ints(self, domain, values, inverse, coset):
        plan = ntt_torch.get_plan(domain.size, self.device)
        return plan.run_ints(values, inverse, coset)

    def fft(self, domain, values):
        return self._run_ints(domain, values, False, False)

    def ifft(self, domain, values):
        return self._run_ints(domain, values, True, False)

    def coset_fft(self, domain, values):
        return self._run_ints(domain, values, False, True)

    def coset_ifft(self, domain, values):
        return self._run_ints(domain, values, True, True)

    def msm(self, bases, scalars):
        """sum_j scalars[j] * bases[j] over a host list of affine bases
        (scalars may be shorter: the missing ones are zero), through the
        cached MsmContext of that base list."""
        return self._ctx(bases).msm(scalars)

    def eval_h(self, h, point):
        return self.eval_many_h([(h, point)])[0]

    # --- NTTs ---------------------------------------------------------------

    def _pad(self, h, size):
        return F.pad_words(h, size) if h.shape[-1] < size else h

    def _ntt_batches(self, domain, hs, inverse, coset, width):
        """Yield (8, B, size) NTT results covering hs in order, B <= width:
        _ntt_many collects them, the streamed round 3 folds each batch as
        it comes so no batch outlives its consumption."""
        plan = ntt_torch.get_plan(domain.size, self.device)
        for i in range(0, len(hs), width):
            batch = torch.stack([self._pad(h, domain.size)
                                 for h in hs[i:i + width]], dim=1)
            yield ntt_torch.ntt(plan, batch, inverse, coset)

    def _ntt_many(self, domain, hs, inverse, coset):
        out = []
        for res in self._ntt_batches(domain, hs, inverse, coset,
                                     self.NTT_BATCH):
            out.extend(res[:, j] for j in range(res.shape[1]))
        return out

    def ifft_h(self, domain, h):
        return self._ntt_many(domain, [h], True, False)[0]

    def ifft_many(self, domain, hs):
        return self._ntt_many(domain, hs, True, False)

    def coset_fft_many(self, domain, hs):
        return self._ntt_many(domain, hs, False, True)

    def coset_ifft_h(self, domain, h):
        return self._ntt_many(domain, [h], True, True)[0]

    # --- streamed round 3 ----------------------------------------------------
    # The single-device memory strategy for the quotient round (reference
    # src/dispatcher2.rs:382-507): each selector plane folds into the gate
    # accumulator and each sigma plane into acc2 right after its coset FFT
    # and is dropped, so about 10 planes stay resident (5 wires, z, gate,
    # acc2 and one launch's batch) instead of 25; the final combine runs
    # in lane slices. `quotient_streamed` is the JAX package's unfused
    # steps (jax_backend.py:519-544), value for value, and the prover runs
    # the coset iNTT after; `quotient_poly_streamed`, the default, is its
    # fused path (DPT_R3_FUSE): one kernel per fold and the combine over
    # the whole domain, then the iNTT. No bit-reversal is deferred
    # (DPT_R3_BITREV), since kernel 2 writes natural order, and no packing
    # is needed, since (8, m) int32 words already are the JAX package's
    # packed layout.

    def _r3_accumulate(self, n, m, quot_domain, beta, gamma, sel_h, sigma_h,
                       wire_polys, perm_poly, pi_coeffs):
        """Base coset FFTs + gate/sigma plane folding -> (wires, z, gate,
        acc2) (8, m) planes."""
        base = self.coset_fft_many(
            quot_domain, list(wire_polys) + [perm_poly, pi_coeffs])
        w, z, gate = base[:5], base[5], base[6]  # gate starts as the pi plane
        acc2 = torch.roll(z, -(m // n), dims=1)    # z_next
        del base
        width = self._stream_width(m)
        beta_c = limbs.lift_scalar(beta, self.device)
        gamma_c = limbs.lift_scalar(gamma, self.device)
        idx = 0
        for res in self._ntt_batches(quot_domain, list(sel_h), False, True,
                                     width):
            for j in range(res.shape[1]):
                step, operands = PT.GATE_STEPS[idx]
                gate = step(gate, res[:, j], *[w[x] for x in operands])
                idx += 1
        idx = 0
        for res in self._ntt_batches(quot_domain, list(sigma_h), False, True,
                                     width):
            for j in range(res.shape[1]):
                acc2 = PT.sigma_step(acc2, res[:, j], w[idx], beta_c,
                                     gamma_c)
                idx += 1
        return w, z, gate, acc2

    def _stream_width(self, m):
        """Planes per coset-FFT launch of the streamed round 3."""
        return max(1, min(self.NTT_BATCH, self.STREAM_ELEMS // m))

    def quotient_poly_streamed(self, n, m, quot_domain, k, beta, gamma,
                               alpha, alpha_sq_div_n, sel_h, sigma_h,
                               wire_polys, perm_poly, pi_coeffs):
        """Round 3 from coefficient handles to the quotient polynomial
        (8, m): the fused round 3 (JAX quotient_poly_streamed under
        DPT_R3_FUSE). The base coset FFTs (wires, z, pi) in one kernel-2
        call; each selector batch's coset FFT folded into the gate
        accumulator by one r3_gate_fold launch and each sigma batch's into
        acc2 by one r3_sigma_fold, with the streamed path's batch widths;
        then one r3_combine over the whole quotient domain and the coset
        iNTT. On the card no int64 temporary is made: each fold's only
        allocation is its (8, m) result."""
        tabs = self._domain_tables(m, n, quot_domain.group_gen)
        polys = list(wire_polys) + [perm_poly, pi_coeffs]
        base = next(self._ntt_batches(quot_domain, polys, False, True,
                                      len(polys)))
        w, z, gate = base[:, :5], base[:, 5], base[:, 6]
        acc2 = torch.roll(z, -(m // n), dims=1)      # z_next
        width = self._stream_width(m)
        for i, res in enumerate(self._ntt_batches(
                quot_domain, list(sel_h), False, True, width)):
            gate = PT.gate_fold(gate, res, w, i * width)
        for i, res in enumerate(self._ntt_batches(
                quot_domain, list(sigma_h), False, True, width)):
            acc2 = PT.sigma_fold(acc2, res, w, i * width, beta, gamma)
        del res
        evals = PT.quotient_combine(w, z, gate, acc2, tabs, k, beta, gamma,
                                    alpha, alpha_sq_div_n)
        del base, w, z, gate, acc2
        return self.coset_ifft_h(quot_domain, evals)

    def quotient_streamed(self, n, m, quot_domain, k, beta, gamma, alpha,
                          alpha_sq_div_n, sel_h, sigma_h, wire_polys,
                          perm_poly, pi_coeffs):
        """Round 3 from coefficient handles: coset FFTs and quotient
        evaluation in one streaming pass -> (8, m) quotient evaluations,
        combined in slices of QUOT_SLICE lanes."""
        tabs = self._domain_tables(m, n, quot_domain.group_gen)
        w, z, gate, acc2 = self._r3_accumulate(
            n, m, quot_domain, beta, gamma, sel_h, sigma_h, wire_polys,
            perm_poly, pi_coeffs)
        chunk = min(self.QUOT_SLICE, m)
        assert m % chunk == 0
        kc = self.lift(list(k)).reshape(FR_WORDS, len(k), 1)
        sc = [limbs.lift_scalar(x, self.device)
              for x in (beta, gamma, alpha, alpha_sq_div_n)]
        outs = [PT.quotient_combine_slice(w, z, gate, acc2, tabs, kc, *sc,
                                          j0, chunk)
                for j0 in range(0, m, chunk)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def release_circuit_tables(self, circuit):
        """Free the witness/permutation tables (about 0.25 GB at n = 2^19)
        when the circuit is large enough that round 3 needs the memory.
        The prover calls this after round 2 (the tables' last reader);
        above the threshold a later prove lifts them again."""
        if len(circuit.wire_variables[0]) < self.RELEASE_TABLES_MIN:
            return
        with self._cache_lock:
            self._circuit_tabs.pop(id(circuit), None)

    # --- commitments ----------------------------------------------------------

    def _ctx(self, ck):
        """The MSM context of commit key `ck`, at the chunk the kernel
        plan resolves now (msm_torch.resolve_chunk): a reloaded plan gets
        a view at its chunk that shares the cached window-shifted key."""
        if isinstance(ck, DeviceCommitKey):
            # the key's own context on this device: shared with every
            # other backend here (preprocess's, a service's pool workers)
            ctx = self._cached(self._msm_ctxs, id(ck), lambda: (
                ck, ck.context(self.device, self.msm_layout)))[1]
        else:
            ctx = self._cached(self._msm_ctxs, id(ck), lambda: (
                ck, MsmContext(ck, self.device, layout=self.msm_layout)))[1]
        return ctx.at_chunk(resolve_chunk(None, ctx.n))

    def commit_many_h(self, ck, hs):
        return self._ctx(ck).msm_mont_limbs_many(hs)

    def commit_many_async(self, ck, hs):
        """commit_many_h with the launches enqueued now and the transfer
        and host decode at force()."""
        return _DevicePending(self._ctx(ck).msm_mont_limbs_many_async(hs))

    # --- round math -----------------------------------------------------------

    def blind(self, h, blinds, n):
        return PT.add_vanishing_blind(h, self.lift(blinds), n)

    def _circuit_tables(self, circuit):
        """Witness, identity-permutation and sigma-mapped identity values as
        (8, w, n) tables, lifted once per circuit."""
        return self._cached(self._circuit_tabs, id(circuit), lambda: (
            circuit, self._lift_circuit_tables(circuit)))[1]

    def _lift_circuit_tables(self, circuit):
        n = len(circuit.wire_variables[0])
        w = NUM_WIRE_TYPES
        wires = [v for i in range(w) for v in circuit.wire_values(i)]
        ids = [circuit.extended_id_permutation[i][j]
               for i in range(w) for j in range(n)]
        sig = []
        for i in range(w):
            for j in range(n):
                pi, pj = circuit.wire_permutation[i][j]
                sig.append(circuit.extended_id_permutation[pi][pj])
        tabs = {k: self.lift(v).reshape(FR_WORDS, w, n)
                for k, v in (("wires", wires), ("id", ids), ("sig", sig))}
        tabs["n"] = n
        return tabs

    def perm_product(self, circuit, beta, gamma, n):
        tabs = self._circuit_tables(circuit)
        assert tabs["n"] == n
        return PT.perm_product(
            tabs["wires"], tabs["id"], tabs["sig"],
            limbs.lift_scalar(beta, self.device, 3),
            limbs.lift_scalar(gamma, self.device, 3))

    def _domain_tables(self, m, n, group_gen):
        # analysis: ok(group_gen generates the size-m domain: a function of m)
        return self._cached(self._domain_tabs, (m, n), lambda: (
            PT.domain_tables(m, n, FR_GENERATOR, group_gen, self.device)))

    def quotient(self, n, m, quot_domain, k, beta, gamma, alpha,
                 alpha_sq_div_n, selectors_coset, sigmas_coset, wires_coset,
                 z_coset, pi_coset):
        tabs = self._domain_tables(m, n, quot_domain.group_gen)
        sc = [limbs.lift_scalar(x, self.device)
              for x in (beta, gamma, alpha, alpha_sq_div_n)]
        return PT.quotient_evals(
            torch.stack(selectors_coset, dim=1),
            torch.stack(sigmas_coset, dim=1),
            torch.stack(wires_coset, dim=1), z_coset, pi_coset, tabs,
            self.lift(list(k)).reshape(FR_WORDS, len(k), 1), *sc, m // n)

    def degree_is(self, h, d):
        if h.shape[1] <= d:
            return False
        return PT.tail_is_zero(h, d) and not PT.tail_is_zero(h, d - 1)

    def split(self, h, size, count, total):
        assert count * size >= total
        h = self._pad(h, count * size)
        return [h[:, i:i + size] for i in range(0, count * size, size)]

    def eval_many_async(self, pairs):
        """[(handle, point)] -> pending evaluations: the batched evaluation
        is enqueued now, the transfer and decode run at force()."""
        L = max(h.shape[1] for h, _ in pairs)
        polys = torch.stack([self._pad(h, L) for h, _ in pairs], dim=1)
        zs = self.lift([p for _, p in pairs]).reshape(FR_WORDS, len(pairs),
                                                      1)
        out = PT.poly_eval_many(polys, zs)              # (8, B) canonical

        def force():
            self.lowers += 1
            return limbs.words_to_ints(limbs.to_numpy(out))
        return _DevicePending(force)

    def eval_many_h(self, pairs):
        """[(handle, point)] -> evaluations, in one batched device call."""
        return self.eval_many_async(pairs).force()

    def lin_comb_h(self, polys, coeffs):
        L = max(p.shape[1] for p in polys)
        stacked = torch.stack([self._pad(p, L) for p in polys], dim=1)
        cf = self.lift(coeffs).reshape(FR_WORDS, len(coeffs), 1)
        return PT.lin_comb(stacked, cf)

    def synth_div_h(self, h, point):
        return PT.synthetic_divide(h, limbs.lift_scalar(point, self.device))
