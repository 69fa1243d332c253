"""Single-device PyTorch backend: the prover's poly-handle protocol on one
CUDA card (the port of backend/jax_backend.py's synchronous method set).

Poly handles are (8, L) int32 Montgomery Fr word tensors that stay on the
device across all five rounds: NTTs (kernel 2), commitments (digit
extraction on device, buckets in kernel 3, the tail in kernel 4), and the
round math (prover_torch, products in kernel 1). Host transfers during a
prove are the witness upload, commitment results and transcript scalars.

`TorchBackend()` runs on "cuda" and raises without a card; pass
device="cpu" to run every kernel's plain torch version instead (the tests).
"""

import torch

from ..constants import FR_GENERATOR, FR_WORDS
from ..circuit import NUM_WIRE_TYPES
from . import field_torch as F
from . import limbs
from . import ntt_torch
from . import prover_torch as PT
from .msm_torch import MsmContext


class TorchBackend:
    """Backend over the port's kernels on one device."""

    # polynomials per NTT launch (the batch axis of kernel 2)
    NTT_BATCH = 32

    def __init__(self, device=None):
        self.device = F.resolve_device(device, "TorchBackend")
        self._msm_ctxs = {}      # id(ck) -> (ck, MsmContext)
        self._pk_polys = {}      # id(pk) -> (pk, selectors, sigmas)
        self._circuit_tabs = {}  # id(circuit) -> (circuit, tables)
        self._domain_tabs = {}   # (m, n) -> quotient-domain tables

    # --- handles ------------------------------------------------------------

    def lift(self, values):
        return limbs.lift(values, self.device)

    def lift_many(self, value_lists):
        """B equal-length int lists -> B handles, in ONE upload."""
        n = len(value_lists[0])
        assert all(len(v) == n for v in value_lists)
        h = self.lift([x for vs in value_lists for x in vs])
        return [h[:, i * n:(i + 1) * n] for i in range(len(value_lists))]

    def lower(self, h):
        return limbs.lower(h)

    def wire_values(self, circuit):
        tabs = self._circuit_tables(circuit)
        return [tabs["wires"][:, i] for i in range(NUM_WIRE_TYPES)]

    def pk_polys(self, pk):
        hit = self._pk_polys.get(id(pk))
        if hit is None:
            hit = (pk, [self.lift(s) for s in pk.selectors],
                   [self.lift(s) for s in pk.sigmas])
            self._pk_polys[id(pk)] = hit
        return hit[1], hit[2]

    def register_pk_polys(self, pk, sel_h, sig_h):
        """Seed the pk-poly cache with the handles preprocess computed on
        device, so the prover never re-lifts them through the host."""
        self._pk_polys[id(pk)] = (pk, list(sel_h), list(sig_h))

    # --- NTTs ---------------------------------------------------------------

    def _pad(self, h, size):
        return torch.nn.functional.pad(h, (0, size - h.shape[-1])) \
            if h.shape[-1] < size else h

    def _ntt_many(self, domain, hs, inverse, coset):
        plan = ntt_torch.get_plan(domain.size, self.device)
        out = []
        for i in range(0, len(hs), self.NTT_BATCH):
            batch = torch.stack([self._pad(h, domain.size)
                                 for h in hs[i:i + self.NTT_BATCH]], dim=1)
            res = ntt_torch.ntt(plan, batch, inverse, coset)
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

    # --- commitments ----------------------------------------------------------

    def _ctx(self, ck):
        hit = self._msm_ctxs.get(id(ck))
        if hit is None:
            hit = self._msm_ctxs[id(ck)] = (ck, MsmContext(ck, self.device))
        return hit[1]

    def commit_many_h(self, ck, hs):
        return self._ctx(ck).msm_mont_limbs_many(hs)

    # --- round math -----------------------------------------------------------

    def blind(self, h, blinds, n):
        return PT.add_vanishing_blind(h, self.lift(blinds), n)

    def _circuit_tables(self, circuit):
        """Witness, identity-permutation and sigma-mapped identity values as
        (8, w, n) tables, lifted once per circuit."""
        hit = self._circuit_tabs.get(id(circuit))
        if hit is not None:
            return hit[1]
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
        self._circuit_tabs[id(circuit)] = (circuit, tabs)
        return tabs

    def perm_product(self, circuit, beta, gamma, n):
        tabs = self._circuit_tables(circuit)
        assert tabs["n"] == n
        return PT.perm_product(
            tabs["wires"], tabs["id"], tabs["sig"],
            limbs.lift_scalar(beta, self.device, 3),
            limbs.lift_scalar(gamma, self.device, 3))

    def _domain_tables(self, m, n, group_gen):
        key = (m, n)
        if key not in self._domain_tabs:
            self._domain_tabs[key] = PT.domain_tables(
                m, n, FR_GENERATOR, group_gen, self.device)
        return self._domain_tabs[key]

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

    def eval_many_h(self, pairs):
        """[(handle, point)] -> evaluations, in one batched device call."""
        L = max(h.shape[1] for h, _ in pairs)
        polys = torch.stack([self._pad(h, L) for h, _ in pairs], dim=1)
        zs = self.lift([p for _, p in pairs]).reshape(FR_WORDS, len(pairs),
                                                      1)
        out = PT.poly_eval_many(polys, zs)              # (8, B) canonical
        return limbs.words_to_ints(limbs.to_numpy(out))

    def lin_comb_h(self, polys, coeffs):
        L = max(p.shape[1] for p in polys)
        stacked = torch.stack([self._pad(p, L) for p in polys], dim=1)
        cf = self.lift(coeffs).reshape(FR_WORDS, len(coeffs), 1)
        return PT.lin_comb(stacked, cf)

    def synth_div_h(self, h, point):
        return PT.synthetic_divide(h, limbs.lift_scalar(point, self.device))
