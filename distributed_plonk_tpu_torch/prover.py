"""The 5-round TurboPlonk prover.

Round structure and math mirror the reference's fully-distributed v2 prover
(`Prover::prove`, reference src/dispatcher2.rs:192-713). All polynomial
work — NTTs, MSMs, and the per-round vector math (permutation product,
quotient evaluation, blinding, linear combination, evaluation, synthetic
division) — is delegated to a backend through an opaque poly-handle API:
an int list on a host oracle, an (8, L) Montgomery word tensor that stays
on the card between rounds on TorchBackend. Only transcript scalars
(commitments, challenges, evaluations) cross the host boundary mid-prove.

Fiat-Shamir challenge schedule (beta, gamma, alpha, zeta, v) and transcript
bytes match FakeStandardTranscript exactly, so a proof is byte-identical to
the JAX package's for the same rng, circuit and key.

Each round is factored into an explicit STAGE with a work half (one
member's challenge derivation, host vector math and device ops, returning
the handles the round commits or the pairs it evaluates), a dispatch of
that work (an unforced pending) and a host-finalize half (absorbs the
results into the member's transcript, persists the round checkpoint).
Three drivers share the stages:

  * `prove`          — one job, stages run back-to-back (the reference's
                       sequential round loop).
  * `prove_many`     — N same-shape jobs in LOCKSTEP, each round's
                       commitments or evaluations of all members in one
                       backend call.
  * `prove_pipelined`— N independent jobs in a SOFTWARE PIPELINE over the
                       rounds: up to PIPELINE_DEPTH members in flight, so
                       job B's round-1 commit launches are enqueued while
                       job A's round-2 transcript hashing and checkpoint
                       write run on the host. The per-round checkpoint
                       boundaries are the stage latches.

All three produce byte-identical proofs for the same (rng, circuit, pk):
everything Fiat-Shamir or blinding touches is per-member state that never
crosses members, and pipelining only moves WHEN a launch happens, never
what it computes.

Work attribution: the spans of kernel work (the NTT spans, the commits)
carry the work model of trace.py (`flops`, `data_bytes`), which
Metrics.observe_kernels turns into per-stage utilisation. A gauge is only
honest if its seconds cover the device work, so on the card, where a span
covers the launches only, the model rides a `kernels/<name>` event
instead: CUDA events around the span's launches for the NTT spans, the
dispatch-to-force interval for the commits. On the host, and on backends
that compute before they return (a fleet), the model rides the span.
"""

import random
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

from .checkpoint import (_point_dec, _point_enc, dump_handle, load_handle,
                         workload_fingerprint)
from .constants import R_MOD
from .fields import fr_inv
from .poly import Domain
from .circuit import NUM_WIRE_TYPES, Q_LC, Q_MUL, Q_HASH, Q_O, Q_C, Q_ECC
from .trace import NULL_TRACER, msm_flops, ntt_flops
from .transcript import StandardTranscript

# members in flight in prove_pipelined when the caller gives no depth
PIPELINE_DEPTH = 4


class Proof:
    def __init__(self, wires_poly_comms, prod_perm_poly_comm,
                 split_quot_poly_comms, opening_proof, shifted_opening_proof,
                 wires_evals, wire_sigma_evals, perm_next_eval):
        self.wires_poly_comms = wires_poly_comms
        self.prod_perm_poly_comm = prod_perm_poly_comm
        self.split_quot_poly_comms = split_quot_poly_comms
        self.opening_proof = opening_proof
        self.shifted_opening_proof = shifted_opening_proof
        self.wires_evals = wires_evals
        self.wire_sigma_evals = wire_sigma_evals
        self.perm_next_eval = perm_next_eval


def _rand(rng, count):
    return [rng.randrange(R_MOD) for _ in range(count)]


# -- pendings: what a stage's launch half hands its finalize half -------------

class _Ready:
    """Already-computed stage result (sync backends, or device work the
    launch half had to block on anyway). force() is free."""

    __slots__ = ("_values",)

    def __init__(self, values):
        self._values = values

    def force(self):
        return self._values


class _KernelPending:
    """A dispatched-but-unforced device result. force() blocks until the
    device delivers, then records a `kernels/<name>` trace event covering
    dispatch→force, with `attrs` (the work model) on it: the device time
    of the dispatched work plus its host decode. The dispatch itself is
    the `<name>` span; under the pipeline the event overlaps other
    members' rounds."""

    __slots__ = ("_force", "_tr", "_name", "_attrs", "_w0", "_p0")

    def __init__(self, force, tr, name, **attrs):
        self._force = force
        self._tr = tr
        self._name = name
        self._attrs = attrs
        self._w0 = time.time()
        self._p0 = time.perf_counter()

    def force(self):
        values = self._force()
        self._tr.add_event("kernels/" + self._name,
                           time.perf_counter() - self._p0, ts=self._w0,
                           **self._attrs)
        return values


_WORK_KEYS = ("flops", "data_bytes")


def _record_events(devices):
    """One timing CUDA event recorded now on each device's current
    stream."""
    import torch
    evs = []
    for d in devices:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(d))
        evs.append(ev)
    return evs


@contextmanager
def _work_span(cx, mb, name, **attrs):
    """The span `name` around a stage's device work, `attrs` holding its
    work model. Where the backend launches on the card (cx.event_devices)
    the span keeps the other attributes, and the model goes on a
    `kernels/<name>` event whose seconds are the device's, from CUDA
    events recorded before and after the launches (_flush_work records
    it once the round's results are forced)."""
    if not cx.event_devices or mb.tr is NULL_TRACER:
        with mb.tr.span(name, **attrs):
            yield
        return
    lite = {k: v for k, v in attrs.items() if k not in _WORK_KEYS}
    w0 = time.time()
    starts = _record_events(cx.event_devices)
    with mb.tr.span(name, **lite):
        yield
    ends = _record_events(cx.event_devices)
    mb.work.append((name, w0, starts, ends,
                    {k: attrs[k] for k in _WORK_KEYS if k in attrs}))


def _flush_work(mb):
    """Record the member's pending `kernels/<name>` events of device
    work, one level under the round: each lasts the longest start-to-end
    interval of its devices. Called after the round's results were
    forced, so the end events have completed and reading them does not
    wait (query() first; a wait only if a caller flushed early)."""
    while mb.work:
        name, w0, starts, ends, attrs = mb.work.pop(0)
        for ev in ends:
            if not ev.query():
                ev.synchronize()
        dur = max(a.elapsed_time(b) for a, b in zip(starts, ends)) / 1e3
        mb.tr.add_event("kernels/" + name, dur, ts=w0, depth=1, **attrs)


class _ProveCtx:
    """Read-only per-(pk, backend) state shared by the round stages:
    domains, the proving key's selector/sigma handles, and the backend's
    optional capability hooks. One instance serves any number of members
    (sequential, lockstep, or pipelined); nothing here is written after
    construction, so stages running on different threads share it freely."""

    def __init__(self, pk, backend):
        self.pk = pk
        self.backend = backend
        self.n = pk.domain_size
        self.domain = pk.domain
        self.nw = NUM_WIRE_TYPES
        self.quot_domain = Domain((self.nw + 1) * (self.n + 1) + 1)
        self.m = self.quot_domain.size
        self.ck = pk.ck
        self.sel_h, self.sigma_h = backend.pk_polys(pk)
        self.release = getattr(backend, "release_circuit_tables", None)
        # quotient_streamed: the backend folds each selector/sigma coset
        # plane into running accumulators as it is produced, so about 10
        # planes are resident instead of 25 (the round-3 working set is
        # the single-card scale ceiling); without the hook the one-shot
        # path runs. Both compute identical values.
        self.stream = getattr(backend, "quotient_streamed", None)
        # quotient_poly_streamed: the same streaming accumulation with one
        # kernel per fold, the combine over the whole quotient domain and
        # the coset iNTT inside: round 3 straight to the quotient
        # polynomial (the JAX package's DPT_R3_FUSE); taken first
        self.stream_poly = getattr(backend, "quotient_poly_streamed", None)
        self.commit_async = getattr(backend, "commit_many_async", None)
        self.eval_async = getattr(backend, "eval_many_async", None)
        # the cards this backend launches on (a mesh's shards, or its one
        # device), whose CUDA events time the work spans; none on the host
        # or for a backend that computes before it returns
        mesh = getattr(backend, "mesh", None)
        devs = list(mesh.devices) if mesh is not None \
            else [getattr(backend, "device", None)]
        self.event_devices = list(dict.fromkeys(
            d for d in devs if getattr(d, "type", None) == "cuda"))


class _Member:
    """One job's slice of a batched or pipelined prove: its own rng,
    transcript, tracer, checkpoint, and round outputs — everything
    Fiat-Shamir or blinding touches stays strictly per member, which is
    what makes both drivers byte-identical to N sequential proves."""

    def __init__(self, i, rng, ckt, tracer, checkpoint):
        self.i = i
        self.rng = rng or random.Random()
        self.ckt = ckt
        self.tr = tracer or NULL_TRACER
        self.checkpoint = checkpoint
        self.transcript = StandardTranscript()
        self.pub = ckt.public_input()
        self.fp = None
        self.ck_arrays = {}
        self.ck_meta = {}
        self.work = []    # device-timed work spans awaiting _flush_work


def _save_member(cx, mb, round_no):
    """THE round-boundary checkpoint latch — the one shared implementation
    (sequential, lockstep, and pipelined drivers all land here), so the
    snapshot payload can never drift between paths. A checkpoint
    subclass's save hook (a kill or drain control point, fault injection)
    fires there, so pipelined members hit it at their OWN stage
    boundaries."""
    if mb.checkpoint is None:
        return
    with mb.tr.span("checkpoint_save"):
        mb.checkpoint.save(
            round_no, mb.fp, mb.rng, mb.transcript,
            {k: dump_handle(cx.backend, h) for k, h in mb.ck_arrays.items()},
            mb.ck_meta)


def _loadh(cx, ck_state, name):
    return load_handle(cx.backend, ck_state["arrays"][name])


def _points(meta_val):
    return [_point_dec(v) for v in meta_val]


def _commit_attrs(n, width, count):
    """The commit spans' work model: `count` MSMs of n + width points."""
    return {"polys": count, "flops": msm_flops(n + width, count),
            "data_bytes": count * (n + width) * 32}


def _dispatch_commit(cx, mb, hs, name, width):
    """Dispatch the round's commit MSMs over `hs` (handles of n + width
    coefficients). Async-capable backends enqueue the launches under the
    `<name>` span and return an unforced pending (the member's
    host-finalize forces it — that is the pipeline overlap window), the
    work model moved onto its `kernels/<name>` event; backends without
    async dispatch compute inline under that span, which carries the
    model."""
    attrs = _commit_attrs(cx.n, width, len(hs))
    if cx.commit_async is not None:
        with mb.tr.span(name, polys=len(hs)):
            dev = cx.commit_async(cx.ck, hs)
        return _KernelPending(dev.force, mb.tr, name,
                              **{k: attrs[k] for k in _WORK_KEYS})
    with mb.tr.span(name, **attrs):
        return _Ready(cx.backend.commit_many_h(cx.ck, hs))


def _dispatch_evals(cx, mb, pairs):
    """Round-4 evaluation dispatch; same contract as _dispatch_commit."""
    if cx.eval_async is not None:
        dev = cx.eval_async(pairs)
        return _KernelPending(dev.force, mb.tr, "eval_many")
    return _Ready(cx.backend.eval_many_h(pairs))


# -- the five round stages ----------------------------------------------------
# Each work half runs one member's challenges, host math and device ops and
# returns what the round commits (the handles) or evaluates (round 4's
# (handle, point) pairs); the drivers dispatch that, one member at a time
# (prove, the pipeline) or all members in one call (prove_many). Each
# finalize half absorbs the results into the transcript and saves the round
# checkpoint (the stage latch). Each restore half reproduces the resume
# path from a round-`no` snapshot, bit-for-bit the pre-stage behavior. The
# cumulative checkpoint payload rule still holds: every snapshot carries
# all state the REMAINING rounds read (wire/perm/quotient handles +
# commitments + challenges), since earlier snapshots are overwritten.

def _work_r1(cx, mb):
    # --- Round 1: wire polynomials (reference src/dispatcher2.rs:293-323)
    be, n, nw = cx.backend, cx.n, cx.nw
    with _work_span(cx, mb, "ifft_wires", polys=nw, flops=ntt_flops(n, nw),
                    data_bytes=nw * n * 32):
        # one batch call: one launch on the device (join_all across the
        # workers in the reference, dispatcher2.rs:294-306)
        wire_coeffs = be.ifft_many(cx.domain, be.wire_values(mb.ckt))
        mb.wire_polys = [be.blind(coeffs, _rand(mb.rng, 2), n)
                         for coeffs in wire_coeffs]
    return mb.wire_polys


def _finalize_r1(cx, mb, comms):
    mb.wires_poly_comms = list(comms)
    mb.transcript.append_commitments(b"witness_poly_comms",
                                     mb.wires_poly_comms)
    if mb.checkpoint is not None:
        mb.ck_arrays.update({"wire_poly_%d" % i: h
                             for i, h in enumerate(mb.wire_polys)})
        mb.ck_meta["wires_poly_comms"] = [_point_enc(p)
                                          for p in mb.wires_poly_comms]
    _save_member(cx, mb, 1)


def _restore_r1(cx, mb, ck_state):
    mb.wire_polys = [_loadh(cx, ck_state, "wire_poly_%d" % i)
                     for i in range(cx.nw)]
    mb.wires_poly_comms = _points(ck_state["meta"]["wires_poly_comms"])
    mb.ck_arrays.update({"wire_poly_%d" % i: h
                         for i, h in enumerate(mb.wire_polys)})
    mb.ck_meta.update(ck_state["meta"])


def _work_r2(cx, mb):
    # --- Round 2: permutation product (reference src/dispatcher2.rs:325-357)
    be, n = cx.backend, cx.n
    mb.beta = mb.transcript.get_and_append_challenge(b"beta")
    mb.gamma = mb.transcript.get_and_append_challenge(b"gamma")
    with mb.tr.span("perm_product"):
        product_h = be.perm_product(mb.ckt, mb.beta, mb.gamma, n)
    with _work_span(cx, mb, "ifft_perm", flops=ntt_flops(n),
                    data_bytes=n * 32):
        perm_coeffs = be.ifft_h(cx.domain, product_h)
    mb.permutation_poly = be.blind(perm_coeffs, _rand(mb.rng, 3), n)
    return [mb.permutation_poly]


def _finalize_r2(cx, mb, comms):
    mb.prod_perm_poly_comm = comms[0]
    mb.transcript.append_commitment(b"perm_poly_comms",
                                    mb.prod_perm_poly_comm)
    if mb.checkpoint is not None:
        mb.ck_arrays["permutation_poly"] = mb.permutation_poly
        mb.ck_meta["beta"] = hex(mb.beta)
        mb.ck_meta["gamma"] = hex(mb.gamma)
        mb.ck_meta["prod_perm_poly_comm"] = \
            _point_enc(mb.prod_perm_poly_comm)
    _save_member(cx, mb, 2)


def _restore_r2(cx, mb, ck_state):
    mb.permutation_poly = _loadh(cx, ck_state, "permutation_poly")
    mb.ck_arrays["permutation_poly"] = mb.permutation_poly
    mb.beta = int(mb.ck_meta["beta"], 16)
    mb.gamma = int(mb.ck_meta["gamma"], 16)
    mb.prod_perm_poly_comm = _point_dec(mb.ck_meta["prod_perm_poly_comm"])


def _work_r3(cx, mb):
    # --- Round 3: quotient polynomial (reference src/dispatcher2.rs:360-533)
    be, n, m, nw = cx.backend, cx.n, cx.m, cx.nw
    # rounds 3-5 never read the witness/permutation tables; a backend may
    # reclaim that device memory for round 3's quotient-domain working set
    if cx.release is not None:
        cx.release(mb.ckt)
    mb.alpha = mb.transcript.get_and_append_challenge(b"alpha")
    alpha_sq_div_n = mb.alpha * mb.alpha % R_MOD * fr_inv(n % R_MOD) % R_MOD
    pi_coeffs = be.ifft_h(
        cx.domain, be.lift(mb.pub + [0] * (n - len(mb.pub))))
    head = (n, m, cx.quot_domain, cx.pk.vk.k, mb.beta, mb.gamma, mb.alpha,
            alpha_sq_div_n)
    n_coset_polys = len(cx.sel_h) + 2 * nw + 2
    work = {"flops": ntt_flops(m, n_coset_polys),
            "data_bytes": n_coset_polys * m * 32}
    quot_evals = None
    if cx.stream_poly is not None:
        # the coset iNTT runs inside: its NTT counts in the work model
        with _work_span(cx, mb, "quotient_stream_fused", m=m,
                        polys=n_coset_polys,
                        flops=ntt_flops(m, n_coset_polys + 1),
                        data_bytes=n_coset_polys * m * 32):
            quotient_poly = cx.stream_poly(*head, cx.sel_h, cx.sigma_h,
                                           mb.wire_polys,
                                           mb.permutation_poly, pi_coeffs)
    elif cx.stream is not None:
        with _work_span(cx, mb, "quotient_stream", m=m, polys=n_coset_polys,
                        **work):
            quot_evals = cx.stream(*head, cx.sel_h, cx.sigma_h,
                                   mb.wire_polys, mb.permutation_poly,
                                   pi_coeffs)
    else:
        with _work_span(cx, mb, "coset_ffts", polys=n_coset_polys, **work):
            # the 25 coset-FFTs go out as one batch (one device launch;
            # concurrent across the workers in dispatcher2.rs:382-423)
            batch = be.coset_fft_many(
                cx.quot_domain,
                list(cx.sel_h) + list(cx.sigma_h) + mb.wire_polys
                + [mb.permutation_poly, pi_coeffs])
        ns = len(cx.sel_h)
        with mb.tr.span("quotient_evals"):
            quot_evals = be.quotient(
                *head, batch[:ns], batch[ns:ns + nw],
                batch[ns + nw:ns + 2 * nw], batch[ns + 2 * nw],
                batch[ns + 2 * nw + 1])
        del batch
    if quot_evals is not None:
        with _work_span(cx, mb, "coset_ifft_quot", flops=ntt_flops(m),
                        data_bytes=m * 32):
            quotient_poly = be.coset_ifft_h(cx.quot_domain, quot_evals)

    expected_degree = nw * (n + 1) + 2
    assert be.degree_is(quotient_poly, expected_degree), expected_degree
    # split into num_wire_types chunks of n+2 coefficients
    # (reference src/dispatcher2.rs:511-525)
    mb.split_quot_polys = be.split(quotient_poly, n + 2, nw,
                                   expected_degree + 1)
    return mb.split_quot_polys


def _finalize_r3(cx, mb, comms):
    mb.split_quot_poly_comms = list(comms)
    mb.transcript.append_commitments(b"quot_poly_comms",
                                     mb.split_quot_poly_comms)
    if mb.checkpoint is not None:
        mb.ck_arrays.update({"split_quot_poly_%d" % i: h
                             for i, h in enumerate(mb.split_quot_polys)})
        mb.ck_meta["alpha"] = hex(mb.alpha)
        mb.ck_meta["split_quot_poly_comms"] = [
            _point_enc(p) for p in mb.split_quot_poly_comms]
    _save_member(cx, mb, 3)


def _restore_r3(cx, mb, ck_state):
    # the round-3 snapshot was taken AFTER the quot-comms transcript
    # absorb, so restoring it must not absorb them again
    if cx.release is not None:
        cx.release(mb.ckt)
    mb.alpha = int(mb.ck_meta["alpha"], 16)
    mb.split_quot_polys = [_loadh(cx, ck_state, "split_quot_poly_%d" % i)
                           for i in range(cx.nw)]
    mb.split_quot_poly_comms = _points(mb.ck_meta["split_quot_poly_comms"])
    mb.ck_arrays.update({"split_quot_poly_%d" % i: h
                         for i, h in enumerate(mb.split_quot_polys)})


def _work_r4(cx, mb):
    # --- Round 4: evaluations (reference src/dispatcher2.rs:542-561)
    mb.zeta = mb.transcript.get_and_append_challenge(b"zeta")
    # all 10 evaluations in one backend call (one device round-trip)
    return ([(w, mb.zeta) for w in mb.wire_polys]
            + [(s, mb.zeta) for s in cx.sigma_h[:cx.nw - 1]]
            + [(mb.permutation_poly, mb.zeta * cx.domain.group_gen % R_MOD)])


def _finalize_r4(cx, mb, evals):
    nw = cx.nw
    mb.wires_evals = evals[:nw]
    mb.wire_sigma_evals = evals[nw:2 * nw - 1]
    mb.perm_next_eval = evals[-1]
    mb.transcript.append_proof_evaluations(
        mb.wires_evals, mb.wire_sigma_evals, mb.perm_next_eval)
    if mb.checkpoint is not None:
        mb.ck_meta["zeta"] = hex(mb.zeta)
        mb.ck_meta["wires_evals"] = [hex(v) for v in mb.wires_evals]
        mb.ck_meta["wire_sigma_evals"] = [hex(v)
                                          for v in mb.wire_sigma_evals]
        mb.ck_meta["perm_next_eval"] = hex(mb.perm_next_eval)
    _save_member(cx, mb, 4)


def _restore_r4(cx, mb, ck_state):
    mb.zeta = int(mb.ck_meta["zeta"], 16)
    mb.wires_evals = [int(v, 16) for v in mb.ck_meta["wires_evals"]]
    mb.wire_sigma_evals = [int(v, 16)
                           for v in mb.ck_meta["wire_sigma_evals"]]
    mb.perm_next_eval = int(mb.ck_meta["perm_next_eval"], 16)


def _work_r5(cx, mb):
    # --- Round 5: linearization + openings (reference
    # src/dispatcher2.rs:563-692)
    be, n, nw = cx.backend, cx.n, cx.nw
    vanish_eval = (pow(mb.zeta, n, R_MOD) - 1) % R_MOD
    with mb.tr.span("lin_poly"):
        lin_poly = _linearization_poly(
            be, cx.pk, cx.sel_h, cx.sigma_h, n, mb.beta, mb.gamma,
            mb.alpha, mb.zeta, vanish_eval, mb.wires_evals,
            mb.wire_sigma_evals, mb.perm_next_eval, mb.permutation_poly,
            mb.split_quot_polys,
        )
    v = mb.transcript.get_and_append_challenge(b"v")
    # batched opening at zeta: lin + wires + first 4 sigmas, powers of v
    with mb.tr.span("batch_open"):
        polys = [lin_poly] + mb.wire_polys + cx.sigma_h[:nw - 1]
        coeffs = []
        c = 1
        for _ in polys:
            coeffs.append(c)
            c = c * v % R_MOD
        batch_poly = be.lin_comb_h(polys, coeffs)
        mb.witness_poly = be.synth_div_h(batch_poly, mb.zeta)
        mb.shifted_witness_poly = be.synth_div_h(
            mb.permutation_poly, mb.zeta * cx.domain.group_gen % R_MOD)
    return [mb.witness_poly, mb.shifted_witness_poly]


def _finalize_r5(cx, mb, comms):
    mb.opening_proof, mb.shifted_opening_proof = comms
    # a finished prove must not leave a snapshot behind: a later prove()
    # pointed at the same path would silently resume at round 5 and emit a
    # byte-identical proof with REUSED blinds instead of a fresh one
    if mb.checkpoint is not None:
        mb.checkpoint.clear()
    mb.proof = Proof(
        mb.wires_poly_comms, mb.prod_perm_poly_comm,
        mb.split_quot_poly_comms, mb.opening_proof,
        mb.shifted_opening_proof, mb.wires_evals, mb.wire_sigma_evals,
        mb.perm_next_eval,
    )


class _Stage:
    """One prover round as a pipeline stage: a work half (one member's
    math, returning what the round commits or evaluates), a launch half
    (the work half, then its dispatch: an unforced pending), a
    host-finalize half (absorbs the forced results into the member's
    transcript, persists the round checkpoint — the stage LATCH), and a
    restore half reproducing the resume path from a round-`no` snapshot
    (round 5 never snapshots, so it has none). `commit` names the round's
    commit span; None marks round 4, which evaluates instead."""

    __slots__ = ("no", "name", "work", "commit", "width", "finalize",
                 "restore")

    def __init__(self, no, work, commit, width, finalize, restore=None):
        self.no = no
        self.name = "round%d" % no
        self.work = work
        self.commit = commit
        self.width = width    # the committed handles hold n + width
        self.finalize = finalize
        self.restore = restore

    def launch(self, cx, mb):
        items = self.work(cx, mb)
        if self.commit is None:
            return _dispatch_evals(cx, mb, items)
        return _dispatch_commit(cx, mb, items, self.commit, self.width)


_STAGES = (
    _Stage(1, _work_r1, "commit_wires", 2, _finalize_r1, _restore_r1),
    _Stage(2, _work_r2, "commit_perm", 3, _finalize_r2, _restore_r2),
    _Stage(3, _work_r3, "commit_quot", 2, _finalize_r3, _restore_r3),
    _Stage(4, _work_r4, None, 0, _finalize_r4, _restore_r4),
    _Stage(5, _work_r5, "commit_open", 2, _finalize_r5),
)


def prove(rng, circuit, pk, backend, tracer=None, checkpoint=None):
    """Produce a TurboPlonk proof for a finalized, satisfied circuit.

    tracer: optional trace.Tracer; records per-round and per-kernel-batch
    wall-clock spans (the reference prints these ad hoc,
    reference src/dispatcher.rs:625-942).
    checkpoint: optional checkpoint.ProverCheckpoint; after each of rounds
    1-4 the inter-round state is persisted, and a prove interrupted at any
    point resumes from the last completed round, producing byte-identical
    output (the reference has no checkpointing).

    This is the sequential stage driver: each round's launch half runs
    under its round span and is forced immediately, so every span of a
    round nests in its roundN span."""
    cx = _ProveCtx(pk, backend)
    mb = _Member(0, rng, circuit, tracer, checkpoint)
    mb.transcript.append_vk_and_pub_input(pk.vk, mb.pub)

    # checkpoint/resume bookkeeping: `start` is the first UNFINISHED round;
    # completed rounds restore their outputs from the snapshot instead of
    # recomputing, and the transcript sponge + blinder RNG rewind to the
    # snapshot point so the challenge schedule continues bit-for-bit
    start = 0
    ck_state = None
    if checkpoint is not None:
        mb.fp = workload_fingerprint(pk.vk, mb.pub)
        ck_state = checkpoint.load(mb.fp)
        if ck_state is not None:
            start = ck_state["round"]
            checkpoint.restore_into(ck_state, mb.rng, mb.transcript)

    for st in _STAGES:
        if st.no <= start:
            st.restore(cx, mb, ck_state)
        else:
            with mb.tr.span(st.name):
                values = st.launch(cx, mb).force()
                _flush_work(mb)
            st.finalize(cx, mb, values)
    return mb.proof


def _admit(i, rng, ckt, pk, backend, tracer, checkpoint, abort_on, proofs,
           errors):
    """A new member of a batched or pipelined prove, its transcript opened;
    None when it needs no further driving. A member that already has a
    snapshot resumes through the sequential prover up front (its restore
    path is the pinned contract) and never enters the batch; loading the
    (absent) snapshot of a fresh member is its round-0 control point, as in
    prove(). A member-local failure lands in `errors`; `abort_on` types
    propagate."""
    mb = _Member(i, rng, ckt, tracer, checkpoint)
    try:
        if mb.checkpoint is not None and \
                getattr(mb.checkpoint, "has_snapshot", lambda: False)():
            proofs[i] = prove(mb.rng, mb.ckt, pk, backend, tracer=mb.tr,
                              checkpoint=mb.checkpoint)
            return None
        mb.transcript.append_vk_and_pub_input(pk.vk, mb.pub)
        if mb.checkpoint is not None:
            mb.fp = workload_fingerprint(pk.vk, mb.pub)
            mb.checkpoint.load(mb.fp)
    except abort_on:
        raise
    except Exception as e:
        errors[i] = e
        return None
    return mb


def prove_many(rngs, circuits, pk, backend, tracers=None, checkpoints=None,
               abort_on=()):
    """N same-shape TurboPlonk proofs in LOCKSTEP: each round runs every
    member's work half, then commits (rounds 1-3, 5) or evaluates (round 4)
    the handles of ALL members in one backend call (`commit_many_h`,
    `eval_many_h`) instead of N. Each job's proof bytes stay IDENTICAL to
    a sequential `prove`, because per-job state (transcript sponge,
    blinding rng, challenges) never crosses members and every batched
    call computes each member's slice independently (MSM results are
    exact group elements; batch width only moves launch boundaries).

    rngs/circuits/tracers/checkpoints: parallel per-member lists (tracers
    and checkpoints optional). All circuits must share `pk`'s shape.

    Failure isolation: a member whose round-boundary control point raises
    (worker kill, timeout — anything the checkpoint guard fires) is
    dropped from the batch with its exception recorded, and the
    SURVIVORS finish unaffected; the dead member's snapshot is durable,
    so its retry resumes alone through the sequential path. Exception
    types in `abort_on` (e.g. a drain) propagate instead, aborting the
    whole batch. Members that already HAVE a snapshot are routed to the
    sequential prover up front — resume semantics stay the single-job
    contract.

    Returns (proofs, errors): per-member Proof-or-None and
    exception-or-None lists."""
    N = len(circuits)
    rngs = list(rngs)
    tracers = list(tracers) if tracers is not None else [None] * N
    checkpoints = (list(checkpoints) if checkpoints is not None
                   else [None] * N)
    abort_on = tuple(abort_on)
    cx = _ProveCtx(pk, backend)
    proofs = [None] * N
    errors = [None] * N
    live = [mb for mb in (
        _admit(i, rngs[i], circuits[i], pk, backend, tracers[i],
               checkpoints[i], abort_on, proofs, errors) for i in range(N))
        if mb is not None]

    def each_live(fn):
        """{member index: fn(member)} over the live members; a raising
        member is failed and dropped (abort_on propagates — the whole
        batch stops)."""
        nonlocal live
        kept, out = [], {}
        for mb in live:
            try:
                out[mb.i] = fn(mb)
            except abort_on:
                raise
            except Exception as e:  # member-local failure, batch survives
                errors[mb.i] = e
                continue
            kept.append(mb)
        live = kept
        return out

    for st in _STAGES:
        p0 = time.perf_counter()
        items = each_live(lambda mb: st.work(cx, mb))
        flat = [x for mb in live for x in items[mb.i]]
        if not flat:
            break
        out = (backend.eval_many_h(flat) if st.commit is None
               else backend.commit_many_h(cx.ck, flat))
        results, j = {}, 0
        for mb in live:
            results[mb.i] = out[j:j + len(items[mb.i])]
            j += len(items[mb.i])
            _flush_work(mb)
        each_live(lambda mb: st.finalize(cx, mb, results[mb.i]))
        # every member's timeline shows the batch round it rode in (the
        # launches are shared, so the span IS each job's wall time)
        for mb in live:
            mb.tr.add_event(st.name, time.perf_counter() - p0)
    for mb in live:
        proofs[mb.i] = mb.proof
    return proofs, errors


class PipelinedProver:
    """Round-pipelined driver: up to `depth` members in flight, each at
    its own stage. Launch halves run on a single-worker executor — THE
    device queue, which preserves per-member launch order and mirrors how
    an accelerator serializes dispatched work — while the driver thread
    runs host-finalize halves (transcript hashing, challenge derivation,
    checkpoint encode and write). A member's device results are forced
    only at its OWN finalize, so a younger member's launches keep the
    device queue full while an older member's host work runs: the round
    barrier of the lockstep path becomes a per-member stage latch.

    Byte-identity argument: each member's mutation happens either in its
    launch half (executor thread) or its finalize half (driver thread),
    and the driver never submits stage k+1 before finalize k returned —
    per-member op order is EXACTLY the sequential prover's, and no state
    crosses members. Pipelining changes only the interleaving between
    members, which no per-member state observes.

    observer: optional callable; called once per completed stage with
    {round, depth, stage_wait_s, force_wait_s, finalize_s,
    host_finalize_s}: the wait for the launch half, the force of its
    pending, the whole finalize half, and the finalize's host work after
    the force (transcript absorb and checkpoint save).

    On the card every launch goes to the calling thread's current stream:
    the executor thread's is the default stream, shared by all members, so
    the device runs their work in enqueue order. Host synchronisations in
    a launch half (a scalar inverse, a degree check) stall that thread and
    narrow the overlap; they never change bytes."""

    def __init__(self, backend, depth=None, abort_on=(), observer=None):
        if getattr(backend, "issues_collectives", False):
            # its executor thread and the finalizing thread would both
            # reach the collectives, in an order no other process follows
            raise ValueError("PipelinedProver: the backend's collectives "
                             "must be issued from one thread; use prove "
                             "or prove_many")
        self.backend = backend
        self.depth = max(1, int(depth if depth is not None
                                else PIPELINE_DEPTH))
        self.abort_on = tuple(abort_on)
        self.observer = observer
        self._ctxs = {}

    def _ctx(self, pk):
        # per-pk stage context, cached so coalesced mixed-shape members
        # of the same key reuse domains + device-side pk handles
        cx = self._ctxs.get(id(pk))
        if cx is None:
            cx = self._ctxs[id(pk)] = _ProveCtx(pk, self.backend)
        return cx

    def run(self, rngs, circuits, pks, tracers, checkpoints,
            proofs, errors):
        queue = deque()
        for i, ckt in enumerate(circuits):
            mb = _admit(i, rngs[i], ckt, pks[i], self.backend, tracers[i],
                        checkpoints[i], self.abort_on, proofs, errors)
            if mb is not None:
                mb.cx = self._ctx(pks[i])
                mb.stage = 0
                queue.append(mb)

        inflight = []  # admission order; [0] is the oldest member

        ex = ThreadPoolExecutor(max_workers=1)

        def submit(mb):
            st = _STAGES[mb.stage]

            def _launch():
                # the round span covers this member's launch half only;
                # its finalize half gets its own roundN_finalize span, and
                # forced device time lands on the kernels/* events — so a
                # pipelined trace never double-books overlapped wall time
                with mb.tr.span(st.name):
                    return st.launch(mb.cx, mb)
            mb._fut = ex.submit(_launch)

        try:
            while queue or inflight:
                while queue and len(inflight) < self.depth:
                    nxt = queue.popleft()
                    submit(nxt)
                    inflight.append(nxt)
                # finalize the oldest READY member (admission order breaks
                # ties): forcing only at a member's own finalize is the
                # pipeline — while this member's host work runs, the
                # executor keeps draining younger members' launches
                mb = next((m for m in inflight if m._fut.done()),
                          inflight[0])
                st = _STAGES[mb.stage]
                t0 = time.perf_counter()
                try:
                    pending = mb._fut.result()
                    t1 = time.perf_counter()
                    with mb.tr.span(st.name + "_finalize"):
                        values = pending.force()
                        _flush_work(mb)
                        t2 = time.perf_counter()
                        st.finalize(mb.cx, mb, values)
                except self.abort_on:
                    raise
                except Exception as e:
                    # member-local failure (kill/timeout at ITS latch):
                    # record, drop, and let the rest of the pipeline run
                    errors[mb.i] = e
                    inflight.remove(mb)
                    continue
                t3 = time.perf_counter()
                if self.observer is not None:
                    self.observer({
                        "round": st.no,
                        "depth": len(inflight),
                        "stage_wait_s": t1 - t0,
                        "force_wait_s": t2 - t1,
                        "finalize_s": t3 - t1,
                        "host_finalize_s": t3 - t2,
                    })
                mb.stage += 1
                if mb.stage >= len(_STAGES):
                    proofs[mb.i] = mb.proof
                    inflight.remove(mb)
                else:
                    submit(mb)
        finally:
            # abort (drain) or crash: cancel queued launches, wait out the
            # one in flight — members park at their own last-saved latch
            ex.shutdown(wait=True, cancel_futures=True)
        return proofs, errors


def prove_pipelined(rngs, circuits, pk, backend, tracers=None,
                    checkpoints=None, abort_on=(), depth=None,
                    observer=None):
    """N TurboPlonk proofs through the round PIPELINE (PipelinedProver):
    members need not share a shape — `pk` may be one key or a per-member
    list.

    Same failure contract as prove_many: member-local exceptions are
    recorded in `errors` and the survivors finish; `abort_on` types
    propagate and every in-flight member parks at its own next stage
    latch (its last saved round checkpoint). Members that already have a
    snapshot resume through sequential `prove` up front.

    Returns (proofs, errors) per-member lists."""
    N = len(circuits)
    rngs = list(rngs)
    tracers = list(tracers) if tracers is not None else [None] * N
    checkpoints = (list(checkpoints) if checkpoints is not None
                   else [None] * N)
    pks = list(pk) if isinstance(pk, (list, tuple)) else [pk] * N
    proofs = [None] * N
    errors = [None] * N
    drv = PipelinedProver(backend, depth=depth, abort_on=abort_on,
                          observer=observer)
    return drv.run(rngs, circuits, pks, tracers, checkpoints,
                   proofs, errors)


def _linearization_poly(backend, pk, sel_h, sigma_h, n, beta, gamma, alpha,
                        zeta, vanish_eval, wires_evals, wire_sigma_evals,
                        perm_next_eval, permutation_poly, split_quot_polys):
    """lin_poly assembly (reference src/dispatcher2.rs:565-633): all scalar
    coefficients computed on host, one backend linear combination."""
    a, b, c, d, e = wires_evals
    ab = a * b % R_MOD
    cd = c * d % R_MOD

    polys = []
    coeffs = []

    def term(h, cf):
        polys.append(h)
        coeffs.append(cf % R_MOD)

    term(sel_h[Q_LC], a)
    term(sel_h[Q_LC + 1], b)
    term(sel_h[Q_LC + 2], c)
    term(sel_h[Q_LC + 3], d)
    term(sel_h[Q_MUL], ab)
    term(sel_h[Q_MUL + 1], cd)
    term(sel_h[Q_HASH], pow(a, 5, R_MOD))
    term(sel_h[Q_HASH + 1], pow(b, 5, R_MOD))
    term(sel_h[Q_HASH + 2], pow(c, 5, R_MOD))
    term(sel_h[Q_HASH + 3], pow(d, 5, R_MOD))
    term(sel_h[Q_ECC], ab * cd % R_MOD * e % R_MOD)
    term(sel_h[Q_O], -e)
    term(sel_h[Q_C], 1)

    lagrange_1_eval = vanish_eval * fr_inv(
        n % R_MOD * ((zeta - 1) % R_MOD) % R_MOD) % R_MOD
    coeff_z = alpha
    for w_eval, ki in zip(wires_evals, pk.vk.k):
        coeff_z = coeff_z * ((w_eval + beta * ki % R_MOD * zeta + gamma) % R_MOD) % R_MOD
    coeff_z = (coeff_z + alpha * alpha % R_MOD * lagrange_1_eval) % R_MOD
    term(permutation_poly, coeff_z)

    coeff_sigma = alpha * beta % R_MOD * perm_next_eval % R_MOD
    for w_eval, s_eval in zip(wires_evals[:NUM_WIRE_TYPES - 1], wire_sigma_evals):
        coeff_sigma = coeff_sigma * ((w_eval + beta * s_eval + gamma) % R_MOD) % R_MOD
    term(sigma_h[NUM_WIRE_TYPES - 1], -coeff_sigma)

    zeta_np2 = (vanish_eval + 1) * zeta % R_MOD * zeta % R_MOD
    cf = (-vanish_eval) % R_MOD
    for poly in split_quot_polys:
        term(poly, cf)
        cf = cf * zeta_np2 % R_MOD

    return backend.lin_comb_h(polys, coeffs)
