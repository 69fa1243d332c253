"""Kernel autotuner and the plan that resolves the kernels' runtime
parameters (the port of the JAX package's backend/autotune.py).

The port's kernels take their tuning parameters at launch, so a plan
chooses them without a rebuild:

    ntt  max_log_rows (radix-2 stages per pass of kernel 2, 6..10) and
         tile_log_cols (neighbouring columns per block tile, 0..3):
         ntt_torch.get_plan's pass split and tile;
    msm  chunk (sorted points per bucket_sums thread of kernel 3):
         msm_torch.MsmContext's chunk.

Kernel 1 (mont_mul) has no runtime parameter, so there is no `field`
cell.

Resolution, at every site that reads a parameter (ntt_torch.plan_params,
msm_torch.resolve_chunk):

    explicit argument > active KernelPlan cell (the calibrated size
    nearest n) > the built-in constant

With no plan active every path is byte- and launch-identical to running
without this module. `set_active_plan` bumps a process-wide revision
(`plan_revision`, `cache_key`) for memos that cannot key on the resolved
values themselves.

The Autotuner measures, per (kind, size) cell, the candidate space at
the prover's real launch widths, reading each candidate back through the
resolvers (a candidate the kernels would run the same way is measured
once, and one the card cannot run, an NTT tile over the shared-memory
limit, is not measured), and adopts a winner only if it reproduces the
default configuration's output bit for bit (NTT: the output words; MSM:
the decoded affine commitments, which a different chunk must not change
even though it reorders the bucket adds). store/calibration.py keeps the
plan per card, under `autotune:<machine_fingerprint>`.
"""

import contextlib
import hashlib
import json
import platform
import random
import threading
import time

PLAN_VERSION = 1


def machine_fingerprint(device=None):
    """Stable 12-hex id of what a plan's measurements depend on. On a
    card: its name, compute capability and SM count, the CUDA version of
    torch, and the hash of the kernel sources (backend/_build.py's build
    key), so a rebuilt kernel recalibrates. On the CPU: the architecture
    and CPU feature flags. `device` None is the card."""
    import torch

    from . import _build
    from .field_torch import resolve_device
    device = resolve_device(device, "machine_fingerprint")
    if device.type == "cuda":
        p = torch.cuda.get_device_properties(device)
        ident = "cuda|%s|%d.%d|%d|%s|%s" % (
            p.name, p.major, p.minor, p.multi_processor_count,
            torch.version.cuda, _build.source_hash())
    else:
        cpu = ""
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    if line.startswith("flags"):
                        cpu = line
                        break
        except OSError:
            pass
        ident = "cpu|%s|%s" % (platform.machine(), cpu)
    return hashlib.sha256(ident.encode()).hexdigest()[:12]


def quotient_size(n):
    """The prover's quotient domain for circuit size n (prover._ProveCtx:
    (wires + 1)(n + 1) + 1 points, rounded up to a power of two)."""
    from ..circuit import NUM_WIRE_TYPES
    return 1 << ((NUM_WIRE_TYPES + 1) * (n + 1)).bit_length()


class KernelPlan:
    """A calibrated kernel configuration for one machine fingerprint.

    cells: {(kind, size): {"params": {...}, ...}}; params hold the
    winning values under the names the resolvers look up
    ("max_log_rows", "tile_log_cols", "chunk"). JSON serialization is
    canonical (sorted keys), so a plan round-trips through the
    content-addressed store byte for byte."""

    def __init__(self, fingerprint, cells=None, meta=None):
        self.fingerprint = fingerprint
        self.cells = {}
        for key, cell in (cells or {}).items():
            if not isinstance(key, tuple):
                kind, _, size = key.partition(":")
                key = (kind, int(size))
            cell = dict(cell)
            if "params" not in cell:
                cell = {"params": cell}
            self.cells[(key[0], int(key[1]))] = cell
        self.meta = dict(meta or {})

    def cell(self, kind, n):
        return self.cells.get((kind, int(n)))

    def lookup(self, kind, param, n=None):
        """Winning value of `param` for `kind` at the calibrated cell
        nearest to size `n` (log2 distance, ties to the larger cell);
        n=None picks the largest cell. None when uncalibrated."""
        sizes = [s for (k, s), c in self.cells.items()
                 if k == kind and param in c.get("params", {})]
        if not sizes:
            return None
        if n is None:
            size = max(sizes)
        else:
            nb = max(int(n), 1).bit_length()
            size = min(sizes,
                       key=lambda s: (abs(max(s, 1).bit_length() - nb), -s))
        return self.cells[(kind, size)]["params"][param]

    def to_json_bytes(self):
        cells = {f"{k}:{s}": c for (k, s), c in self.cells.items()}
        return json.dumps(
            {"version": PLAN_VERSION, "fingerprint": self.fingerprint,
             "meta": self.meta, "cells": cells},
            sort_keys=True, indent=1).encode()

    @classmethod
    def from_json_bytes(cls, blob):
        """Parse a stored plan; None for a foreign or future version (the
        caller recalibrates rather than misparsing)."""
        try:
            d = json.loads(blob.decode())
        except (ValueError, UnicodeDecodeError):
            return None
        if not isinstance(d, dict) or d.get("version") != PLAN_VERSION:
            return None
        return cls(d.get("fingerprint", ""), d.get("cells", {}),
                   d.get("meta", {}))


# --- the active plan (the process-wide parameter source) ---------------------

_plan_lock = threading.Lock()
_active_plan = None
_plan_revision = 0


def active_plan():
    return _active_plan


def plan_revision():
    """Monotonic counter bumped by every set_active_plan."""
    return _plan_revision


def set_active_plan(plan):
    """Install `plan` (a KernelPlan, or None: the built-in constants) as
    the process-wide parameter source. Returns the new revision."""
    global _active_plan, _plan_revision
    with _plan_lock:
        _active_plan = plan
        _plan_revision += 1
        return _plan_revision


def cache_key(*parts):
    """`parts` plus the current plan revision: the key of a memo whose
    entries depend on the plan in ways its other parts do not show."""
    return tuple(parts) + (_plan_revision,)


def plan_param(kind, param, n=None):
    """The active plan's winner for (kind, param) near size n, or None
    (no plan, or no such cell)."""
    p = _active_plan
    if p is None:
        return None
    return p.lookup(kind, param, n)


def resolve(value, kind, param, n, default):
    """One parameter: `value` when the caller gave one, else the active
    plan's int winner near n, else `default`. A malformed plan value
    never breaks a launch: it resolves to the default."""
    if value is not None:
        return value
    p = plan_param(kind, param, n)
    if p is None:
        return default
    try:
        return int(p)
    except (TypeError, ValueError):
        return default


@contextlib.contextmanager
def plan_override(cells, fingerprint="override"):
    """Temporarily install a plan built from `cells` ({(kind, n):
    params}): the Autotuner's way of applying a candidate. Restores the
    previous plan (and bumps the revision again) on exit."""
    prev = _active_plan
    set_active_plan(KernelPlan(fingerprint, dict(cells)))
    try:
        yield
    finally:
        set_active_plan(prev)


class _NullMetrics:
    def inc(self, name, by=1):
        pass

    def gauge(self, name, value):
        pass

    def observe(self, name, seconds):
        pass


# --- the autotuner -----------------------------------------------------------

class Autotuner:
    """Per-cell calibration (see the module docstring).

    shapes: circuit domain sizes n (powers of two). Each gives two cells:
    ("ntt", m) at the prover's quotient domain m, measured as one
    coset-forward launch of 8 polynomials and one of 25 (the streamed and
    one-shot round 3's widths), and ("msm", n), measured as one prove's
    commit batches (MSM_BATCHES handles) over n + 3 bases.

    budget_s bounds the whole run: once spent, remaining candidates and
    cells are skipped; a cell whose default configuration was not
    measured is left out (its size then resolves to the built-in
    constants), so a truncated run is safe, only less tuned.
    """

    NTT_ROWS = (6, 7, 8, 9, 10)
    NTT_TILES = (0, 1, 2, 3)
    NTT_WIDTHS = (8, 25)
    MSM_CHUNKS = (8, 16, 32, 64)
    MSM_BATCHES = (5, 1, 5, 2)    # rounds 1, 2, 3 and 5 of one prove
    BUDGET_S = 120.0
    REPS = 5                      # timed runs per part after one warm run

    def __init__(self, shapes, budget_s=None, metrics=None,
                 kinds=("ntt", "msm"), device=None, seed=0xD7):
        from .field_torch import resolve_device
        self.shapes = sorted({int(s) for s in shapes})
        self.budget_s = float(self.BUDGET_S if budget_s is None
                              else budget_s)
        self.metrics = metrics if metrics is not None else _NullMetrics()
        self.kinds = tuple(kinds)
        self.device = resolve_device(device, "Autotuner")
        self.seed = seed
        self._deadline = None
        self._data = {}

    def cells(self):
        """The (kind, size) cells of this run, in measuring order."""
        return [(kind, quotient_size(n) if kind == "ntt" else n)
                for n in self.shapes for kind in self.kinds]

    def run(self):
        """Measure every cell within budget; returns the KernelPlan."""
        t0 = time.monotonic()
        self._deadline = t0 + self.budget_s
        self.metrics.inc("autotune_runs")
        plan = KernelPlan(machine_fingerprint(self.device))
        for kind, size in self.cells():
            cell = self._tune_cell(kind, size)
            if cell is not None:
                plan.cells[(kind, size)] = cell
                self.metrics.inc("autotune_cells")
        plan.meta = {
            "created": round(time.time(), 3),
            "budget_s": self.budget_s,
            "run_s": round(time.monotonic() - t0, 3),
            "shapes": self.shapes,
            "device": self._device_name(),
        }
        self.metrics.observe("autotune_run_s", time.monotonic() - t0)
        return plan

    def _device_name(self):
        if self.device.type != "cuda":
            return "cpu"
        import torch
        return torch.cuda.get_device_name(self.device)

    # -- cell machinery -------------------------------------------------------

    def _out_of_budget(self):
        return self._deadline is not None \
            and time.monotonic() > self._deadline

    def _tune_cell(self, kind, n):
        """Measure one (kind, n) cell: the default configuration first
        (its output is the bit-identity reference), then the deduped
        candidates. Returns the cell record, or None (the budget ran out
        before the default, or the default failed)."""
        if self._out_of_budget():
            return None
        seen = set()
        measured = []  # (seconds, sig, resolved params, aux)
        ref = None
        rejects = errors = 0
        for cand in [{}] + self._candidates(kind, n):
            if ref is not None and self._out_of_budget():
                break
            resolved, sig = self._resolved(kind, n, cand)
            if sig is None or sig in seen:
                continue
            seen.add(sig)
            try:
                with plan_override({(kind, n): cand}):
                    out, dt, aux = self._run_candidate(kind, n, cand)
            except Exception:  # noqa: BLE001 - a candidate that cannot
                # run is skipped, never fatal to the pass
                errors += 1
                self.metrics.inc("autotune_candidate_errors")
                if ref is None:
                    # the default itself failed: without a reference no
                    # winner can be gated, so the cell keeps the defaults
                    return None
                continue
            self.metrics.inc("autotune_measure_runs")
            if ref is None:
                ref = out          # the default configuration's output
            elif out != ref:
                rejects += 1
                self.metrics.inc("autotune_parity_rejects")
                continue
            measured.append((dt, sig, resolved, aux))
        default_s, default_aux = measured[0][0], measured[0][3]
        best_s, _sig, params, aux = min(measured, key=lambda m: m[0])
        cell = {"params": dict(params),
                "best_s": round(best_s, 6),
                "default_s": round(default_s, 6),
                "speedup_vs_default": round(default_s / best_s, 3)
                if best_s > 0 else None,
                "candidates": len(measured),
                "parity_rejects": rejects,
                "errors": errors}
        if aux:
            cell["best_parts_s"] = aux
            cell["default_parts_s"] = default_aux
        # every candidate that passed the gate, as measured: what the plan
        # is worth on this card, and each part's own best
        cell["measured"] = [{"params": p, "s": round(dt, 6), "parts": a}
                            for dt, _sig, p, a in measured]
        return cell

    def _run_candidate(self, kind, n, cand):
        """Measure ONE candidate (already applied as the active plan by
        the caller): (output bytes, seconds per run, {part: seconds})."""
        if kind == "ntt":
            return self._run_ntt(n)
        return self._run_msm(n)

    def _sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def _timed(self, fn):
        """Warm once, then time REPS calls (one when a call takes over a
        second, so calibration keeps to its budget), ending in a
        synchronize: the mean seconds of one call."""
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        warm_s = time.perf_counter() - t0
        reps = 1 if warm_s > 1.0 else self.REPS
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        self._sync()
        return out, (time.perf_counter() - t0) / reps

    # -- candidate grids ------------------------------------------------------

    def _candidates(self, kind, n):
        if kind == "ntt":
            return [{"max_log_rows": r, "tile_log_cols": t}
                    for r in self.NTT_ROWS for t in self.NTT_TILES]
        return [{"chunk": c} for c in self.MSM_CHUNKS]

    def _resolved(self, kind, n, cand):
        """(params, signature) of the candidate read BACK through the
        resolvers with the candidate applied as the plan: what would run.
        The NTT signature is its pass geometry, so splits the plan builds
        alike are measured once; a geometry over the card's shared memory
        gives (params, None) and is not measured."""
        with plan_override({(kind, n): cand}):
            if kind == "ntt":
                from . import ntt_torch as N
                rows, tile = N.plan_params(n)
                shapes = tuple(N.pass_shapes(n, rows, tile))
                if max(N.pass_smem_bytes(r, c) for r, c in shapes) \
                        > N.SMEM_MAX:
                    return {"max_log_rows": rows,
                            "tile_log_cols": tile}, None
                return {"max_log_rows": rows,
                        "tile_log_cols": tile}, ("ntt",) + shapes
            from . import msm_torch as M
            chunk = M.resolve_chunk(None, self._msm_points(n))
            return {"chunk": chunk}, ("msm", chunk)

    # -- per-kind measurement -------------------------------------------------

    @staticmethod
    def _msm_points(n):
        """The bases of the measured MSM context: n + 3 (the prover's
        widest blinded handle)."""
        return n + 3

    def _fr_handles(self, width, count, seed_off):
        """`count` (8, width) Montgomery handles of seeded random Fr
        values on the device."""
        from ..constants import R_MOD
        from .limbs import lift
        rng = random.Random(self.seed + seed_off)
        vals = [rng.randrange(R_MOD) for _ in range(width * count)]
        h = lift(vals, self.device)
        return [h[:, i * width:(i + 1) * width] for i in range(count)]

    def _run_ntt(self, m):
        import torch

        from . import ntt_torch as N
        key = ("ntt", m)
        if key not in self._data:
            hs = self._fr_handles(m, max(self.NTT_WIDTHS), 1)
            self._data[key] = [torch.stack(hs[:w], dim=1).contiguous()
                               for w in self.NTT_WIDTHS]
        batches = self._data[key]
        plan = N.get_plan(m, self.device)
        parts, outs = {}, []
        for v in batches:
            out, dt = self._timed(
                lambda v=v: N.ntt(plan, v, inverse=False, coset=True))
            parts["x%d" % v.shape[1]] = round(dt, 6)
            outs.append(out.cpu().numpy().tobytes())
        return b"".join(outs), sum(parts.values()), parts

    def _run_msm(self, n):
        from ..constants import G1_GEN_X, G1_GEN_Y
        from . import msm_torch as M
        key = ("msm", n)
        if key not in self._data:
            # one window-shifted key, shared by every candidate; the
            # handles are a prove's widths (n + 2, the permutation's n + 3)
            base = M.MsmContext([(G1_GEN_X, G1_GEN_Y)]
                                * self._msm_points(n), self.device)
            handles = [self._fr_handles(n + 2 + (b == 1), b, 1 + i)
                       for i, b in enumerate(self.MSM_BATCHES)]
            self._data[key] = (base, handles)
        base, handles = self._data[key]
        ctx = base.at_chunk(M.resolve_chunk(None, base.n))
        parts, outs = {}, []
        for i, hs in enumerate(handles):
            pts, dt = self._timed(
                lambda hs=hs: ctx.msm_mont_limbs_many(hs))
            parts["b%d_%d" % (i, len(hs))] = round(dt, 6)
            outs.append(repr(pts).encode())
        return b"".join(outs), sum(parts.values()), parts
