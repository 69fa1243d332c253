"""Calibration-plan artifacts: persist and load kernel plans (a copy of
the JAX package's store/calibration.py).

The store side of backend/autotune.py: a `KernelPlan` (the measured
winning kernel parameters for one card) lives in the content-addressed
artifact store under `autotune:<machine_fingerprint>`, so it

  - survives restarts like bucket keys (a second start against a
    calibrated store reaches its first proof with zero measurement runs),
  - warm-syncs to joining fleet workers over the STORE_LIST plane like
    any other artifact (store/remote.WARM_SYNC_PREFIXES includes
    `autotune:`), and
  - stays per card: a store shared across machines holds one plan per
    fingerprint, and a fingerprint miss means "calibrate (or default)",
    never "apply another card's winners".

`load_or_run` is the one start-up entry point (ProofService.start, the
fleet worker, scripts/torch_autotune.py), by `mode`:

    off    touch nothing: no store reads, no counters, no plan; every
           kernel path runs its built-in constants
    load   (default) adopt the store's plan for this fingerprint if one
           exists; otherwise run with the built-in constants (the
           existence probe uses store.meta, which counts nothing)
    run    load, and on a miss calibrate (within `budget_s`), persist the
           plan, then adopt it

Calibration runs under a store-level fcntl lock (`calibration.lock`, the
manifest lock's mechanism) so concurrent starters against one store
measure once: the others block, then load the winner's plan. It builds
no kernels of its own: the nvcc libraries are built once per process
(backend/_build.py) and the candidates only change launch arguments.
"""

import os
import time

from ..backend import autotune
from .artifacts import _FileLock

PLAN_PREFIX = "autotune:"
MODES = ("off", "load", "run")


def plan_store_key(fingerprint):
    return PLAN_PREFIX + fingerprint


def calibration_lock(store):
    """Cross-process advisory lock for calibration runs on `store`."""
    return _FileLock(os.path.join(store.root, "calibration.lock"))


def store_plan(store, plan, metrics=None):
    """Persist `plan` as the content-addressed artifact for its
    fingerprint; returns the digest. Canonical JSON, so an unchanged plan
    re-stores to the identical blob and digest."""
    digest = store.put(
        plan_store_key(plan.fingerprint), plan.to_json_bytes(),
        meta={"kind": "autotune_plan", "fingerprint": plan.fingerprint,
              "cells": len(plan.cells)})
    if metrics is not None:
        metrics.inc("autotune_plan_stores")
    return digest


def load_plan(store, fingerprint):
    """The store's plan for `fingerprint`, or None: on a plain miss, an
    unparseable blob, or a plan whose embedded fingerprint disagrees with
    the requested one (a foreign or hand-copied artifact triggers a
    rebuild, never another card's winners). The existence probe is
    store.meta (counter-free), so a plan-less start changes no metrics."""
    key = plan_store_key(fingerprint)
    if store.meta(key) is None:
        return None
    blob = store.get(key)
    if blob is None:
        return None
    plan = autotune.KernelPlan.from_json_bytes(blob)
    if plan is None or plan.fingerprint != fingerprint:
        return None
    return plan


def parse_shapes(spec):
    """'2^10,2^14,16384' -> sorted domain sizes."""
    out = set()
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "^" in part:
            base, _, exp = part.partition("^")
            out.add(int(base) ** int(exp))
        else:
            out.add(int(part))
    return sorted(out)


def _default_shapes(store):
    """Shapes to calibrate at when the caller has none: the domain sizes
    of the store's shape buckets (a warmed store describes its own
    workload), else the reference's v1 size, 2^13."""
    sizes = set()
    for key in store.keys():
        if not key.startswith("bucket:"):
            continue
        meta = store.meta(key)
        if meta and isinstance(meta.get("domain_size"), int):
            sizes.add(meta["domain_size"])
    return sorted(sizes) or [1 << 13]


def load_or_run(store, mode="load", shapes=None, budget_s=None,
                metrics=None, device=None):
    """Start-up plan pickup (see the module docstring) for the card
    `device` (None: the card; "cpu" the host). Returns a report:
    {source: off|none|store|fresh, fingerprint, cells, measure_runs,
    run_s?}; on store/fresh the plan is installed as the process-wide
    parameter source (backend/autotune.set_active_plan)."""
    mode = str(mode).strip().lower()
    if mode not in MODES:
        raise ValueError(f"autotune mode must be off|load|run, got {mode!r}")
    if mode == "off":
        return {"source": "off"}
    fp = autotune.machine_fingerprint(device)
    plan = load_plan(store, fp)
    if plan is not None:
        autotune.set_active_plan(plan)
        if metrics is not None:
            metrics.inc("autotune_plan_loads")
            _publish(metrics, "store", plan)
        return {"source": "store", "fingerprint": fp,
                "cells": len(plan.cells), "measure_runs": 0}
    if mode != "run":
        return {"source": "none", "fingerprint": fp, "measure_runs": 0}
    t0 = time.monotonic()
    with calibration_lock(store):
        # a concurrent starter may have calibrated while we waited on the
        # lock: measure once per store, everyone else loads
        plan = load_plan(store, fp)
        source = "store"
        measure_runs = 0
        if plan is None:
            tuner = autotune.Autotuner(shapes or _default_shapes(store),
                                       budget_s=budget_s, metrics=metrics,
                                       device=device)
            plan = tuner.run()
            store_plan(store, plan, metrics=metrics)
            source = "fresh"
            measure_runs = sum(
                c.get("candidates", 0) + c.get("parity_rejects", 0)
                + c.get("errors", 0) for c in plan.cells.values())
    autotune.set_active_plan(plan)
    if metrics is not None:
        if source == "store":
            metrics.inc("autotune_plan_loads")
        _publish(metrics, source, plan)
    return {"source": source, "fingerprint": fp, "cells": len(plan.cells),
            "measure_runs": measure_runs,
            "run_s": round(time.monotonic() - t0, 3)}


def _publish(metrics, source, plan):
    metrics.gauge("autotune_plan_source", source)
    metrics.gauge("autotune_plan_cells", len(plan.cells))
    metrics.gauge("autotune_plan_revision", autotune.plan_revision())
