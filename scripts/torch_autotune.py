#!/usr/bin/env python3
"""Calibrate an artifact store's kernel plan offline for the PyTorch port
(the counterpart of scripts/autotune.py): measure the port's kernel
parameters (kernel 2's pass split and tile, kernel 3's chunk) at the
given circuit sizes on this card, persist the winning plan under
`autotune:<fingerprint>`, and print one JSON report line. A store
calibrated here serves with the plan from its first proof: the port's
ProofService and fleet workers started with that store load it at start.

    python3 scripts/torch_autotune.py --store-dir DIR [--shapes 2^13]
        [--budget-s 120] [--force] [--report] [--device cuda|cpu]

With no --shapes, calibrates at the domain sizes of the store's shape
buckets, else 2^13 (the reference's v1 workload). Each size n gives two
cells: the NTT at the prover's quotient domain (8n) and the MSM at n.
--force remeasures even when the store holds a plan for this card; the
default loads one if present. Without --device the card is used (and the
script fails without one). Exit 0 iff a plan is active at the end.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--store-dir", required=True,
                    help="artifact store to calibrate (created if missing)")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated circuit sizes, 2^k accepted")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="wall-clock budget of the measure pass "
                         "(default 120)")
    ap.add_argument("--force", action="store_true",
                    help="remeasure even if the store holds this card's "
                         "plan")
    ap.add_argument("--report", action="store_true",
                    help="include the per-cell plan in the output")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    from distributed_plonk_tpu_torch.backend import autotune
    from distributed_plonk_tpu_torch.store import ArtifactStore, calibration

    t0 = time.time()
    store = ArtifactStore(args.store_dir)
    shapes = calibration.parse_shapes(args.shapes) if args.shapes else None
    if args.force:
        tuner = autotune.Autotuner(
            shapes or calibration._default_shapes(store),
            budget_s=args.budget_s, device=args.device)
        with calibration.calibration_lock(store):
            plan = tuner.run()
            calibration.store_plan(store, plan)
        autotune.set_active_plan(plan)
        out = {"source": "fresh", "fingerprint": plan.fingerprint,
               "cells": len(plan.cells)}
    else:
        out = calibration.load_or_run(store, mode="run", shapes=shapes,
                                      budget_s=args.budget_s,
                                      device=args.device)
    plan = autotune.active_plan()
    out["ok"] = plan is not None
    out["wall_s"] = round(time.time() - t0, 3)
    if args.report and plan is not None:
        out["plan"] = {f"{k}:{n}": cell
                       for (k, n), cell in sorted(plan.cells.items())}
        out["meta"] = plan.meta
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
