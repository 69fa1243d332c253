"""CLI: `python -m distributed_plonk_tpu_torch.analysis [--strict] [...]`.

Exit status 0 iff every selected pass is clean. Passes:

  lint       AST hazard lints over the port's package
  contracts  field_torch.CARRY_CONTRACTS for Fr and Fq
  bounds     interval propagation over every registry entry's aten graph
  values     exact evaluation of every entry's value contract on the
             host, then (with a card) every entry that has a kernel held
             to its contract on the card, main-path shapes included

Lint, contracts, bounds and the exact values run on the host. The card
half runs with the default device ("cuda"), which raises without a card;
`--device cpu` is the host half alone, as the tests run it.

`--changed-only` skips the registry families whose modules are unchanged
since the last fully clean run (state in .analysis_torch_state.json at
the repo root, by the modules' mtimes; the card half also keys on
csrc/*.cu and csrc/*.cuh). Lints always run.
"""

import argparse
import glob
import json
import os
import sys
import time

_REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", ".."))
_PKG = os.path.join(_REPO, "distributed_plonk_tpu_torch")
_STATE_FILE = os.path.join(_REPO, ".analysis_torch_state.json")

# registry-entry name prefix -> package-relative modules whose change
# invalidates that family (what its entries trace through). Files in
# _GLOBAL_DEPS invalidate every family: the analyzers themselves, the
# constants, the oracles the contracts compare against.
_ENTRY_MODULES = {
    "field/": ("backend/field_torch.py",),
    "ntt/": ("backend/ntt_torch.py", "backend/field_torch.py", "poly.py",
             "fields.py"),
    "msm/": ("backend/msm_torch.py", "backend/field_torch.py",
             "backend/curve_torch.py"),
    "curve/": ("backend/curve_torch.py", "backend/field_torch.py"),
    "eval/": ("backend/prover_torch.py", "backend/field_torch.py"),
    "r3/": ("backend/prover_torch.py", "backend/field_torch.py"),
}
_GLOBAL_DEPS = ("constants.py", "backend/limbs.py", "analysis/bounds.py",
                "analysis/values.py", "analysis/registry.py")
# the card half's kernels: any change re-runs every family's card pass
_CUDA_SOURCES = ("csrc/*.cu", "csrc/*.cuh")


def _dep_mtimes(card):
    files = set(_GLOBAL_DEPS)
    for deps in _ENTRY_MODULES.values():
        files |= set(deps)
    if card:
        for pat in _CUDA_SOURCES:
            files |= {os.path.relpath(p, _PKG)
                      for p in glob.glob(os.path.join(_PKG, pat))}
    out = {}
    for rel in sorted(files):
        p = os.path.join(_PKG, rel)
        if os.path.exists(p):
            out[rel] = os.stat(p).st_mtime
    return out


def _changed_scope(card):
    """(names filter, contracts needed, mtimes) for --changed-only: None =
    every entry; [] = nothing changed; else the changed prefixes."""
    mtimes = _dep_mtimes(card)
    try:
        with open(_STATE_FILE) as f:
            old = json.load(f)
    except (OSError, ValueError):
        return None, True, mtimes       # no clean baseline: run all
    changed = {rel for rel, t in mtimes.items() if old.get(rel) != t}
    if changed & (set(_GLOBAL_DEPS) | {r for r in changed
                                       if r.startswith("csrc/")}):
        return None, True, mtimes
    names = [pfx for pfx, deps in sorted(_ENTRY_MODULES.items())
             if changed & set(deps)]
    return names, "backend/field_torch.py" in changed, mtimes


def main(argv=None, summary=None):
    """Run the selected passes; returns the exit status. `summary`, a dict,
    receives each pass's counts: lint (findings), contracts (checked,
    violated), bounds (checked, violations), values_<device> (checked,
    violations), failures, seconds."""
    summary = {} if summary is None else summary
    ap = argparse.ArgumentParser(
        prog="python -m distributed_plonk_tpu_torch.analysis",
        description="the port's static verifier: aten-graph interval "
                    "bounds, exact value contracts (and the kernels' on "
                    "the card), carry contracts, AST hazard lints")
    ap.add_argument("--strict", action="store_true",
                    help="treat unhandled aten ops as violations")
    ap.add_argument("--only",
                    choices=("bounds", "values", "lint", "contracts"),
                    help="run a single pass (default: all)")
    ap.add_argument("--kernel", action="append",
                    help="substring filter on registry entry names "
                         "(repeatable; bounds and values)")
    ap.add_argument("--changed-only", action="store_true",
                    help="skip registry families whose modules are "
                         "unchanged since the last clean run")
    ap.add_argument("--list", action="store_true",
                    help="list registry entries and exit")
    ap.add_argument("--device", default="cuda",
                    help="cpu: the host passes alone; cuda (default): "
                         "also the kernels on the card")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="only print failures and the summary line")
    args = ap.parse_args(argv)

    if args.changed_only and args.kernel:
        ap.error("--changed-only and --kernel are mutually exclusive")

    import torch
    card = torch.device(args.device).type == "cuda"
    if card and not torch.cuda.is_available():
        print("analysis: CUDA is not available (pass --device cpu for the "
              "host passes)", file=sys.stderr)
        return 2

    if args.list:
        from .registry import build_registry, card_entries
        for e in build_registry() + (card_entries() if card else []):
            print(e.name)
        return 0

    names = args.kernel
    contracts_wanted = True
    state = None
    if args.changed_only:
        names, contracts_wanted, state = _changed_scope(card)
        if not args.quiet:
            print("changed-only: %s" % ("nothing changed since the last "
                                        "clean run" if names == [] else
                                        "all" if names is None
                                        else " ".join(names)))

    failures = 0
    t0 = time.monotonic()

    if args.only in (None, "lint"):
        from .lint import run_lints
        findings = run_lints()
        for f in findings:
            print("LINT FAIL %s" % f)
        if not args.quiet:
            print("lint: %d finding(s)" % len(findings))
        failures += len(findings)
        summary["lint"] = len(findings)

    if args.only in (None, "contracts") and contracts_wanted:
        from .bounds import check_contracts
        from ..backend.field_torch import CARRY_CONTRACTS
        bad = check_contracts()
        for v in bad:
            print("CONTRACT FAIL %s" % v)
        if not args.quiet:
            print("contracts: %d checked for Fr+Fq, %d violated"
                  % (len(CARRY_CONTRACTS), len(bad)))
        failures += len(bad)
        summary["contracts"] = (2 * len(CARRY_CONTRACTS), len(bad))

    skip_registry = args.changed_only and names == []

    def reporter(tag, ok_suffix, counter):
        def progress(name, violations):
            counter[0] += 1
            if violations:
                print("%s FAIL %s: %d violation(s)" % (tag, name,
                                                       len(violations)))
                for v in violations:
                    print("  %s" % v)
            elif not args.quiet:
                print("ok %s%s" % (name, ok_suffix))
        return progress

    if args.only in (None, "bounds") and not skip_registry:
        from .registry import run_bounds
        n = [0]
        # under --only bounds the contracts run here and count: a violated
        # contract never prints CLEAN because of the pass selection
        violations, _ = run_bounds(
            strict=args.strict, names=names,
            progress=reporter("BOUNDS", "", n),
            contracts=args.only == "bounds" and contracts_wanted)
        for v in violations:
            if v.kernel.startswith("contract/"):
                print("CONTRACT FAIL %s" % v)
        if not args.quiet:
            print("bounds: %d kernel(s) checked, %d violation(s)"
                  % (n[0], len(violations)))
        failures += len(violations)
        summary["bounds"] = (n[0], len(violations))

    if args.only in (None, "values") and not skip_registry:
        from .registry import run_values
        for dev in ("cpu", args.device) if card else ("cpu",):
            n = [0]
            suffix = " (value)" if dev == "cpu" else " (value, %s)" % dev
            violations, _ = run_values(strict=args.strict, names=names,
                                       device=dev,
                                       progress=reporter("VALUE", suffix, n))
            if not args.quiet:
                print("values on %s: %d contract(s) checked, %d "
                      "violation(s)" % (dev, n[0], len(violations)))
            failures += len(violations)
            summary["values_" + dev] = (n[0], len(violations))

    dt = time.monotonic() - t0
    summary.update(failures=failures, seconds=dt)
    verdict = "CLEAN" if failures == 0 else "%d FAILURE(S)" % failures
    print("analysis: %s in %.1fs" % (verdict, dt))

    # refresh the baseline only after a fully clean run of every pass, so
    # nothing is ever skipped past a failure
    if args.changed_only and failures == 0 and args.only is None \
            and state is not None:
        try:
            with open(_STATE_FILE, "w") as f:
                json.dump(state, f, indent=0, sort_keys=True)
        except OSError:
            pass        # a read-only checkout stays cold
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
