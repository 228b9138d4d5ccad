"""CLI of the port's hot-path auditor — counterpart of the JAX package's
``python -m repro.analysis``.

    PYTHONPATH=src python -m repro_torch.analysis [pass ...] [options]

Passes (default: all three):
    lint    the port's RPR0xx AST lints (no device, no torch import)
    trace   the dispatch-trace audit of the hot functions (JXP0xx)
    step    the step audit: caches in place, no cache copies, the prefill
            shape ladder and the committed budgets (HLO0xx)

Options:
    --paths P [P ...]     lint roots (default: the port's own files —
                          src/repro_torch, chip_smoke.py, tests/test_torch_*.py,
                          tests/torch_*.py, scripts/port_*.py)
    --update-baselines    refresh src/repro_torch/analysis/baselines.json
                          from a run on --device, then exit 0
    --json                machine-readable findings on stdout
    --device {cuda,cpu}   where the trace and step passes build the audit
                          model (default: cuda, the card)

Exit status: 0 when clean, 1 on any unwaived finding.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

PASSES = ("lint", "trace", "step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Hot-path auditor of the port: dispatch-trace and step "
                    "audits of the decode loop + repo-invariant lints")
    # no argparse `choices`: its empty-default validation rejects the
    # zero-arg (run everything) form on some 3.x versions
    ap.add_argument("passes", nargs="*", metavar="{lint,trace,step}",
                    help="subset of passes to run (default: all)")
    ap.add_argument("--paths", nargs="+", default=None)
    ap.add_argument("--update-baselines", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    bad = set(args.passes) - set(PASSES)
    if bad:
        ap.error(f"unknown pass(es) {sorted(bad)} — choose from {PASSES}")
    passes = tuple(args.passes) or PASSES

    if args.update_baselines:
        from repro_torch.analysis.step_audit import (BASELINES_PATH,
                                                     update_baselines)
        vals = update_baselines(device=args.device)
        print(f"[analysis] wrote {BASELINES_PATH}:")
        for section, numbers in vals.items():
            for k, v in sorted(numbers.items()):
                print(f"    {section}.{k} = {v:g}")
        return 0

    findings = []
    for name in PASSES:           # fixed order: cheap/standalone first
        if name not in passes:
            continue
        t0 = time.monotonic()
        if name == "lint":
            from repro_torch.analysis.lints import lint_paths
            found = lint_paths(args.paths)
        elif name == "trace":
            from repro_torch.analysis.trace_audit import audit_hot_functions
            found = audit_hot_functions(device=args.device)
        else:
            from repro_torch.analysis.step_audit import audit_step
            found = audit_step(device=args.device)
        dt = time.monotonic() - t0
        if not args.as_json:
            state = "clean" if not found else f"{len(found)} finding(s)"
            print(f"[analysis] {name}: {state} ({dt:.1f}s)")
        findings.extend(found)

    if args.as_json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f"  {f}")
        if findings:
            print(f"[analysis] FAILED: {len(findings)} unwaived finding(s)"
                  " — fix, or waive inline with `# rpr: ignore[CODE] -- "
                  "reason` (lints) / refresh budgets (step)")
        else:
            print("[analysis] hot path audits clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
