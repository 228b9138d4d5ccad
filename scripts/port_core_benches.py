#!/usr/bin/env python3
"""Run the JAX package's virtual-clock benches on the port's numpy core and
hold each row against its committed baseline.

    PYTHONPATH=src python3 scripts/port_core_benches.py     # ~4 min, CPU

``benchmarks/small_scale.py``, ``benchmarks/pipelined_decode.py`` and
``benchmarks/pipeline_search.py`` import ``repro.core``; this script maps
``repro.core`` and its modules onto ``repro_torch.core`` before importing
them, so the benches' own code places, solves and simulates with the
port's copies.  Every row of ``benchmarks/baselines/BENCH_{small_scale,
pipelined,pipeline_search}.json`` except the engine rows (which serve a
JAX model) is recomputed, and its ``derived`` string must equal the
baseline's; ``us_per_call`` is host wall time and is not compared.  Exits
non-zero on any difference, and if JAX was imported.
"""
from __future__ import annotations

import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCHES = {"small_scale": "BENCH_small_scale.json",
           "pipelined_decode": "BENCH_pipelined.json",
           "pipeline_search": "BENCH_pipeline_search.json"}
CORE = ("algorithm", "baselines", "blocks", "delay", "network",
        "placement_bridge", "scoring", "simulator", "solver")


def alias_core():
    """Make ``import repro.core[.<module>]`` return the port's modules."""
    import importlib
    import repro_torch.core as core
    pkg = types.ModuleType("repro")
    pkg.__path__ = []
    sys.modules["repro"] = pkg
    sys.modules["repro.core"] = core
    for name in CORE:
        sys.modules[f"repro.core.{name}"] = importlib.import_module(
            f"repro_torch.core.{name}")


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    alias_core()
    import importlib
    bad = 0
    for bench, baseline in BENCHES.items():
        want = {r["name"]: r["derived"] for r in json.loads(
            (ROOT / "benchmarks" / "baselines" / baseline).read_text())
            if "engine" not in r["name"]}
        rows = importlib.import_module(f"benchmarks.{bench}").rows()
        seen = set()
        # the generators compute the engine rows last: stop before them
        while seen != set(want):
            name, _us, derived = next(rows)
            if name not in want:
                continue
            seen.add(name)
            ok = derived == want[name]
            bad += not ok
            print(f"{'ok  ' if ok else 'DIFF'} {name}: {derived}"
                  + ("" if ok else f" (baseline {want[name]})"), flush=True)
    if any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules):
        print("JAX was imported")
        return 1
    print(f"{bad} row(s) differ from their baselines")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
