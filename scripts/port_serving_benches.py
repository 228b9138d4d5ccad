#!/usr/bin/env python3
"""Run the JAX package's serving-load and elastic-serving benches on the
port and hold each row against its committed baseline.

    PYTHONPATH=src python3 scripts/port_serving_benches.py --device cpu
    python3 scripts/port_serving_benches.py --device cuda     # on a GPU

``benchmarks/serving_load.py`` and ``benchmarks/elastic_serving.py`` import
``repro.{configs,core,serving}``; this script maps those packages and their
modules onto ``repro_torch`` before importing them, so the benches' own
code builds the port's ``ServingEngine`` (on ``--device``, passed to every
engine they build), drives it with the port's ``drive_virtual`` and
``AsyncServingEngine``, and plans and simulates with the port's ``core``.
Every row of ``benchmarks/baselines/BENCH_{serving_load,elastic_serving}
.json`` is recomputed and its ``derived`` string must equal the
baseline's: the latency percentiles are virtual-clock numbers (one
scheduler step is one time unit), so they depend on the schedule, not on
the weights, which are random from the engines' seed.  ``us_per_call`` is
host wall time and is not compared.  Exits non-zero on any difference,
and if JAX was imported.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCHES = {"serving_load": "BENCH_serving_load.json",
           "elastic_serving": "BENCH_elastic_serving.json"}
CORE = ("algorithm", "baselines", "blocks", "delay", "network",
        "placement_bridge", "scoring", "simulator", "solver")


def alias_port(device: str):
    """Make ``import repro.{configs,core,serving,runtime}[.<module>]``
    return the port's modules; the engines of ``repro.serving.engine`` run
    on ``device`` (an engine given another device raises)."""
    pkg = types.ModuleType("repro")
    pkg.__path__ = []
    sys.modules["repro"] = pkg
    for sub, mods in (("configs", ()), ("core", CORE),
                      ("runtime", ("fault_tolerance",)),
                      ("serving", ("paging", "workload"))):
        sys.modules[f"repro.{sub}"] = importlib.import_module(
            f"repro_torch.{sub}")
        for name in mods:
            sys.modules[f"repro.{sub}.{name}"] = importlib.import_module(
                f"repro_torch.{sub}.{name}")
    engine = importlib.import_module("repro_torch.serving.engine")
    shim = types.ModuleType("repro.serving.engine")
    shim.__dict__.update(engine.__dict__)

    def on(cls):
        class OnDevice(cls):
            def __init__(self, cfg, **kw):
                if kw.setdefault("device", device) != device:
                    raise ValueError(f"engine asked for {kw['device']} in "
                                     f"a --device {device} run")
                super().__init__(cfg, **kw)
        OnDevice.__name__ = OnDevice.__qualname__ = cls.__name__
        return OnDevice

    shim.ServingEngine = on(engine.ServingEngine)
    shim.WaveServingEngine = on(engine.WaveServingEngine)
    sys.modules["repro.serving.engine"] = shim
    # the runtime's type check is the port's ServingEngine: the shim's
    # subclass passes it
    sys.modules["repro.serving.async_runtime"] = importlib.import_module(
        "repro_torch.serving.async_runtime")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", required=True, choices=("cpu", "cuda"),
                    help="where every engine the benches build runs")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    alias_port(args.device)
    bad = 0
    for bench, baseline in BENCHES.items():
        want = {r["name"]: r["derived"] for r in json.loads(
            (ROOT / "benchmarks" / "baselines" / baseline).read_text())}
        t0 = time.monotonic()
        got = {name: (us, derived) for name, us, derived in
               importlib.import_module(f"benchmarks.{bench}").rows()}
        for name in want:
            us, derived = got.get(name, (None, None))
            ok = derived == want[name]
            bad += not ok
            print(f"{'ok  ' if ok else 'DIFF'} {name}: {derived}"
                  + (f" ({us:.0f} us a call)" if us is not None else "")
                  + ("" if ok else f" (baseline {want[name]})"), flush=True)
        print(f"{bench}: {time.monotonic() - t0:.1f} s on {args.device}",
              flush=True)
    if any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules):
        print("JAX was imported")
        return 1
    print(f"{bad} row(s) differ from their baselines")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
