"""The paper's headline comparison in one run: a 25-device medium-scale
simulation, resource-aware against static, Galaxy, EdgeShard, greedy and
round-robin (the Fig. 3/4 regime), printing each policy's latency, memory
and migrations over 300 tokens.  Counterpart of the JAX package's
``examples/migration_demo.py``: the same block graph, network, seeds and
table, from the port's numpy ``core``.

  PYTHONPATH=src python -m repro_torch.launch.migration_demo

It simulates devices and runs no model, so it needs no GPU.
"""
from __future__ import annotations

from repro_torch.core import ALL_POLICIES, DeviceNetwork, simulate
from repro_torch.core.blocks import CostModel, make_blocks
from repro_torch.core.network import GB

POLICIES = ("resource-aware", "static", "galaxy", "edgeshard", "greedy",
            "round-robin")


def main(argv=None):
    blocks = make_blocks(32)
    cost = CostModel(d_model=2048, n_heads=32, L0=64, n_layers=32,
                     compute_mode="incremental")
    net = DeviceNetwork.sample(25, seed=7, mem_range=(1 * GB, 3 * GB))
    n_tokens = 300

    print(f"{'policy':16s} {'total[s]':>9s} {'last-step[s]':>12s} "
          f"{'max-dev-mem[GB]':>15s} {'migrations':>10s}")
    results = {}
    for name in POLICIES:
        kw = dict(deadline=0.2) if name in ("resource-aware", "static") \
            else {}
        pol = ALL_POLICIES[name](blocks, cost, **kw)
        res = simulate(pol, blocks, cost, net, n_tokens, seed=11)
        results[name] = res
        print(f"{name:16s} {res.total_latency:9.1f} "
              f"{res.per_step_latency[-1]:12.4f} "
              f"{res.mem_max_series[-1]/2**30:15.2f} {res.migrations:10d}")

    ra = results["resource-aware"].total_latency
    print("\nspeedups vs resource-aware:")
    for name, res in results.items():
        if name != "resource-aware":
            print(f"  {name:14s} {res.total_latency / ra:5.2f}x slower")
    return results


if __name__ == "__main__":
    main()
