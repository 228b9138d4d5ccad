"""The simulator rows of ``benchmarks/baselines/BENCH_elastic_serving.json``
from the port alone: the planning layers' churn on the paper's layered
topology (an 8-layer, 8-head block graph on 8 edge devices), simulated
for 60 tokens with the resource-aware policy — churn-free, a failure of
device 6 at τ 20 (every later placement must stay feasible), and a strong
device joining at τ 20.  Kept apart from ``tests/test_torch_elastic.py``
because the three simulations take about a minute of host time."""
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import ALL_POLICIES, simulate
from repro_torch.core.blocks import CostModel, graph_of, make_blocks
from repro_torch.core.network import GBPS, DeviceNetwork
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "baselines" / "BENCH_elastic_serving.json"
TOKENS, TAU = 60, 20

def _layered():
    """``benchmarks.paper_setup``'s layered blocks, cost and network
    (seed 0, horizon τ 110), built from the port's core."""
    blocks = make_blocks(8, 8)
    cost = CostModel(d_model=2048, n_heads=8, L0=64, n_layers=8,
                     compute_mode="incremental", layer_mode="graph")
    layer_mem = sum(cost.memory(b, TOKENS + 50)
                    for b in graph_of(blocks).layer_blocks(0))
    net = DeviceNetwork.sample(8, seed=0,
                               mem_range=(1.0 * layer_mem, 1.5 * layer_mem),
                               bw_range=(0.05 * GBPS, 2 * GBPS),
                               compute_range=(20e9, 120e9))
    return blocks, cost, net


def _strong_join(net):
    net.join(float(net.mem_capacity.max()), float(net.compute_max.max()),
             np.full(net.n_devices, float(np.median(
                 net.bandwidth[np.isfinite(net.bandwidth)]))))


@pytest.fixture(scope="module")
def sims():
    out = {}
    for name, events in (("churnfree", None),
                         ("fail", [(TAU, lambda net: net.fail(6))]),
                         ("join", [(TAU, _strong_join)])):
        blocks, cost, net = _layered()
        pol = ALL_POLICIES["resource-aware"](blocks, cost, deadline=0.5)
        out[name] = simulate(pol, blocks, cost, net, TOKENS, seed=100,
                             events=events)
    return out


@pytest.mark.parametrize("name", ["churnfree", "fail", "join"])
def test_elastic_sim_rows_reproduce_baseline(sims, name):
    want = {r["name"]: r["derived"]
            for r in json.loads(BASELINE.read_text())}
    res = sims[name]
    derived = f"tok_s={TOKENS / res.total_latency:.4f}"
    if name != "churnfree":
        ratio = res.total_latency / sims["churnfree"].total_latency
        derived += f";lat_vs_churnfree={ratio:.4f}"
    if name == "fail":
        assert not any(s.infeasible for s in res.steps[TAU:])
    assert derived == want[f"elastic/sim_{name}"]
