"""The port's evaluation stack (``core.solver``, ``core.baselines``,
``core.simulator``, ``placement_bridge.stage_slot_partition``) against the
JAX package's numpy originals.

Both sides get the same block graph, cost model and seeded
``DeviceNetwork``; placements, solver values and simulator records must be
equal bit for bit (the port's modules are copies, so a float difference
means a copied function differs).  The last test reproduces the
``small_scale`` optimality-gap ratios of
``benchmarks/baselines/BENCH_small_scale.json`` from the port alone.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
import repro.core.placement_bridge as RB
import repro.core.simulator as RS
import repro.core.solver as RV
import repro_torch.core as T
import repro_torch.core.placement_bridge as TB
import repro_torch.core.simulator as TS
import repro_torch.core.solver as TV
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
GB = 2 ** 30


def _problem(pkg, n_heads, n_layers, n_devices, seed, **cost_kw):
    """(blocks, cost, net) of one package: a single-layer column graph or
    a per-layer block graph, and a seeded heterogeneous network."""
    kw = dict(d_model=2048, n_heads=n_heads, L0=64, n_layers=32,
              compute_mode="incremental")
    if n_layers > 1:
        kw.update(n_layers=n_layers, layer_mode="graph")
    kw.update(cost_kw)
    blocks = pkg.make_blocks(n_heads, n_layers)
    cost = pkg.CostModel(**kw)
    net = pkg.DeviceNetwork.sample(n_devices, seed=seed,
                                   mem_range=(1 * GB, 4 * GB))
    return blocks, cost, net


def _pair(*args, **kw):
    return _problem(R, *args, **kw), _problem(T, *args, **kw)


def _eq(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------ exact solvers
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("objective", ["delay", "bottleneck"])
def test_exact_myopic_equals_reference(objective, k):
    """4 heads + proj + ffn over 3 devices (729 placements), τ 1..3 with
    the previous optimum carried: equal placements and values."""
    (rb, rc, rn), (tb, tc, tn) = _pair(4, 1, 3, seed=3)
    rprev = tprev = None
    for tau in range(1, 4):
        rp, rv = RV.exact_myopic(rb, rc, rn, tau, rprev, pipeline_k=k,
                                 objective=objective)
        tp, tv = TV.exact_myopic(tb, tc, tn, tau, tprev, pipeline_k=k,
                                 objective=objective)
        assert _eq(rp, tp) and rv == tv, (tau, rp, tp, rv, tv)
        assert tp is not None
        rprev, tprev = rp, tp
        rn.step_background_load()
        tn.step_background_load()


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("objective", ["delay", "bottleneck"])
def test_exact_horizon_equals_reference(objective, k):
    """2 heads + proj + ffn over 3 devices, a 3-interval horizon of
    fluctuating snapshots: equal paths and totals."""
    (rb, rc, rn), (tb, tc, tn) = _pair(2, 1, 3, seed=5)
    rnets, tnets = [], []
    for _ in range(3):
        rnets.append(rn.copy())
        tnets.append(tn.copy())
        rn.step_background_load()
        tn.step_background_load()
    rpath, rtot = RV.exact_horizon(rb, rc, rnets, pipeline_k=k,
                                   objective=objective)
    tpath, ttot = TV.exact_horizon(tb, tc, tnets, pipeline_k=k,
                                   objective=objective)
    assert len(tpath) == len(rpath) == 3
    assert all(_eq(a, b) for a, b in zip(rpath, tpath))
    assert rtot == ttot


def test_solver_limits_and_objectives_raise_as_the_reference():
    assert (TV.MAX_MYOPIC_PLACEMENTS, TV.MAX_HORIZON_STATES,
            TV.OBJECTIVES) == (RV.MAX_MYOPIC_PLACEMENTS,
                               RV.MAX_HORIZON_STATES, RV.OBJECTIVES)
    (rb, rc, rn), (tb, tc, tn) = _pair(32, 1, 4, seed=0)
    calls = [
        lambda m, b, c, n: m.exact_myopic(b, c, n, 1),
        lambda m, b, c, n: m.exact_horizon(b, c, [n]),
        lambda m, b, c, n: m.exact_myopic(b[:2], c, n, 1, objective="x"),
    ]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(RV, rb, rc, rn)
        with pytest.raises(ValueError) as got:
            call(TV, tb, tc, tn)
        assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- policies
def _policy_kw(name):
    return dict(deadline=0.2) if name in ("resource-aware", "static",
                                          "bottleneck-aware",
                                          "lookahead") else {}


_CASES = [(name, n_layers, 1) for n_layers in (1, 2)
          for name in sorted(R.ALL_POLICIES)]
_CASES += [(name, n_layers, 2) for n_layers in (1, 2)
           for name in ("resource-aware", "bottleneck-aware")]


@pytest.mark.parametrize("name,n_layers,k", _CASES,
                         ids=[f"{n}-L{l}-k{k}" for n, l, k in _CASES])
def test_policy_placements_equal_reference(name, n_layers, k):
    """Each policy places over τ 1..6 of a fluctuating 4-device network,
    with a 50x straggler from τ 4: equal placements every interval."""
    assert sorted(T.ALL_POLICIES) == sorted(R.ALL_POLICIES)
    (rb, rc, rn), (tb, tc, tn) = _pair(4, n_layers, 4, seed=9)
    kw = _policy_kw(name)
    if k > 1:
        kw["pipeline_k"] = k
    rpol = R.ALL_POLICIES[name](rb, rc, **kw)
    tpol = T.ALL_POLICIES[name](tb, tc, **kw)
    assert tpol.name == rpol.name == name
    rprev = tprev = None
    for tau in range(1, 7):
        if tau == 4:
            rn.inject_straggler(1, slowdown=50.0)
            tn.inject_straggler(1, slowdown=50.0)
        rp = rpol.place(rn, tau, rprev)
        tp = tpol.place(tn, tau, tprev)
        assert _eq(rp, tp), (tau, rp, tp)
        rprev, tprev = rp, tp
        rn.step_background_load()
        tn.step_background_load()
    if name == "bottleneck-aware" and k > 1:
        assert (tpol.chain_reseeds, tpol.chain_reseed_skips) == \
            (rpol.chain_reseeds, rpol.chain_reseed_skips)


def test_search_modes_and_validation_equal_reference():
    assert T.ResourceAwarePolicy.SEARCH_MODES == \
        R.ResourceAwarePolicy.SEARCH_MODES
    (rb, rc, _), (tb, tc, _) = _pair(4, 1, 4, seed=0)
    with pytest.raises(ValueError) as want:
        R.ResourceAwarePolicy(rb, rc, search="nope")
    with pytest.raises(ValueError) as got:
        T.ResourceAwarePolicy(tb, tc, search="nope")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- simulator
_SIM = [("resource-aware", 1), ("bottleneck-aware", 2), ("edgeshard", 1),
        ("galaxy", 1), ("edgeshard", 2), ("galaxy", 2), ("lookahead", 2),
        ("dynamic-layer", 1)]


@pytest.mark.parametrize("name,n_layers", _SIM,
                         ids=[f"{n}-L{l}" for n, l in _SIM])
def test_simulate_records_equal_reference(name, n_layers):
    """``simulate`` with fluctuation, a seed, pipeline_k=2 and a device
    failure at τ 3: every StepRecord field equal (inf included)."""
    (rb, rc, rn), (tb, tc, tn) = _pair(4, n_layers, 5, seed=4)
    kw = _policy_kw(name)
    if name in ("resource-aware", "bottleneck-aware", "lookahead"):
        kw["pipeline_k"] = 2
    runs = []
    for pkg, sim, (b, c, n) in ((R, RS, (rb, rc, rn)), (T, TS, (tb, tc, tn))):
        pol = pkg.ALL_POLICIES[name](b, c, **kw)
        runs.append(sim.simulate(pol, b, c, n, 8, fluctuate=True, seed=11,
                                 pipeline_k=2,
                                 events=[(3, lambda net: net.fail(2))]))
    ref, got = runs
    assert got.policy == ref.policy
    assert [dataclasses.asdict(s) for s in got.steps] == \
        [dataclasses.asdict(s) for s in ref.steps]
    assert got.total_latency == ref.total_latency
    assert got.migrations == ref.migrations
    # the static layer pipelines keep a stage on the failed device (their
    # latency goes infinite, as the reference's); the others replace it
    if name not in ("edgeshard", "galaxy"):
        assert np.isfinite(got.total_latency)


def test_compare_policies_and_overload_stall_equal_reference():
    (rb, rc, rn), (tb, tc, tn) = _pair(4, 1, 3, seed=2)
    names = ("greedy", "round-robin", "static")
    rres = R.compare_policies(
        {n: R.ALL_POLICIES[n](rb, rc, **_policy_kw(n)) for n in names},
        rb, rc, rn, 5, seed=1)
    tres = T.compare_policies(
        {n: T.ALL_POLICIES[n](tb, tc, **_policy_kw(n)) for n in names},
        tb, tc, tn, 5, seed=1)
    for n in names:
        assert [dataclasses.asdict(s) for s in tres[n].steps] == \
            [dataclasses.asdict(s) for s in rres[n].steps]
    place = np.zeros(len(rb), dtype=int)
    assert TS.overload_stall(place, tb, tc, tn, 200) == \
        RS.overload_stall(place, rb, rc, rn, 200)


# ------------------------------------------------------------------- bridge
@pytest.mark.parametrize("n_slots", [2, 4])
def test_stage_slot_partition_equals_reference(n_slots):
    (rb, rc, rn), (tb, tc, tn) = _pair(4, 3, 8, seed=0)
    pol = R.ALL_POLICIES["edgeshard"](rb, rc)
    place = pol.place(rn, 1, None)
    rng = np.random.default_rng(n_slots)
    for p in (place, rng.integers(0, 8, size=len(rb))):
        want = RB.stage_slot_partition(p, rb, n_slots)
        got = TB.stage_slot_partition(p, tb, n_slots)
        assert got == want and len(got) >= 1


# ----------------------------------------------- small-scale claim (§V.C)
def test_small_scale_ratios_match_the_reference_baseline():
    """The port alone reproduces ``BENCH_small_scale.json``'s five
    ``ratio_to_exact`` values to three decimals: the exact myopic optimum
    against each policy over the benchmark's six (devices, seed)
    scenarios and 4 tokens."""
    import benchmarks.paper_setup as ps
    import benchmarks.small_scale as ss
    from repro_torch.core.network import GB as TGB
    want = {row["name"].split("/", 1)[1]: row["derived"].split("=", 1)[1]
            for row in json.loads((REPO / "benchmarks" / "baselines"
                                   / "BENCH_small_scale.json").read_text())}
    assert sorted(want) == sorted(ss.POLICIES)
    blocks = T.make_blocks(4)
    cost = T.CostModel(d_model=ps.D, n_heads=4, L0=ps.L0,
                       n_layers=ps.N_LAYERS, compute_mode="incremental")
    ratios = {p: [] for p in ss.POLICIES}
    for nd, seed in ss.SCENARIOS:
        net = T.DeviceNetwork.sample(nd, seed=seed,
                                     mem_range=(1 * TGB, 4 * TGB))
        prev, tot_e = None, 0.0
        for tau in range(1, ss.N_TOKENS + 1):
            prev, ve = T.exact_myopic(blocks, cost, net, tau, prev)
            tot_e += ve
        for name in ss.POLICIES:
            kw = dict(deadline=ps.DEADLINE) \
                if name in ("resource-aware", "static") else {}
            pol = T.ALL_POLICIES[name](blocks, cost, **kw)
            prev, tot = None, 0.0
            for tau in range(1, ss.N_TOKENS + 1):
                p = pol.place(net, tau, prev)
                tot += T.total_delay(prev, p, blocks, cost, net, tau)
                tot += TS.overload_stall(p, blocks, cost, net, tau)
                prev = p
            ratios[name].append(tot / tot_e)
    got = {n: f"{float(np.mean(r)):.3f}" for n, r in ratios.items()}
    assert got == want


def test_single_shot_bottleneck_search_matches_the_reference_baseline():
    """The port alone reproduces ``BENCH_pipeline_search.json``'s
    ``single_shot_K8`` row: D_pipe(8) of the τ = 1 placement of the
    bottleneck search against the rescoring policy's, on the layered
    topology (8 layers of 8 heads, 8 devices, 0.05-2 Gbps links)."""
    import benchmarks.paper_setup as ps
    import benchmarks.pipeline_search as bench
    from repro_torch.core.delay import pipelined_inference_delay
    rows = json.loads((REPO / "benchmarks" / "baselines"
                       / "BENCH_pipeline_search.json").read_text())
    want = next(r["derived"] for r in rows
                if r["name"] == "pipeline_search/single_shot_K8")
    k = bench.K_HEADLINE
    blocks = T.make_blocks(ps.LAYERED_H, ps.LAYERED_L)
    cost = T.CostModel(d_model=ps.D, n_heads=ps.LAYERED_H, L0=ps.L0,
                       n_layers=ps.LAYERED_L, compute_mode="incremental",
                       layer_mode="graph")
    layer_mem = sum(cost.memory(b, bench.N_TOKENS + 50)
                    for b in T.graph_of(blocks).layer_blocks(0))
    d_pipe = {}
    for name in ("resource-aware", "bottleneck-aware"):
        net = T.DeviceNetwork.sample(
            8, seed=0, mem_range=(1.0 * layer_mem, 1.5 * layer_mem),
            bw_range=(0.05 * T.GBPS, 2 * T.GBPS),
            compute_range=(20e9, 120e9))
        pol = T.ALL_POLICIES[name](blocks, cost,
                                   deadline=ps.LAYERED_DEADLINE,
                                   pipeline_k=k)
        place = pol.place(net, 1, None)
        d_pipe[name] = pipelined_inference_delay(place, blocks, cost, net,
                                                 1, k=k)
    base, bn = d_pipe["resource-aware"], d_pipe["bottleneck-aware"]
    assert f"x_dpipe={base / bn:.3f};dpipe_ms={bn * 1e3:.3f}" == want
