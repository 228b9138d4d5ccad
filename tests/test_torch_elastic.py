"""Elastic device churn in the port — the counterparts of the JAX package's
``tests/test_elastic.py``, held against the reference.

- The network's fail/slow/rejoin/join transitions and errors.
- ``IntervalController.handle_failure``/``handle_rejoin`` give the
  reference's placement, per-layer permutations, delay estimates and
  history on the same network; an evacuation the survivors cannot hold
  raises.
- ``ServingEngine.fail_device`` (evacuation + teacher-forced replay),
  fail then ``rejoin_device``, and ``slow_device``, each mid-decode on a
  dense, paged, pipelined paged (K 2) and int8 engine (reduced
  musicgen-large, MHA, the reference's weights, greedy, on the CPU):
  streams equal the churn-free run's and the reference's churn run's, and
  the recovery and migration logs equal the reference's entry for entry.
- The async watchdog's hang escalation, ``drive_virtual``'s events and
  model pricing, and ``apply_to_cache`` against the reference.
- The port alone reproduces the five engine rows of
  ``benchmarks/baselines/BENCH_elastic_serving.json`` (the simulator rows
  are in ``tests/test_torch_elastic_sim.py``).
"""
import dataclasses
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.blocks import CostModel as JaxCost
from repro.core.controller import ControllerConfig as JaxCtlCfg
from repro.core.controller import IntervalController as JaxController
from repro.core.network import DeviceNetwork as JaxNetwork
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.blocks import CostModel, graph_of, make_blocks
from repro_torch.core.controller import ControllerConfig, IntervalController
from repro_torch.core.network import GBPS, DeviceNetwork
from repro_torch.serving.async_runtime import AsyncServingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.workload import (TimedRequest, VirtualClock,
                                          drive_virtual, make_workload,
                                          offered_load)
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "baselines" / "BENCH_elastic_serving.json"

def _port_cfg(cfg_j):
    return get_config(cfg_j.name).with_overrides(**dataclasses.asdict(cfg_j))


# ---------------------------------------------------------------- network
def test_network_churn_transitions_and_errors():
    net = DeviceNetwork.sample(4, seed=0)
    net.fail(2)
    assert not net.is_active(2) and net.n_active == 3
    assert 2 not in net.active_ids
    assert net.compute_avail[2] == 0.0
    assert net.mem_usable()[2] == 0.0
    net.slow(2, 4.0)                         # a dead device stays dead
    assert net.compute_avail[2] == 0.0
    net.slow(1, 4.0)
    assert net.compute_avail[1] == pytest.approx(net.compute_max[1] / 4.0)
    with pytest.raises(ValueError):
        net.slow(1, 0.5)
    net.rejoin(2)                            # fresh, full capacity
    assert net.is_active(2)
    assert net.compute_avail[2] == net.compute_max[2]
    j = net.join(1e9, 2e9, np.full(4, 1e8))
    assert j == 4 and net.n_devices == 5 and net.is_active(4)
    assert np.all(net.bandwidth[4, :4] == net.bandwidth[:4, 4])
    assert np.isinf(net.bandwidth[4, 4])
    with pytest.raises(ValueError):
        net.join(1e9, 2e9, np.full(3, 1e8))
    with pytest.raises(ValueError):
        net.join(-1.0, 2e9, np.full(5, 1e8))
    net.fail(1)
    net.step_background_load()
    assert net.compute_avail[1] == 0.0


# ------------------------------------------------------------- controller
def _controllers(n_heads=8, hps=2, lam=16, net_kw=None):
    """The port's and the reference's controller on equal networks."""
    kw = dict(d_model=256, n_heads=n_heads, L0=8, lam=lam, n_layers=2,
              layer_mode="graph", compute_mode="incremental")
    nets = (DeviceNetwork.sample(4, seed=1), JaxNetwork.sample(4, seed=1)) \
        if net_kw is None else (DeviceNetwork(**net_kw()),
                                JaxNetwork(**net_kw()))
    return (IntervalController(n_heads, CostModel(**kw), nets[0],
                               ControllerConfig(lam=lam, heads_per_slot=hps)),
            JaxController(n_heads, JaxCost(**kw), nets[1],
                          JaxCtlCfg(lam=lam, heads_per_slot=hps)))


def _same_plan(a, b):
    for k in ("tau", "place", "perms", "prev_perms", "perm", "prev_perm"):
        if b[k] is None:
            assert a[k] is None, k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("migrations", "d_mig_est", "d_pipe_est", "infeasible",
              "evacuation", "failed_device", "expansion", "rejoined_device"):
        assert a.get(k) == b.get(k), k


def test_handle_failure_and_rejoin_equal_reference():
    ours, ref = _controllers()
    _same_plan(ours.step_interval(), ref.step_interval())
    dev = int(ours.head_counts().argmax())
    assert dev == int(ref.head_counts().argmax())
    plan = ours.handle_failure(dev)
    _same_plan(plan, ref.handle_failure(dev))
    assert plan["evacuation"] and plan["failed_device"] == dev
    assert not np.any(np.asarray(plan["place"]) == dev)
    assert ours.history[-1]["evacuation"] is True
    assert ours.head_counts()[dev] == 0
    np.testing.assert_array_equal(ours.head_counts(plan["place"]),
                                  ref.head_counts(plan["place"]))
    # a later interval still never places on the dead device
    plan2 = ours.step_interval()
    _same_plan(plan2, ref.step_interval())
    assert not np.any(np.asarray(plan2["place"]) == dev)
    plan3 = ours.handle_rejoin(dev)
    _same_plan(plan3, ref.handle_rejoin(dev))
    assert plan3["expansion"] and plan3["rejoined_device"] == dev
    assert ours.net.is_active(dev)
    assert ours.history == ref.history
    np.testing.assert_array_equal(ours.perm, ref.perm)


def test_observe_and_monitor_match_reference():
    """``observe`` writes availability (an inactive device reads 0) and
    never the hardware memory capacity; ``observe_monitor`` defaults the
    peak to ``compute_max``."""
    from repro.runtime.fault_tolerance import HeartbeatMonitor as JaxMon
    from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
    ours, ref = _controllers()
    for ctl in (ours, ref):
        ctl.net.fail(3)
        cap = ctl.net.mem_capacity.copy()
        ctl.observe(compute_avail=np.full(4, 5e9), mem_avail=cap / 2)
        np.testing.assert_array_equal(ctl.net.mem_capacity, cap)
    np.testing.assert_array_equal(ours.net.compute_avail,
                                  ref.net.compute_avail)
    assert ours.net.compute_avail[3] == 0.0
    np.testing.assert_array_equal(ours.net.mem_avail, ref.net.mem_avail)
    for ctl, mon in ((ours, HeartbeatMonitor(4)), (ref, JaxMon(4))):
        for j, dt in enumerate((1.0, 1.0, 4.0, 1.0)):
            mon.record_step(j, dt)
        ctl.observe_monitor(mon)
    np.testing.assert_array_equal(ours.net.compute_avail,
                                  ref.net.compute_avail)


def test_handle_failure_infeasible_raises():
    """Survivors that cannot hold the dead device's blocks fail loudly."""
    def net_kw():
        return dict(mem_capacity=np.array([1e12, 10.0, 10.0]),
                    compute_max=np.full(3, 1e9),
                    compute_avail=np.full(3, 1e9),
                    bandwidth=np.where(np.eye(3, dtype=bool), np.inf, 1e9),
                    rng=np.random.default_rng(0))
    ours, _ = _controllers(n_heads=3, hps=1, net_kw=net_kw)
    ours.step_interval()
    assert np.all(np.asarray(ours.place) == 0)   # only device 0 fits
    with pytest.raises(RuntimeError, match="evacuation infeasible"):
        ours.handle_failure(0)


def test_apply_to_cache_equals_reference():
    """A graph-mode plan applied to a stacked cache equals the reference's
    gather, and the inverse plan restores the cache (the reference's
    ``tests/test_layered.py`` scenario), with the layer axis leading and
    moved."""
    H, L, V = 8, 3, 4
    kw = dict(d_model=512, n_heads=H, n_layers=L,
              compute_mode="incremental", layer_mode="graph")
    ctls = []
    for Net, Cost, Ctl, Cfg in ((DeviceNetwork, CostModel,
                                 IntervalController, ControllerConfig),
                                (JaxNetwork, JaxCost, JaxController,
                                 JaxCtlCfg)):
        net = Net.sample(V, seed=1)
        ctl = Ctl(H, Cost(**kw), net, Cfg(lam=4, heads_per_slot=2))
        ctl.step_interval()
        net.inject_straggler(int(ctl.head_counts().argmax()), slowdown=100.0)
        ctl.observe(compute_avail=net.compute_avail)
        ctls.append((ctl, ctl.step_interval()))
    (ours, plan), (ref, ref_plan) = ctls
    assert plan["migrations"] and plan["perms"].shape == (L, V * 2)
    _same_plan(plan, ref_plan)
    cache = np.arange(L * 2 * 5 * 8 * 4, dtype=np.float32).reshape(
        L, 2, 5, 8, 4)
    want, _ = ref.apply_to_cache(cache, cache, ref_plan)
    k2, v2 = ours.apply_to_cache(torch.as_tensor(cache),
                                 torch.as_tensor(cache), plan)
    np.testing.assert_array_equal(k2.numpy(), np.asarray(want))
    assert not np.array_equal(k2.numpy(), cache)
    inv = {"perms": plan["prev_perms"], "prev_perms": plan["perms"],
           "migrations": plan["migrations"]}
    k3, _ = ours.apply_to_cache(k2, v2, inv)
    np.testing.assert_array_equal(k3.numpy(), cache)
    # the same plan over a cache whose layer axis is not the first
    moved = torch.as_tensor(cache).movedim(0, 2)        # (2, 5, L, 8, 4)
    km, _ = ours.apply_to_cache(moved, moved, plan, head_axis=3,
                                layer_axis=2)
    np.testing.assert_array_equal(km.movedim(2, 0).numpy(),
                                  np.asarray(want))
    # a single-layer plan applies its one permutation to every layer
    one = dict(plan, perms=plan["perms"][:1],
               prev_perms=plan["prev_perms"][:1])
    k1, _ = ours.apply_to_cache(torch.as_tensor(cache),
                                torch.as_tensor(cache), one)
    want1, _ = ref.apply_to_cache(cache, cache, one)
    np.testing.assert_array_equal(k1.numpy(), np.asarray(want1))


# ----------------------------------------------------------------- engine
KINDS = {"dense": ({}, {}),
         "paged": ({}, {"paged": True, "page_size": 8}),
         "paged_k2": ({}, {"paged": True, "page_size": 8, "pipeline_k": 2}),
         "int8": ({"kv_quant": True}, {})}
SCENARIOS = {
    "fail": (4, {4: lambda e: e.fail_device(2)}),
    # at step 7 one slot holds a fresh request and the other a deep one:
    # replay must stagger their insertion
    "fail_staggered": (4, {7: lambda e: e.fail_device(2)}),
    "fail_rejoin": (4, {4: lambda e: e.fail_device(2),
                        12: lambda e: e.rejoin_device(2)}),
    "slow": (3, {3: lambda e: e.slow_device(1, 50.0)}),
}


def _churn_run(eng, churn):
    """5 staggered requests on 2 slots, firing ``churn`` ({scheduler
    step: fn(engine)}) as the scheduler reaches each step."""
    rng = np.random.default_rng(0)
    for i, n in enumerate((5, 11, 8, 14, 6)):
        eng.submit(rng.integers(0, 97, size=n), max_new_tokens=6 + 3 * (i % 2))
    ev = dict(churn)
    active = {}
    while True:
        if eng.decode_steps in ev:
            active[eng.decode_steps] = len(eng._active())
            ev.pop(eng.decode_steps)(eng)
        if not eng.step():
            break
    assert not ev, f"unfired churn events at steps {sorted(ev)}"
    return {r.rid: r.out_tokens for r in eng.finished}, active


@pytest.fixture(scope="module")
def musicgen():
    cfgs = {}
    params = None
    for kind, (over, _) in KINDS.items():
        cfg_j = reduced_config("musicgen-large", **over)
        cfgs[kind] = (cfg_j, _port_cfg(cfg_j))
        if params is None:
            params = jax.tree.map(np.asarray, JaxEngine(
                cfg_j, n_slots=2, max_seq=64, seed=0).params)
    return cfgs, params


def _port_engine(musicgen, kind, lam):
    cfgs, params = musicgen
    return ServingEngine(cfgs[kind][1], n_slots=2, max_seq=64, lam=lam,
                         seed=0, device="cpu",
                         params=params_from_jax(params, "cpu"),
                         **KINDS[kind][1])


def _logs(eng):
    keys = ("step", "n_migrations", "mig_bytes", "d_mig_est", "d_pipe_est",
            "applied", "reason")
    return [tuple(e[k] for k in keys) for e in eng.migration_log]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_churn_equals_reference(musicgen, scenario, kind):
    """Churn mid-decode leaves every stream equal to the churn-free run's
    (no controller interval at all) and to the reference engine's churn
    run; the recovery log (replay counts, delay estimates) and the
    interval log equal the reference's entry for entry."""
    lam, churn = SCENARIOS[scenario]
    base, _ = _churn_run(_port_engine(musicgen, kind, 10 ** 9), {})
    eng = _port_engine(musicgen, kind, lam)
    out, active = _churn_run(eng, churn)
    ref = JaxEngine(musicgen[0][kind][0], n_slots=2, max_seq=64, lam=lam,
                    seed=0, **KINDS[kind][1])
    ref_out, _ = _churn_run(ref, churn)
    assert len(out) == 5 and out == base
    assert out == ref_out
    assert all(active.values()), f"churn fired into an idle engine: {active}"
    assert eng.recovery_log == ref.recovery_log
    assert _logs(eng) == _logs(ref)
    assert eng.controller.history == ref.controller.history
    np.testing.assert_array_equal(eng.controller.perms, ref.controller.perms)
    assert eng.tokens_lost == 0
    if eng.paged:
        for alloc in eng.allocators:
            alloc.check_invariants()
            assert alloc.live_pages == 0
    if scenario == "slow":
        assert not eng.recovery_log
        assert eng.net.compute_avail[1] < eng.net.compute_max[1] / 10
        return
    rec = eng.recovery_log[0]
    assert rec["event"] == "fail" and rec["device"] == 2
    assert rec["tokens_lost"] == 0
    assert rec["replay_prefills"] == rec["replayed_slots"] >= 1
    assert rec["replay_steps"] >= 1
    if scenario != "fail_rejoin":
        assert not eng.net.is_active(2)
        assert not np.any(np.asarray(eng.controller.place) == 2)
        with pytest.raises(ValueError, match="not active"):
            eng.fail_device(2)
    else:
        assert [r["event"] for r in eng.recovery_log] == ["fail", "rejoin"]
        assert eng.net.is_active(2)
        with pytest.raises(ValueError, match="already active"):
            eng.rejoin_device(2)


def test_replay_restores_the_cache_and_row_maps(musicgen):
    """On the kernel path (the kernels' plain versions on the CPU), right
    after ``fail_device`` the rebuilt state carries the engine's current
    row maps and replay advanced no scheduler counter (``decode_steps``,
    ``step_times`` and the next tokens are live decode's); the streams
    then equal the churn-free run's."""
    cfgs, params = musicgen

    def run(lam, fail_at=None):
        eng = ServingEngine(cfgs["dense"][1], n_slots=2, max_seq=64,
                            lam=lam, seed=0, device="cpu", use_kernel=True,
                            params=params_from_jax(params, "cpu"))
        rng = np.random.default_rng(0)
        for n in (5, 11, 8):
            eng.submit(rng.integers(0, 97, size=n), max_new_tokens=9)
        seen = {}
        while True:
            if eng.decode_steps == fail_at:
                before = (eng.decode_steps, len(eng.step_times),
                          eng._next.copy(),
                          [list(eng.slots[s].out_tokens)
                           for s in eng._active()])
                eng.fail_device(2)
                seen["after"] = (eng.decode_steps, len(eng.step_times),
                                 eng._next.copy(),
                                 [list(eng.slots[s].out_tokens)
                                  for s in eng._active()])
                seen["before"] = before
                seen["rows"] = eng.state.get("head_rows")
                seen["engine_rows"] = eng._head_rows.copy()
            if not eng.step():
                break
        return {r.rid: r.out_tokens for r in eng.finished}, seen

    base, _ = run(10 ** 9)
    out, seen = run(4, fail_at=5)
    assert out == base and len(out) == 3
    b, a = seen["before"], seen["after"]
    assert a[:2] == b[:2] and a[3] == b[3]
    np.testing.assert_array_equal(a[2], b[2])
    assert seen["rows"] is not None
    np.testing.assert_array_equal(seen["rows"].numpy(), seen["engine_rows"])
    assert not np.array_equal(seen["engine_rows"][0],
                              np.arange(seen["engine_rows"].shape[1]))


# ------------------------------------------------------------------ async
def _llama_engine(lam=10 ** 9, max_seq=48):
    cfg = _port_cfg(reduced_config("llama3-8b"))
    return ServingEngine(cfg, n_slots=2, max_seq=max_seq, lam=lam, seed=0,
                         device="cpu")


def test_async_hang_escalates_to_controller_replan():
    """A hung worker refreshes the controller's availability view and
    forces Algorithm 1 on the next scheduler step, even under an
    effectively infinite λ."""
    eng = _llama_engine()
    clock = VirtualClock()
    rt = AsyncServingEngine(eng, heartbeat_timeout=5.0,
                            heartbeat_clock=clock.now)
    clock.advance(6.0)
    assert rt.check_workers() == [rt.ADMISSION, rt.DECODE]
    assert eng._replan_pending
    kinds = [e["kind"] for e in rt.monitor.events]
    assert kinds.count("recovery_escalated") == 2
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
    assert eng.step()
    assert len(eng.migration_log) == 1          # off the λ cadence
    assert not eng._replan_pending
    assert not rt.check_workers()               # one-shot transition


def test_async_escalation_can_be_disabled():
    eng = _llama_engine()
    clock = VirtualClock()
    rt = AsyncServingEngine(eng, heartbeat_timeout=5.0,
                            heartbeat_clock=clock.now, escalate_hangs=False)
    clock.advance(6.0)
    assert rt.check_workers() == [rt.ADMISSION, rt.DECODE]
    assert not eng._replan_pending
    assert all(e["kind"] != "recovery_escalated" for e in rt.monitor.events)


# -------------------------------------------------------------- load loop
def test_drive_virtual_events_and_model_pricing():
    """Events fire at their virtual time, model-priced stepping is
    deterministic, and neither changes any stream."""
    reqs = make_workload(rate=0.3, horizon=40.0, seed=5)
    fired = []
    ev = [(10.0, lambda e: fired.append(e.decode_steps))]
    base = drive_virtual(_llama_engine(lam=6, max_seq=64), reqs)
    r1 = drive_virtual(_llama_engine(lam=6, max_seq=64), reqs, events=ev,
                       price_by_model=True)
    r2 = drive_virtual(_llama_engine(lam=6, max_seq=64), reqs,
                       events=list(ev), price_by_model=True)
    assert len(fired) == 2                      # once per priced run
    assert r1["streams"] == r2["streams"] == base["streams"]
    for k in ("p50_ttft", "p99_ttft", "goodput", "t_end"):
        assert r1[k] == r2[k]
    assert r1["t_end"] != base["t_end"]         # the model priced the steps


def test_drive_virtual_event_fires_in_idle_gap():
    rng = np.random.default_rng(0)
    reqs = [TimedRequest(0.0, rng.integers(0, 97, size=5).astype(np.int32),
                         3)]
    fired = []
    drive_virtual(_llama_engine(), reqs,
                  events=[(1000.0, lambda e: fired.append(1))])
    assert fired == [1]


# ------------------------------------------------------- the bench's rows
def elastic_net():
    """``benchmarks.paper_setup.layered_net(seed=0, n_devices=8)`` from the
    port: 8 devices, each holding about one decoder layer of the 8 x 8
    layered graph at τ 200."""
    cost = CostModel(d_model=2048, n_heads=8, L0=64, n_layers=8,
                     compute_mode="incremental", layer_mode="graph")
    layer_mem = sum(cost.memory(b, 200) for b in
                    graph_of(make_blocks(8, 8)).layer_blocks(0))
    return DeviceNetwork.sample(8, seed=0,
                                mem_range=(1.0 * layer_mem, 1.5 * layer_mem),
                                bw_range=(0.05 * GBPS, 2 * GBPS),
                                compute_range=(20e9, 120e9))


def _elastic_drive(reqs, events=None, priced=False):
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, d_model=64, d_ff=128, n_heads=8, n_kv_heads=8, d_head=8,
        vocab_size=97, dtype="float32", param_dtype="float32")
    eng = ServingEngine(cfg, n_slots=4, max_seq=64, lam=8, seed=0,
                        paged=True, page_size=8, net=elastic_net(),
                        device="cpu")
    m = drive_virtual(eng, reqs, events=events, price_by_model=priced)
    assert m["n_finished"] == len(reqs)
    return eng, m


def _restart_steps(eng, plan, step_delay):
    """The restart baseline: every placed block re-sent from the
    controller node at the link rates, as ``benchmarks/elastic_serving``
    prices it."""
    net, place = eng.net, np.asarray(plan["place"])
    tau = max(int(plan["tau"]), 2)
    total = 0.0
    for b in eng.controller.blocks:
        rate = net.bandwidth[net.controller, int(place[b.index])]
        if np.isfinite(rate):
            total += eng.cost.memory(b, tau - 1) / rate
    return math.ceil(total / step_delay)


@pytest.fixture(scope="module")
def elastic_rows():
    """The five engine rows of ``benchmarks/elastic_serving.py`` from the
    port alone: churn-free, fail (device 5 at t 25), slow (device 3, 8x at
    t 25), fail then rejoin (t 25, 60), and model-priced steps."""
    reqs = make_workload(rate=0.25, horizon=120.0, seed=11, vocab=97)
    assert offered_load(reqs, 120.0)["req_rate"] > 0
    rows = {}

    def head(m):
        return (f"p50_ttft={m['p50_ttft']:.2f};p95_ttft={m['p95_ttft']:.2f};"
                f"p99_ttft={m['p99_ttft']:.2f};goodput={m['goodput']:.4f}")

    _, m0 = _elastic_drive(reqs)
    rows["churnfree"] = head(m0)
    info = {}

    def kill(eng):
        info["inflight"] = sum(len(eng.slots[s].out_tokens)
                               for s in eng._active())
        info["slots"] = len(eng._active())
        info["plan"] = eng.fail_device(5)

    eng, mf = _elastic_drive(reqs, events=[(25.0, kill)])
    assert info["slots"] and mf["streams"] == m0["streams"]
    plan, rec = info["plan"], eng.recovery_log[0]
    delay = float(plan["d_pipe_est"])
    evac = math.ceil(plan["d_mig_est"] / delay) + rec["replay_steps"]
    restart = _restart_steps(eng, plan, delay) + rec["replay_steps"]
    assert evac < restart
    rows["fail"] = (head(mf) + f";x_restart_vs_evac={restart / evac:.3f};"
                    f"tokens_lost={rec['tokens_lost']};"
                    f"tokens_lost_restart={info['inflight']};"
                    f"replay_steps={rec['replay_steps']}")
    eng, ms = _elastic_drive(
        reqs, events=[(25.0, lambda e: e.slow_device(3, 8.0))])
    assert ms["streams"] == m0["streams"]
    rows["slow"] = head(ms) + ";n_migrations=" + str(
        sum(e["n_migrations"] for e in eng.migration_log))
    eng, mr = _elastic_drive(reqs, events=[
        (25.0, lambda e: e.fail_device(5)),
        (60.0, lambda e: e.rejoin_device(5))])
    assert mr["streams"] == m0["streams"]
    assert [r["event"] for r in eng.recovery_log] == ["fail", "rejoin"]
    rows["rejoin"] = head(mr)
    _, mp = _elastic_drive(reqs, priced=True)
    assert mp["streams"] == m0["streams"]
    rows["priced"] = head(mp)
    return rows


@pytest.mark.parametrize("row", ["churnfree", "fail", "slow", "rejoin",
                                 "priced"])
def test_elastic_engine_rows_reproduce_baseline(elastic_rows, row):
    want = {r["name"]: r["derived"]
            for r in json.loads(BASELINE.read_text())}
    assert elastic_rows[row] == want[f"elastic/{row}/r0.25"]
