"""The port's seeded workload generator (``repro_torch.serving.workload``)
against the JAX package's.

- ``make_workload`` draws the reference's arrival times, prompts and token
  budgets from the same seed, for every arrival process; ``offered_load``
  and the clock and process errors match.
- ``drive_virtual`` over the port's engine (the reference's weights
  through ``weights.params_from_jax``, greedy, on the CPU) returns the
  reference's result over the reference's engine field for field: streams,
  per-token TTFT and inter-token samples, percentiles, goodput, steps —
  dense, paged and paged with two pipeline groups.
- The port alone reproduces the five engine rows of
  ``benchmarks/baselines/BENCH_serving_load.json`` string for string (the
  percentiles are virtual-clock numbers: the schedule sets them, not the
  weights).
"""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.serving import workload as ref_wl
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.serving import workload as wl
from repro_torch.serving.engine import ServingEngine
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "baselines" / "BENCH_serving_load.json"
KINDS = {"dense": {}, "paged": {"paged": True, "page_size": 8},
         "paged_k2": {"paged": True, "page_size": 8, "pipeline_k": 2}}

def _port_cfg(cfg_j):
    return get_config(cfg_j.name).with_overrides(**dataclasses.asdict(cfg_j))


def _same_workload(a, b):
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert ra.t_arrival == rb.t_arrival
        assert ra.max_new_tokens == rb.max_new_tokens
        assert ra.prompt.dtype == rb.prompt.dtype
        np.testing.assert_array_equal(ra.prompt, rb.prompt)


# ---------------------------------------------------------------- processes
@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_make_workload_equals_reference(process, seed):
    """Equal seeds draw equal workloads in both packages, with the default
    mixes and with the long-prompt mix of the card's load path."""
    for kw in ({}, {"vocab": 128256, "prompt_mix": ((1.0, 32, 512),),
                    "out_mix": ((1.0, 64, 64),)}):
        _same_workload(
            wl.make_workload(process, rate=0.3, horizon=80.0, seed=seed,
                             **kw),
            ref_wl.make_workload(process, rate=0.3, horizon=80.0, seed=seed,
                                 **kw))


def test_arrival_processes_equal_reference():
    for fn, args in (("poisson_arrivals", (0.5, 400.0)),
                     ("mmpp_arrivals", (0.2, 2.0, 50.0, 800.0)),
                     ("diurnal_arrivals", (0.1, 1.0, 100.0, 400.0))):
        ours = getattr(wl, fn)(*args, np.random.default_rng(3))
        ref = getattr(ref_wl, fn)(*args, np.random.default_rng(3))
        assert len(ours) > 0
        np.testing.assert_array_equal(ours, ref)
    assert wl.DEFAULT_PROMPT_MIX == ref_wl.DEFAULT_PROMPT_MIX
    assert wl.DEFAULT_OUT_MIX == ref_wl.DEFAULT_OUT_MIX


def test_offered_load_equals_reference():
    reqs = wl.make_workload("poisson", rate=0.5, horizon=60.0, seed=3)
    ref = ref_wl.make_workload("poisson", rate=0.5, horizon=60.0, seed=3)
    assert wl.offered_load(reqs, 60.0) == ref_wl.offered_load(ref, 60.0)
    toks = sum(len(r.prompt) + r.max_new_tokens for r in reqs)
    assert wl.offered_load(reqs, 60.0)["tok_rate"] == pytest.approx(
        toks / 60.0)


def test_clock_and_process_errors_match_reference():
    for mod in (wl, ref_wl):
        c = mod.VirtualClock()
        c.advance(2.0)
        c.advance_to(1.0)           # advance_to never rewinds
        assert c.now() == 2.0
        with pytest.raises(ValueError, match="backwards"):
            c.advance(-1.0)
        with pytest.raises(ValueError, match="arrival process"):
            mod.make_workload("adversarial", rate=1.0, horizon=10.0)
        with pytest.raises(ValueError, match="positive"):
            mod.poisson_arrivals(0.0, 1.0, np.random.default_rng(0))
        w = mod.WallClock()
        w.advance(5.0)              # wall time advances itself
        assert w.now() <= mod.WallClock().now()


# ---------------------------------------------------------------- load loop
@pytest.fixture(scope="module")
def llama():
    cfg_j = reduced_config("llama3-8b")
    params = jax.tree.map(np.asarray, JaxEngine(
        cfg_j, n_slots=2, max_seq=64, lam=10 ** 9, seed=0).params)
    return cfg_j, _port_cfg(cfg_j), params


@pytest.mark.parametrize("kind", list(KINDS))
def test_drive_virtual_equals_reference(llama, kind):
    cfg_j, cfg_t, params = llama
    reqs = wl.make_workload("poisson", rate=0.3, horizon=30.0, seed=5,
                            vocab=cfg_t.vocab_size)
    ref_reqs = ref_wl.make_workload("poisson", rate=0.3, horizon=30.0,
                                    seed=5, vocab=cfg_j.vocab_size)
    kw = dict(n_slots=2, max_seq=64, lam=10 ** 9, seed=0, **KINDS[kind])
    eng = ServingEngine(cfg_t, device="cpu",
                        params=params_from_jax(params, "cpu"), **kw)
    ours = wl.drive_virtual(eng, reqs)
    ref = ref_wl.drive_virtual(JaxEngine(cfg_j, **kw), ref_reqs)
    assert ours["n_finished"] == len(reqs) == ours["n_submitted"]
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k] == ref[k], k
    assert ours["p99_ttft"] >= ours["p95_ttft"] >= ours["p50_ttft"] >= 0.0
    assert eng.token_sink is None            # the sink is restored
    if eng.paged:
        for a in eng.allocators:
            a.check_invariants()
            assert a.live_pages == 0


def test_drive_virtual_raises_on_unadmittable_head(llama):
    """A head-of-line request that needs more pages than the pool holds
    can never admit: ``drive_virtual`` raises (it must not spin or drop
    it) and still restores the engine's sink."""
    _, cfg_t, params = llama
    eng = ServingEngine(cfg_t, n_slots=2, max_seq=64, lam=10 ** 9, seed=0,
                        paged=True, page_size=8, kv_pages=2, device="cpu",
                        params=params_from_jax(params, "cpu"))

    def sink(req, tok, done):
        pass

    eng.token_sink = sink
    reqs = [wl.TimedRequest(0.0, np.arange(30, dtype=np.int32) % 97, 4)]
    with pytest.raises(RuntimeError, match="never admit"):
        wl.drive_virtual(eng, reqs)
    assert eng.token_sink is sink


# ------------------------------------------------------- the bench's rows
def _load_cfg():
    """``benchmarks.serving_throughput.default_cfg`` in the port."""
    return get_config("llama3-8b").with_overrides(
        n_layers=2, d_model=64, d_ff=128, n_heads=4, n_kv_heads=4,
        d_head=16, vocab_size=97, dtype="float32", param_dtype="float32")


def load_row(kind: str, rate: float):
    """One ``load/<kind>/r<rate>`` row of ``benchmarks/serving_load.py``
    from the port alone: 4 slots, a 64-token cache, no intervals, random
    weights from seed 0, Poisson arrivals from seed 11 over 120 steps."""
    cfg = _load_cfg()
    reqs = wl.make_workload("poisson", rate=rate, horizon=120.0, seed=11,
                            vocab=cfg.vocab_size)
    eng = ServingEngine(cfg, n_slots=4, max_seq=64, lam=10 ** 9, seed=0,
                        device="cpu", **KINDS[kind])
    m = wl.drive_virtual(eng, reqs)
    assert m["n_finished"] == len(reqs)
    off = wl.offered_load(reqs, 120.0)
    return (f"p50_ttft={m['p50_ttft']:.2f};p95_ttft={m['p95_ttft']:.2f};"
            f"p99_ttft={m['p99_ttft']:.2f};p50_itl={m['p50_itl']:.2f};"
            f"p95_itl={m['p95_itl']:.2f};p99_itl={m['p99_itl']:.2f};"
            f"goodput={m['goodput']:.3f};"
            f"offered_load={off['req_rate']:.3f}"), m["streams"]


@pytest.mark.parametrize("kind,rate", [("paged", 0.1), ("paged", 0.25),
                                       ("paged", 0.45), ("dense", 0.25),
                                       ("paged_k2", 0.25)])
def test_load_rows_reproduce_baseline(kind, rate):
    want = {r["name"]: r["derived"]
            for r in json.loads(BASELINE.read_text())}
    derived, _ = load_row(kind, rate)
    assert derived == want[f"load/{kind}/r{rate:g}"]
