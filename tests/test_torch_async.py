"""The port's async serving runtime (``repro_torch.serving.async_runtime``):
the counterparts of the JAX package's ``tests/test_async_serving.py``.

Engines serve the reference's reduced ``llama3-8b`` with the reference's
weights (``weights.params_from_jax``), greedy, on the CPU.  The async
streams equal the synchronous engine's under ``drive_virtual`` (dense and
paged), backpressure is a typed reject, a drain leaves no live page, hung
workers are logged once on a virtual clock, the interval log and the
controller's history carry the observed load (equal to the reference's),
failures propagate out of ``drain`` rather than being swallowed, and the
port alone reproduces ``BENCH_serving_load.json``'s ``load/async/r0.25``
row.
"""
import asyncio
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.workload import drive_virtual as ref_drive
from repro.serving.workload import make_workload as ref_workload
from repro_torch.configs import get_config
from repro_torch.serving.async_runtime import (AsyncServingEngine,
                                               QueueFullError)
from repro_torch.serving.engine import ServingEngine, WaveServingEngine
from repro_torch.serving.workload import (VirtualClock, drive_virtual,
                                          make_workload)
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

BASELINE = Path(__file__).resolve().parents[1] / "benchmarks" / \
    "baselines" / "BENCH_serving_load.json"
PAGED = {"paged": True, "page_size": 8}

@pytest.fixture(scope="module")
def llama():
    cfg_j = reduced_config("llama3-8b")
    params = jax.tree.map(np.asarray, JaxEngine(
        cfg_j, n_slots=2, max_seq=64, lam=10 ** 9, seed=0).params)
    cfg_t = get_config(cfg_j.name).with_overrides(
        **dataclasses.asdict(cfg_j))
    return cfg_j, cfg_t, params


def _engine(llama, cls=ServingEngine, **kw):
    _, cfg_t, params = llama
    kw = dict(dict(n_slots=2, max_seq=64, lam=10 ** 9, seed=0), **kw)
    return cls(cfg_t, device="cpu", params=params_from_jax(params, "cpu"),
               **kw)


def _workload(rate=0.3, horizon=30.0, seed=5):
    return make_workload("poisson", rate=rate, horizon=horizon, seed=seed,
                         vocab=97)


async def _run_async(eng, reqs, **rt_kw):
    rt = AsyncServingEngine(eng, queue_limit=len(reqs) + 1, **rt_kw)
    async with rt:
        handles = [rt.submit(r.prompt, max_new_tokens=r.max_new_tokens)
                   for r in sorted(reqs, key=lambda r: r.t_arrival)]
        await rt.drain()
    return handles


# ------------------------------------------------------------ bit-identity
@pytest.mark.parametrize("kw", [{}, PAGED], ids=["dense", "paged"])
def test_async_streams_equal_sync(llama, kw):
    """Same admission order: every per-request stream equals the
    synchronous engine's under ``drive_virtual``, dense and paged."""
    reqs = _workload()
    sync = drive_virtual(_engine(llama, **kw), reqs)
    assert sync["n_finished"] == len(reqs)
    handles = asyncio.run(_run_async(_engine(llama, **kw), reqs))
    assert {h.rid: h.tokens for h in handles} == sync["streams"]
    for h in handles:
        assert h.error is None
        assert h.t_first is not None and h.t_done >= h.t_first


def test_stream_iteration_matches_result(llama):
    prompt = np.arange(5, dtype=np.int32)

    async def go():
        async with AsyncServingEngine(_engine(llama)) as rt:
            h = rt.submit(prompt, max_new_tokens=6)
            seen = [tok async for tok in h.stream()]
            return seen, await h.result()

    seen, result = asyncio.run(go())
    assert seen == result and len(seen) == 6


# ------------------------------------------------------------ backpressure
def test_queue_full_is_typed_reject(llama):
    eng = _engine(llama)
    rt = AsyncServingEngine(eng, queue_limit=2)
    p = np.arange(4, dtype=np.int32)
    rt.submit(p), rt.submit(p)
    assert rt.queue_depth == 2
    with pytest.raises(QueueFullError, match="admission queue full"):
        rt.submit(p)
    assert rt.queue_depth == 2          # the reject enqueued nothing
    assert len(eng.queue) == 0          # the runtime never started


def test_submit_after_drain_rejected(llama):
    async def go():
        rt = AsyncServingEngine(_engine(llama))
        async with rt:
            rt.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
            await rt.drain()
            with pytest.raises(RuntimeError, match="draining"):
                rt.submit(np.arange(4, dtype=np.int32))

    asyncio.run(go())


def test_oversized_prompt_fails_its_own_handle(llama):
    async def go():
        async with AsyncServingEngine(_engine(llama)) as rt:
            ok = rt.submit(np.arange(4, dtype=np.int32), max_new_tokens=3)
            bad = rt.submit(np.zeros(500, np.int32), max_new_tokens=3)
            with pytest.raises(ValueError, match="exceeds max bucket"):
                await bad.result()
            return await ok.result()

    assert len(asyncio.run(go())) == 3


# -------------------------------------------------------------------- drain
def test_drain_leaves_no_live_pages(llama):
    reqs = _workload(rate=0.5)
    eng = _engine(llama, **PAGED)
    handles = asyncio.run(_run_async(eng, reqs))
    assert all(h._finished.is_set() for h in handles)
    assert len(eng.queue) == 0 and not eng._active()
    for a in eng.allocators:
        a.check_invariants()
        assert a.live_pages == 0 and a.reserved_pages == 0


def test_runtime_requires_slot_engine_and_free_sink(llama):
    weng = _engine(llama, cls=WaveServingEngine, max_seq=48)
    with pytest.raises(TypeError, match="ServingEngine"):
        AsyncServingEngine(weng)
    eng = _engine(llama)
    eng.token_sink = lambda r, t, d: None
    with pytest.raises(ValueError, match="token_sink"):
        AsyncServingEngine(eng)


def test_decode_failure_propagates_from_drain(llama):
    """No fallback: an exception in the decode worker, and a head-of-line
    request the pool can never admit, leave ``drain`` as errors."""
    eng = _engine(llama)

    def broken():
        raise RuntimeError("decode step failed")

    eng.step = broken

    async def go(e, prompt):
        async with AsyncServingEngine(e) as rt:
            rt.submit(prompt, max_new_tokens=3)
            await rt.drain()

    with pytest.raises(RuntimeError, match="decode step failed"):
        asyncio.run(go(eng, np.arange(4, dtype=np.int32)))
    tiny = _engine(llama, paged=True, page_size=8, kv_pages=2)
    with pytest.raises(RuntimeError, match="cannot admit"):
        asyncio.run(go(tiny, np.arange(30, dtype=np.int32)))


# ----------------------------------------------------------- hang detection
def test_hung_worker_detected_and_logged_once(llama):
    clk = VirtualClock()
    rt = AsyncServingEngine(_engine(llama), heartbeat_timeout=5.0,
                            heartbeat_clock=clk.now)
    assert rt.check_workers() == []
    clk.advance(6.0)
    assert sorted(rt.check_workers()) == [rt.ADMISSION, rt.DECODE]
    assert rt.check_workers() == []          # one-shot, not per poll
    hung = [e for e in rt.monitor.events if e["kind"] == "worker_hung"]
    assert len(hung) == 2
    assert all(e["silent_s"] > 5.0 for e in hung)
    # a late heartbeat revives the worker; silent again, it is re-flagged
    rt.monitor.record_heartbeat(rt.DECODE)
    clk.advance(6.0)
    assert rt.check_workers() == [rt.DECODE]


def test_live_workers_heartbeat_under_load(llama):
    reqs = _workload()
    eng = _engine(llama)
    holder = {}

    async def go():
        rt = AsyncServingEngine(eng, queue_limit=len(reqs) + 1)
        holder["rt"] = rt
        async with rt:
            for r in sorted(reqs, key=lambda r: r.t_arrival):
                rt.submit(r.prompt, max_new_tokens=r.max_new_tokens)
            await rt.drain()

    asyncio.run(go())
    rt = holder["rt"]
    assert rt.check_workers() == []
    assert len(rt.monitor.slots[rt.DECODE].step_times) > 0


# ------------------------------------------------------- load observability
def test_interval_log_carries_arrival_rate_and_queue_depth(llama):
    """The interval records carry the engine's observed load, and the
    controller's history equals the reference's on the same run."""
    cfg_j = llama[0]
    eng = _engine(llama, lam=8)
    drive_virtual(eng, _workload(rate=0.4, horizon=25.0, seed=3))
    ref = JaxEngine(cfg_j, n_slots=2, max_seq=64, lam=8, seed=0)
    ref_drive(ref, ref_workload("poisson", rate=0.4, horizon=25.0, seed=3,
                                vocab=97))
    assert eng.migration_log, "lam=8 must tick at least one interval"
    for entry in eng.migration_log:
        assert entry["arrival_rate"] is not None
        assert entry["arrival_rate"] >= 0.0
        assert entry["queue_depth"] is not None
    hist = eng.controller.history
    assert hist and all("arrival_rate" in h and "queue_depth" in h
                        for h in hist)
    assert sum(h["arrival_rate"] for h in hist) > 0.0
    assert hist == ref.controller.history
    assert [(e["arrival_rate"], e["queue_depth"])
            for e in eng.migration_log] == \
        [(e["arrival_rate"], e["queue_depth"]) for e in ref.migration_log]
    assert list(eng.admission_log) == list(ref.admission_log)


# ------------------------------------------------------- the bench's row
def test_load_async_row_reproduces_baseline():
    """``load/async/r0.25`` from the port alone: the paged bench engine
    (random weights from seed 0) through the runtime, every request
    submitted in arrival order; its streams equal ``drive_virtual``'s."""
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=2, d_model=64, d_ff=128, n_heads=4, n_kv_heads=4,
        d_head=16, vocab_size=97, dtype="float32", param_dtype="float32")
    reqs = make_workload("poisson", rate=0.25, horizon=120.0, seed=11,
                         vocab=cfg.vocab_size)

    def engine():
        return ServingEngine(cfg, n_slots=4, max_seq=64, lam=10 ** 9,
                             seed=0, device="cpu", **PAGED)

    handles = asyncio.run(_run_async(engine(), reqs))
    streams = {h.rid: list(h.tokens) for h in handles}
    assert streams == drive_virtual(engine(), reqs)["streams"]
    want = {r["name"]: r["derived"]
            for r in json.loads(BASELINE.read_text())}
    derived = (f"requests={len(streams)};"
               f"tokens={sum(len(t) for t in streams.values())}")
    assert derived == want["load/async/r0.25"]
