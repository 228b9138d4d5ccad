"""Paged and int8 KV serving in the port, against the JAX package and
against the port's own dense engine.

- ``PagedKVAllocator`` hands out the reference's page ids in the same
  order over one seeded admit/extend/release sequence.
- On the GQA scenario of ``tests/test_torch_engine.py`` (reduced
  ``llama3-8b``, 3 layers, 2 KV heads, 2 simulated devices, λ = 3, a 500x
  straggler at step 4, the reference's weights through
  ``weights.params_from_jax``), the port's paged, int8 and paged-int8
  engines stream the reference engine's greedy tokens with its migration
  log, physical layout and kernel row maps.
- Inside the port the reference's own invariances hold bit for bit (as
  ``tests/test_paging.py`` checks them for JAX): paged streams and logits
  equal dense ones, before and after a migration; one chunk shape serves
  every prompt; migration bytes are priced from live pages; admission
  waits for pages; the paged benchmark's derived numbers reproduce.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmarks import paged_serving
from benchmarks.serving_throughput import default_cfg
from repro.core.network import DeviceNetwork as JaxNetwork
from repro.models.api import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.paging import PagedKVAllocator as JaxAllocator
from repro_torch.configs import get_config
from repro_torch.core.network import DeviceNetwork
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paging import PagedKVAllocator, PageExhaustedError
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config


def _port_cfg(cfg_j):
    return get_config(cfg_j.name).with_overrides(**dataclasses.asdict(cfg_j))


# ----------------------------------------------------------- allocator
def test_allocator_page_ids_equal_reference():
    """One seeded admit/extend/release sequence through both allocators:
    every returned page list, page-map row and pool count is equal (the
    LIFO free list decides which physical page each slot reads)."""
    rng = np.random.default_rng(0)
    ours = PagedKVAllocator(n_pages=24, page_size=4, n_rows=4,
                            max_pages_per_slot=8)
    ref = JaxAllocator(n_pages=24, page_size=4, n_rows=4,
                       max_pages_per_slot=8)
    live = set()
    for _ in range(400):
        op = int(rng.integers(0, 3))
        if op == 0 and len(live) < 4:
            row = min(r for r in range(4) if r not in live)
            n = int(rng.integers(1, 13))
            horizon = n + int(rng.integers(0, 12))
            assert ours.can_admit(n, horizon) == ref.can_admit(n, horizon)
            if ref.can_admit(n, horizon):
                assert ours.admit(row, n, horizon) == \
                    ref.admit(row, n, horizon)
                live.add(row)
        elif op == 1 and live:
            row = int(rng.choice(sorted(live)))
            n = ref.pages_for(row) * 4 + int(rng.integers(1, 6))
            try:
                want = ref.extend(row, n)
            except Exception as e:       # the reference's own typed error
                assert type(e).__name__ == "PageExhaustedError"
                with pytest.raises(PageExhaustedError):
                    ours.extend(row, n)
            else:
                assert ours.extend(row, n) == want
        elif op == 2 and live:
            row = int(rng.choice(sorted(live)))
            assert ours.release(row) == ref.release(row)
            live.discard(row)
        for row in range(4):
            np.testing.assert_array_equal(ours.page_map_row(row),
                                          ref.page_map_row(row))
        assert (ours.free_pages, ours.live_pages, ours.reserved_pages) == \
            (ref.free_pages, ref.live_pages, ref.reserved_pages)
        ours.check_invariants()


# ------------------------------------------- engine parity with the reference
PROMPT_LENS = (5, 11, 8, 14, 6)


def _drive(eng, prompts, straggle_at):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=10 + 3 * (i % 2))
    while True:
        if straggle_at is not None and eng.decode_steps == straggle_at:
            dev = int(eng.controller.head_counts().argmax())
            eng.net.inject_straggler(dev, slowdown=500.0)
        if not eng.step():
            break
    return {r.rid: r.out_tokens for r in eng.finished}


@pytest.fixture(scope="module")
def scenario():
    cfg_j = reduced_config("llama3-8b", n_layers=3, n_kv_heads=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n) for n in PROMPT_LENS]
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0)))
    return cfg_j, prompts, params


@pytest.mark.parametrize("kv_quant,paged", [(False, True), (True, False),
                                            (True, True)],
                         ids=["paged", "int8", "int8_paged"])
def test_engine_streams_equal_reference(scenario, kv_quant, paged):
    cfg_j, prompts, params = scenario
    cfg_j = cfg_j.with_overrides(kv_quant=kv_quant)
    kw = dict(n_slots=2, max_seq=64, lam=3, seed=0, use_kernel=True,
              paged=paged, page_size=8)
    ref = JaxEngine(cfg_j, net=JaxNetwork.sample(2, seed=1), **kw)
    want = _drive(ref, prompts, straggle_at=4)
    eng = ServingEngine(_port_cfg(cfg_j), net=DeviceNetwork.sample(2, seed=1),
                        device="cpu", params=params_from_jax(params, "cpu"),
                        **kw)
    got = _drive(eng, prompts, straggle_at=4)
    assert len(got) == len(PROMPT_LENS) and got == want
    keys = ("step", "n_migrations", "mig_bytes", "applied")
    assert [tuple(e[k] for k in keys) for e in eng.migration_log] == \
        [tuple(e[k] for k in keys) for e in ref.migration_log]
    assert any(e["applied"] and e["n_migrations"]
               for e in eng.migration_log), "no migration was applied"
    np.testing.assert_array_equal(eng._phys_perms, ref._phys_perms)
    np.testing.assert_array_equal(eng._head_rows, ref._head_rows)
    np.testing.assert_array_equal(eng._head_inv, ref._head_inv)
    if paged:
        eng.allocator.check_invariants()
        assert eng.allocator.live_pages == 0
        assert eng.allocator.free_pages == ref.allocators[0].free_pages


# ------------------------------------- paged == dense inside the port
def _cfg(**over):
    return _port_cfg(reduced_config("llama3-8b", **over))


def _streams(cfg, prompts, *, paged, lam=10 ** 9, straggle_at=None,
             use_kernel=False, max_new=8):
    """Serve ``prompts`` on 2 slots; returns the streams, the logits of the
    active rows at every decode step, and the engine."""
    eng = ServingEngine(cfg, n_slots=2, max_seq=64, lam=lam, seed=0,
                        net=DeviceNetwork.sample(2, seed=1),
                        use_kernel=use_kernel, paged=paged, page_size=8,
                        device="cpu")
    logits, inner = [], eng.model.decode_step

    def decode_step(params, state, tokens):
        out, state = inner(params, state, tokens)
        logits.append(out[eng._active()].clone())
        return out, state

    eng.model.decode_step = decode_step
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=max_new + (i % 2))
    while True:
        if straggle_at is not None and eng.decode_steps == straggle_at:
            dev = int(eng.controller.head_counts().argmax())
            eng.net.inject_straggler(dev, slowdown=500.0)
        if not eng.step():
            break
    return {r.rid: r.out_tokens for r in eng.finished}, logits, eng


def _assert_bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("over", [{}, {"n_kv_heads": 2}, {"kv_quant": True}],
                         ids=["dense", "gqa", "int8kv"])
def test_paged_streams_and_logits_bit_identical_to_dense(over):
    """The paged engine streams exactly the dense engine's greedy tokens,
    with bit-equal logits at every step: page scatter/gather is a pure
    re-layout."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32)
               for n in (5, 11, 3, 17)]
    want, want_logits, _ = _streams(_cfg(**over), prompts, paged=False)
    got, got_logits, eng = _streams(_cfg(**over), prompts, paged=True)
    assert got == want and len(got) == 4
    _assert_bit_equal(got_logits, want_logits)
    eng.allocator.check_invariants()
    assert eng.allocator.live_pages == 0


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
def test_paged_streams_survive_applied_migration(kv_quant):
    """A mid-stream head migration on the paged engine (kernel path, row
    maps rebuilt from the plan) leaves streams and logits bit-identical to
    the dense engine under the same straggler, and the streams to a
    migration-free paged run."""
    cfg = _cfg(n_layers=3, n_kv_heads=2, kv_quant=kv_quant)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32)
               for n in (5, 11, 8, 14)]
    run = dict(lam=3, straggle_at=4, use_kernel=True, max_new=10)
    got, got_logits, eng = _streams(cfg, prompts, paged=True, **run)
    want, want_logits, _ = _streams(cfg, prompts, paged=False, **run)
    free, _, _ = _streams(cfg, prompts, paged=True, max_new=10)
    assert got == want == free and len(got) == 4
    _assert_bit_equal(got_logits, want_logits)
    assert any(e["applied"] and e["n_migrations"]
               for e in eng.migration_log), "no migration was applied"
    eng.allocator.check_invariants()
    assert eng.allocator.live_pages == 0


def test_one_chunk_shape_serves_every_prompt():
    """Mixed prompt lengths prefill through one fixed chunk shape — no
    bucket ladder."""
    eng = ServingEngine(_cfg(), n_slots=2, max_seq=64, lam=10 ** 9, seed=0,
                        paged=True, page_size=8, device="cpu")
    shapes, inner = set(), eng.model.prefill_paged

    def prefill_paged(params, state, tokens, *args):
        shapes.add(tuple(tokens.shape))
        return inner(params, state, tokens, *args)

    eng.model.prefill_paged = prefill_paged
    rng = np.random.default_rng(1)
    for n in (3, 9, 14, 21, 6):
        eng.submit(rng.integers(0, 97, size=n).astype(np.int32),
                   max_new_tokens=4)
    assert len(eng.run()) == 5
    assert shapes == {(1, 8)}
    assert eng.prefill_buckets_used == {8}


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
def test_migration_bytes_priced_from_live_pages(kv_quant):
    """Pages are the migration unit: a head migration on the paged engine
    is priced on allocated pages only, against the dense engine's
    ``n_slots × max_seq`` extent, in the closed form per kv row (int8:
    one byte per value plus a float32 scale per (token, head))."""
    cfg = _cfg(kv_quant=kv_quant)
    kw = dict(n_slots=2, max_seq=64, lam=10 ** 9, seed=0, device="cpu")
    dense = ServingEngine(cfg, **kw)
    paged = ServingEngine(cfg, paged=True, page_size=8, **kw)
    for eng in (dense, paged):
        eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=4)
        eng._admit()
    assert paged._live_cache_tokens() == 8     # 1 live page of 8 tokens
    assert dense._live_cache_tokens() == 2 * 64
    pairs = [(0, 0, 0, 1)]                     # one head, one layer
    hd = paged.model.hd
    row = hd.dh + 4 if kv_quant else hd.dh * 4
    assert paged._migration_bytes(pairs) == 8 * 2 * row
    assert dense._migration_bytes(pairs) == \
        paged._migration_bytes(pairs) * (2 * 64) // 8
    assert paged.cost.page_size == 8 and dense.cost.page_size == 0


def test_admission_waits_for_pages():
    """A request whose horizon cannot be reserved waits in the queue while
    a slot is free (no mid-stream exhaustion by construction) and is
    admitted once a retire returns pages."""
    # a pool of 4 pages for 3 slots; each request needs 2 (prompt 5 -> 1
    # page, horizon 5 + 4 + 1 = 10 -> 2 pages)
    eng = ServingEngine(_cfg(), n_slots=3, max_seq=16, lam=10 ** 9, seed=0,
                        paged=True, page_size=8, kv_pages=4, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(0, 97, size=5), max_new_tokens=4)
    assert eng.step()
    assert eng.page_waits == 1 and len(eng.queue) == 1
    assert eng.slots[2] is None
    done = eng.run()
    assert len(done) == 3 and not eng.queue
    assert done[-1].rid == 2 and done[-1].t_first > done[0].t_done
    eng.allocator.check_invariants()
    assert eng.allocator.live_pages == 0


def test_paged_benchmark_numbers_reproduce():
    """``benchmarks/paged_serving.py``'s config and workload on the port's
    engines: at an equal KV budget the paged engine holds 3.00x the slots
    in 2.41x fewer scheduler steps (``BENCH_paged_serving.json``), with
    streams equal to dense."""
    cfg = _port_cfg(default_cfg())
    kw = dict(max_seq=paged_serving.MAX_SEQ, lam=10 ** 9, seed=0,
              device="cpu")
    dense = ServingEngine(cfg, n_slots=paged_serving.BUDGET_TOKENS
                          // paged_serving.MAX_SEQ, **kw)
    paged = ServingEngine(cfg, n_slots=8, paged=True,
                          page_size=paged_serving.PAGE_SIZE,
                          kv_pages=paged_serving.BUDGET_TOKENS
                          // paged_serving.PAGE_SIZE, **kw)
    out = {name: paged_serving.drive(eng, paged_serving.make_workload(12, 0))
           for name, eng in (("dense", dense), ("paged", paged))}
    assert out["paged"]["streams"] == out["dense"]["streams"]
    assert (out["dense"]["peak_slots"], out["paged"]["peak_slots"]) == (2, 6)
    assert out["dense"]["tokens"] == out["paged"]["tokens"] == 113
    x_slots = out["paged"]["peak_slots"] / out["dense"]["peak_slots"]
    x_steps = out["dense"]["decode_steps"] / out["paged"]["decode_steps"]
    assert f"x_slots={x_slots:.2f};x_steps={x_steps:.2f}" == \
        "x_slots=3.00;x_steps=2.41"
    paged.allocator.check_invariants()
    assert paged.allocator.live_pages == 0
