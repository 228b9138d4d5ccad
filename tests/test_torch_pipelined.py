"""The port's pipelined serving (``ServingEngine(pipeline_k=K)``) with the
bottleneck-targeted controller, against the JAX package's engine and
against its own sequential path.

Scenario (the reference's ``test_engine_bottleneck_mode_migrates_with_
streams_equal``): a reduced ``llama3-8b`` (2 layers, 4 heads), 4 slots in
K = 2 groups of 2, 4 simulated devices, λ = 3, a 500x straggler injected at
scheduler step 6 on the device holding the most heads, prompts of lengths
(4, 9, 6, 11).  Both engines run ``use_kernel=True`` on the same weights
(the reference's ``init`` through ``weights.params_from_jax``): greedy
streams, the interval log and the applied layout must be equal.  Inside
the port the pipelined streams equal the sequential, migration-free
streams, paged equals dense, and the kernels' plain versions equal the
model's own attention.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core.network import DeviceNetwork as JaxNetwork
from repro.models.api import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.network import DeviceNetwork
from repro_torch.serving.engine import ServingEngine
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config

PROMPT_LENS = (4, 9, 6, 11)
LAM, K, STRAGGLE_AT = 3, 2, 6


def _drive(eng, prompts, straggle_at=None, new_tokens=8):
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    while True:
        if straggle_at is not None and eng.decode_steps == straggle_at:
            dev = int(eng.controller.head_counts().argmax())
            eng.net.inject_straggler(dev, slowdown=500.0)
        if not eng.step():
            break
    return {r.rid: r.out_tokens for r in eng.finished}


@pytest.fixture(scope="module")
def setup():
    cfg_j = reduced_config("llama3-8b")
    cfg_t = get_config("llama3-8b").with_overrides(
        **dataclasses.asdict(cfg_j))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n) for n in PROMPT_LENS]
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0)))
    return cfg_j, cfg_t, prompts, params


def _port(setup, *, k=K, lam=LAM, search="bottleneck", use_kernel=True,
          straggle_at=STRAGGLE_AT, **kw):
    _, cfg_t, prompts, params = setup
    eng = ServingEngine(cfg_t, n_slots=4, max_seq=48, lam=lam, seed=0,
                        pipeline_k=k, search=search,
                        net=DeviceNetwork.sample(4, seed=1),
                        use_kernel=use_kernel, device="cpu",
                        params=params_from_jax(params, "cpu"), **kw)
    return _drive(eng, prompts, straggle_at), eng


@pytest.fixture(scope="module")
def ref_run(setup):
    cfg_j, _, prompts, _ = setup
    ref = JaxEngine(cfg_j, n_slots=4, max_seq=48, lam=LAM, seed=0,
                    pipeline_k=K, search="bottleneck",
                    net=JaxNetwork.sample(4, seed=1), use_kernel=True)
    return _drive(ref, prompts, STRAGGLE_AT), ref


@pytest.fixture(scope="module")
def pipe_run(setup):
    return _port(setup)


@pytest.fixture(scope="module")
def paged_run(setup):
    return _port(setup, paged=True, page_size=8)


@pytest.fixture(scope="module")
def seq_run(setup):
    return _port(setup, k=1, lam=10 ** 9, search="rescoring",
                 straggle_at=None)


def _log(eng):
    return [(e["step"], e["n_migrations"], e["applied"], e["reason"])
            for e in eng.migration_log]


# --------------------------------------------------------- vs the reference
def test_pipelined_streams_equal_reference(ref_run, pipe_run):
    ref_streams, _ = ref_run
    streams, _ = pipe_run
    assert len(streams) == len(PROMPT_LENS)
    assert streams == ref_streams


def test_pipelined_logs_layout_and_row_maps_equal_reference(ref_run,
                                                            pipe_run):
    _, ref = ref_run
    _, eng = pipe_run
    assert _log(eng) == _log(ref)
    assert [e["mig_bytes"] for e in eng.migration_log] == \
        [e["mig_bytes"] for e in ref.migration_log]
    assert eng.controller._policy.search == "bottleneck"
    applied = [e for e in eng.migration_log
               if e["applied"] and e["n_migrations"]]
    assert applied, "bottleneck-mode migration was not applied"
    assert all(e["reason"] is None for e in applied)
    np.testing.assert_array_equal(eng.controller.perms, ref.controller.perms)
    np.testing.assert_array_equal(eng.controller.place, ref.controller.place)
    np.testing.assert_array_equal(eng._phys_perms, ref._phys_perms)
    np.testing.assert_array_equal(eng._head_rows, ref._head_rows)
    np.testing.assert_array_equal(eng._head_inv, ref._head_inv)
    for st in eng.states:
        np.testing.assert_array_equal(st["head_rows"].numpy(),
                                      eng._head_rows)


# ------------------------------------------------------------ inside the port
def test_pipelined_streams_equal_sequential(pipe_run, seq_run):
    """K = 2 with bottleneck-planned migrations applied to both groups'
    caches (and the shared weights once) gives the sequential,
    migration-free streams."""
    streams, eng = pipe_run
    seq, free = seq_run
    assert not free.migration_log
    assert streams == seq
    assert any(e["applied"] and e["n_migrations"]
               for e in eng.migration_log)


def test_intervals_fire_every_lam_times_k_steps(pipe_run):
    _, eng = pipe_run
    assert eng.migration_log
    assert all(e["step"] % (LAM * K) == 0 for e in eng.migration_log)
    assert eng.rows_per_group == 2 and len(eng.states) == K


def test_empty_group_is_a_bubble(setup):
    """One request sits in group 0: every other step (group 1's phase) is
    a bubble that launches and times nothing, and the request's stream is
    the sequential one."""
    _, cfg_t, prompts, params = setup
    eng = ServingEngine(cfg_t, n_slots=4, max_seq=48, lam=10 ** 9, seed=0,
                        pipeline_k=K, net=DeviceNetwork.sample(4, seed=1),
                        device="cpu", params=params_from_jax(params, "cpu"))
    seq = ServingEngine(cfg_t, n_slots=4, max_seq=48, lam=10 ** 9, seed=0,
                        net=DeviceNetwork.sample(4, seed=1), device="cpu",
                        params=params_from_jax(params, "cpu"))
    assert _drive(eng, prompts[:1]) == _drive(seq, prompts[:1])
    assert eng.decode_steps == 2 * len(eng.step_times) - 1
    assert eng.slot_busy_steps == len(eng.step_times)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_kernel_path_equals_plain_path(setup, pipe_run, paged_run, paged):
    """``use_kernel=True`` (the kernels' plain versions on the CPU) equals
    the model's own attention, dense and paged, with the same plans."""
    streams, eng = paged_run if paged else pipe_run
    kw = dict(paged=True, page_size=8) if paged else {}
    plain, peng = _port(setup, use_kernel=False, **kw)
    assert plain == streams
    assert _log(peng) == _log(eng)


def test_paged_pipelined_equals_dense_pipelined(pipe_run, paged_run):
    """Paged K = 2 (a page pool and allocator a group) gives the dense
    K = 2 streams, with migrations applied to every group's pool (the
    paged controller prices page-rounded memory, so its plans may differ
    from the dense engine's); every group's pool drains."""
    streams, _ = pipe_run
    paged, peng = paged_run
    assert paged == streams
    assert any(e["applied"] and e["n_migrations"]
               for e in peng.migration_log)
    assert len(peng.allocators) == K
    assert peng.kv_pages == peng.rows_per_group * peng.pages_per_slot
    for alloc in peng.allocators:
        alloc.check_invariants()
        assert alloc.live_pages == 0


def test_paged_pipelined_equals_reference(setup, ref_run):
    """The paged K = 2 engine against the reference's paged K = 2 engine."""
    cfg_j, _, prompts, _ = setup
    ref = JaxEngine(cfg_j, n_slots=4, max_seq=48, lam=LAM, seed=0,
                    pipeline_k=K, search="bottleneck", paged=True,
                    page_size=8, net=JaxNetwork.sample(4, seed=1))
    ref_streams = _drive(ref, prompts, STRAGGLE_AT)
    streams, eng = _port(setup, use_kernel=False, paged=True, page_size=8)
    assert streams == ref_streams
    assert _log(eng) == _log(ref)
    np.testing.assert_array_equal(eng.controller.perms, ref.controller.perms)
    assert [a.free_pages for a in eng.allocators] == \
        [a.free_pages for a in ref.allocators]


def test_construction_errors_match_the_reference(setup):
    _, cfg_t, _, _ = setup
    with pytest.raises(ValueError, match="divisible"):
        ServingEngine(cfg_t, n_slots=3, max_seq=48, pipeline_k=2,
                      device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        ServingEngine(cfg_t, n_slots=4, max_seq=48, pipeline_k=2,
                      greedy=False, device="cpu")
    with pytest.raises(ValueError, match="search"):
        ServingEngine(cfg_t, n_slots=4, max_seq=48, pipeline_k=2,
                      search="nope", device="cpu")
