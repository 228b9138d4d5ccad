"""The port's ServingEngine against the JAX package's on one scenario.

Scenario (the reference's own kernel-placement acceptance test): a
reduced GQA ``llama3-8b`` (3 layers, 2 KV heads), 2 simulated devices,
λ = 3, a 500x straggler injected at decode step 4 on the device holding
the most heads, prompts of lengths (5, 11, 8, 14, 6).  Both engines run
``use_kernel=True`` on the same weights (the reference's ``init`` through
``weights.params_from_jax``).  Greedy streams, the migration log, the
applied physical layout and the kernel gather maps must be equal: the
controller is a numpy copy and the model matches to 1e-4.
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
def runs():
    cfg_j = reduced_config("llama3-8b", n_layers=3, n_kv_heads=2)
    cfg_t = get_config("llama3-8b").with_overrides(
        **dataclasses.asdict(cfg_j))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n) for n in PROMPT_LENS]
    ref = JaxEngine(cfg_j, n_slots=2, max_seq=64, lam=3, seed=0,
                    net=JaxNetwork.sample(2, seed=1), use_kernel=True)
    ref_streams = _drive(ref, prompts, straggle_at=4)
    # the reference engine draws its weights from PRNGKey(seed)
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0)))

    def port(lam, straggle_at):
        eng = ServingEngine(cfg_t, n_slots=2, max_seq=64, lam=lam, seed=0,
                            net=DeviceNetwork.sample(2, seed=1),
                            use_kernel=True, device="cpu",
                            params=params_from_jax(params, "cpu"))
        eng.sunk = []
        eng.token_sink = lambda req, tok, done: eng.sunk.append(
            (req.rid, tok, done))
        return _drive(eng, prompts, straggle_at), eng

    return ref, ref_streams, port(3, 4), port(10 ** 9, None)


def test_greedy_streams_equal_reference(runs):
    _, ref_streams, (streams, _), _ = runs
    assert len(streams) == len(PROMPT_LENS)
    assert streams == ref_streams


def test_migration_log_layout_and_row_maps_equal_reference(runs):
    ref, _, (_, eng), _ = runs
    keys = ("step", "n_migrations", "mig_bytes", "applied")
    assert [tuple(e[k] for k in keys) for e in eng.migration_log] == \
        [tuple(e[k] for k in keys) for e in ref.migration_log]
    assert any(e["applied"] and e["n_migrations"]
               for e in eng.migration_log), "no migration was applied"
    np.testing.assert_array_equal(eng._phys_perms, ref._phys_perms)
    np.testing.assert_array_equal(eng._head_rows, ref._head_rows)
    np.testing.assert_array_equal(eng._head_inv, ref._head_inv)


def test_streams_unchanged_by_migrations(runs):
    """The port's own migration-free run produces the same streams: a
    migration moves heads, never the model's function."""
    _, _, (streams, _), (free_streams, free) = runs
    assert not free.migration_log
    assert free_streams == streams


def test_token_sink_sees_every_token_then_done(runs):
    _, _, (streams, eng), _ = runs
    for rid, toks in streams.items():
        events = [(tok, done) for r, tok, done in eng.sunk if r == rid]
        assert events == [(t, False) for t in toks] + [(None, True)]


def _tiny(**over):
    return get_config("llama3-8b").with_overrides(
        n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
        vocab_size=50, dtype="float32", param_dtype="float32", **over)


def test_sampling_is_seeded():
    """Non-greedy decoding draws from the engine's seeded generator: the
    same seed gives the same streams, another seed other streams."""
    prompts = [np.arange(1, 6), np.arange(7, 10)]

    def streams(seed):
        eng = ServingEngine(_tiny(), n_slots=2, max_seq=32, seed=seed,
                            greedy=False, device="cpu")
        return _drive(eng, prompts, straggle_at=None)

    assert streams(3) == streams(3) != streams(4)


@pytest.mark.parametrize("over,kw,item", [
    # a window the served extent reaches keeps a ring cache, which the
    # continuous engine refuses, naming the wave engine that serves it
    pytest.param({"sliding_window": 16}, {}, "WaveServingEngine",
                 id="over2-kw2-#12"),
])
def test_unported_options_raise_naming_their_roadmap_item(over, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        ServingEngine(_tiny(**over), n_slots=2, max_seq=32, device="cpu",
                      **kw)


def test_unknown_search_mode_raises_at_construction():
    """A typo in ``search`` must not silently serve the rescoring planner
    the caller opted out of."""
    with pytest.raises(ValueError, match="search must be one of"):
        ServingEngine(_tiny(), n_slots=2, max_seq=32, device="cpu",
                      search="nope")


@pytest.mark.parametrize("k", [1, 2])
def test_bottleneck_search_serves_at_any_depth(k):
    """``search="bottleneck"`` builds the bottleneck policy only on the
    pipelined objective (k > 1); at k = 1 the controller keeps the
    rescoring path, as the reference's does."""
    eng = ServingEngine(_tiny(), n_slots=2, max_seq=32, device="cpu",
                        pipeline_k=k, search="bottleneck")
    assert (eng.controller._policy is not None) == (k > 1)
    streams = _drive(eng, [np.arange(1, 6), np.arange(7, 10)],
                     straggle_at=None)
    assert sorted(streams) == [0, 1]
