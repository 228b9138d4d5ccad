"""GLM-4 in the port against the JAX package, on the same weights.

Config: ``reduced_config("glm4-9b", n_layers=3, n_kv_heads=2)`` — QKV bias,
RoPE over half of each head (rope_fraction 0.5), 4 query heads over 2 KV
heads, float32.  Weights come from the reference's ``init``; its ``bq``,
``bk`` and ``bv`` start at zero, which would hide a missing or unpermuted
bias, so both packages get the same seeded nonzero biases (0.5 N(0, 1)).
Every other input is made with numpy from a seed.  Tolerance on logits:
``atol=rtol=1e-4`` (float32; the frameworks sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.network import DeviceNetwork as JaxNetwork
from repro.models.api import build_model as jax_build_model
from repro.models.layers import apply_rope as jax_apply_rope
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.network import DeviceNetwork
from repro_torch.models.api import build_model
from repro_torch.models.layers import apply_rope
from repro_torch.serving.engine import ServingEngine
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
T_MAX = 32
PROMPT_LENS = (5, 11, 8, 14, 6)


def _with_biases(params, seed=7):
    """The numpy params with ``bq``/``bk``/``bv`` set to 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    attn = dict(params["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.5 * rng.standard_normal(attn[name].shape)).astype(
            attn[name].dtype)
    return dict(params, layers=dict(params["layers"], attn=attn))


@pytest.fixture(scope="module")
def glm():
    cfg_j = reduced_config("glm4-9b", n_layers=3, n_kv_heads=2)
    assert cfg_j.qkv_bias and cfg_j.rope_fraction == 0.5
    cfg_t = get_config("glm4-9b").with_overrides(**dataclasses.asdict(cfg_j))
    params = _with_biases(jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0))))
    return cfg_j, cfg_t, params


def test_config_equals_reference():
    from repro.configs import get_config as jax_get_config
    assert dataclasses.asdict(get_config("glm4-9b")) == \
        dataclasses.asdict(jax_get_config("glm4-9b"))


@pytest.mark.parametrize("fraction,dh", [(0.5, 16), (0.5, 10), (0.3, 16),
                                         (1.0, 16)])
def test_partial_rope_matches_reference(fraction, dh):
    """The first int(dh * fraction) dims, rounded down to even, rotate;
    the rest pass through unchanged."""
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 5, 3, dh), np.float32)
    pos = rng.integers(0, 50, (2, 5)).astype(np.int32)
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     10_000.0, fraction))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0,
                     fraction).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    rot = int(dh * fraction) // 2 * 2
    np.testing.assert_array_equal(got[..., rot:], x[..., rot:])


def test_init_makes_zero_biases_in_the_reference_shapes(glm):
    cfg_j, cfg_t, params = glm
    ref = jax_build_model(cfg_j).init(jax.random.PRNGKey(1))["layers"]["attn"]
    got = build_model(cfg_t, device="cpu").init(
        torch.Generator().manual_seed(1))["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        assert tuple(got[name].shape) == tuple(ref[name].shape)
        assert not got[name].any()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference(glm, use_kernel):
    cfg_j, cfg_t, params = glm
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (2, 9))
    lj, _ = jax_build_model(cfg_j).forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(toks))
    lt = build_model(cfg_t, use_kernel=use_kernel, device="cpu").forward(
        params_from_jax(params, "cpu"), torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def _compiled(model):
    """The reference's bucketed prefill and decode, compiled once (state
    donated, as the reference engine does)."""
    return (jax.jit(model.prefill_bucketed, donate_argnums=(1,)),
            jax.jit(model.decode_step, donate_argnums=(1,)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_staggered_slot_decode_matches_reference(glm, use_kernel):
    """prefill_bucketed -> insert_slot -> 6 decode_steps with prompts
    admitted at different steps, so slots decode at unequal depths."""
    cfg_j, cfg_t, params = glm
    params_j = jax.tree.map(jnp.asarray, params)
    params_t = params_from_jax(params, "cpu")
    mj = jax_build_model(cfg_j, use_kernel=use_kernel)
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    prefill_j, decode_j = _compiled(mj)
    B = 3
    sj = mj.init_decode_state(params_j, B, T_MAX, per_slot=True)
    st = mt.init_decode_state(params_t, B, T_MAX, per_slot=True)
    rng = np.random.default_rng(0)
    prompts = {0: rng.integers(0, cfg_j.vocab_size, 5),
               1: rng.integers(0, cfg_j.vocab_size, 11),
               2: rng.integers(0, cfg_j.vocab_size, 3)}
    admit_at = {0: 0, 1: 0, 2: 3}
    nxt = np.zeros(B, np.int32)
    for step in range(6):
        for slot, at in admit_at.items():
            if at != step:
                continue
            p = prompts[slot]
            Lb = 8 if len(p) <= 8 else 16
            toks = np.zeros((1, Lb), np.int32)
            toks[0, :len(p)] = p
            lj, subj = prefill_j(
                params_j, mj.init_decode_state(params_j, 1, Lb,
                                               per_slot=True),
                jnp.asarray(toks), jnp.asarray([len(p)], jnp.int32))
            lt, subt = mt.prefill_bucketed(
                params_t, mt.init_decode_state(params_t, 1, Lb,
                                               per_slot=True),
                torch.from_numpy(toks), torch.tensor([len(p)]))
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
            sj = mj.insert_slot(sj, subj, slot)
            st = mt.insert_slot(st, subt, slot)
            nxt[slot] = int(np.argmax(np.asarray(lj)[0]))
        lj, sj = decode_j(params_j, sj, jnp.asarray(nxt))
        lt, st = mt.decode_step(params_t, st, torch.from_numpy(nxt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        nxt = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)


# ------------------------------------------------------------ the engine
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
def runs(glm):
    """The scenario of ``tests/test_torch_engine.py`` on GLM-4: 2 slots,
    λ = 3, ``DeviceNetwork.sample(2, seed=1)``, a 500x straggler at step 4,
    ``use_kernel=True``; the reference engine serves the biased weights
    (installed after construction), the port the same through
    ``params_from_jax``."""
    cfg_j, cfg_t, params = glm
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_j.vocab_size, size=n)
               for n in PROMPT_LENS]
    ref = JaxEngine(cfg_j, n_slots=2, max_seq=64, lam=3, seed=0,
                    net=JaxNetwork.sample(2, seed=1), use_kernel=True)
    ref.params = jax.tree.map(jnp.asarray, params)
    ref_streams = _drive(ref, prompts, straggle_at=4)

    def port(lam, straggle_at, p=params):
        eng = ServingEngine(cfg_t, n_slots=2, max_seq=64, lam=lam, seed=0,
                            net=DeviceNetwork.sample(2, seed=1),
                            use_kernel=True, device="cpu",
                            params=params_from_jax(p, "cpu"))
        return _drive(eng, prompts, straggle_at), eng

    return ref, ref_streams, port


def test_engine_streams_and_migrations_equal_reference(runs):
    ref, ref_streams, port = runs
    streams, eng = port(3, 4)
    assert len(streams) == len(PROMPT_LENS) and streams == ref_streams
    keys = ("step", "n_migrations", "mig_bytes", "applied")
    assert [tuple(e[k] for k in keys) for e in eng.migration_log] == \
        [tuple(e[k] for k in keys) for e in ref.migration_log]
    assert any(e["applied"] and e["n_migrations"]
               for e in eng.migration_log), "no migration was applied"
    np.testing.assert_array_equal(eng._phys_perms, ref._phys_perms)
    np.testing.assert_array_equal(eng._head_rows, ref._head_rows)
    np.testing.assert_array_equal(eng._head_inv, ref._head_inv)


def test_biased_streams_unchanged_by_migrations(runs, glm):
    """Applied head migrations move ``bq`` with the query rows and
    ``bk``/``bv`` with their KV groups: the streams equal a migration-free
    run.  Left in place, the biases would sit on other heads than their
    weights and the streams would change."""
    _, _, port = runs
    moved, eng = port(3, 4)
    free, free_eng = port(10 ** 9, None)
    assert any(e["applied"] and e["n_migrations"]
               for e in eng.migration_log)
    assert not free_eng.migration_log
    assert moved == free
    # the biases did move: some layer's bq rows sit in another order
    bq0 = params_from_jax(glm[2], "cpu")["layers"]["attn"]["bq"]
    assert not torch.equal(eng.params["layers"]["attn"]["bq"], bq0)


@pytest.mark.parametrize("kv_quant,paged", [(False, True), (True, False),
                                            (True, True)],
                         ids=["paged", "int8", "int8_paged"])
def test_cache_engines_stream_and_migrate_as_reference(glm, kv_quant, paged):
    """The scenario of ``runs`` under the paged (pages of 8), int8 and
    int8-paged caches, in both packages: streams, migration log, physical
    layout and kernel row maps equal the reference's, with an applied
    migration, so the cache writes keep the biases' head moves."""
    cfg_j, cfg_t, params = glm
    cfg_j = cfg_j.with_overrides(kv_quant=kv_quant)
    cfg_t = cfg_t.with_overrides(kv_quant=kv_quant)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_j.vocab_size, size=n)
               for n in PROMPT_LENS]
    kw = dict(n_slots=2, max_seq=64, lam=3, seed=0, use_kernel=True,
              paged=paged, page_size=8)
    ref = JaxEngine(cfg_j, net=JaxNetwork.sample(2, seed=1), **kw)
    ref.params = jax.tree.map(jnp.asarray, params)
    want = _drive(ref, prompts, straggle_at=4)
    eng = ServingEngine(cfg_t, net=DeviceNetwork.sample(2, seed=1),
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
