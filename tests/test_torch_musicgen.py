"""musicgen-large (LayerNorm, GELU MLP with biases, MHA) and qwen1.5-32b
(QKV bias, MHA) in the port against the JAX package, on the same weights;
the registered configs; ``cost_cfg`` and ``layer_mode``; the edge_serve
and serve entry points.

Configs: ``reduced_config(name)`` — 2 layers, d_model 64, 4 heads of 16
over 4 KV heads, d_ff 128, vocab 97, float32.  Weights come from the
reference's ``init``; it leaves ``ln*_b``, ``b_up`` and ``b_down``
(musicgen) and ``bq``/``bk``/``bv`` (qwen) at zero, which would hide a
missing bias or one that does not move with its head, so both packages
get the same seeded nonzero values (0.5 N(0, 1)).  Every other input is
made with numpy from a seed.  Tolerances, float32: logits ``atol=rtol=
1e-4`` per step (the frameworks sum in different orders; at these extents
the reference's decode runs its jnp path and the port its kernel's plain
version, the same function), ``1e-5`` for a single layer's output.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_is_runnable as jax_cell_is_runnable
from repro.configs import get_config as jax_get_config
from repro.core.network import DeviceNetwork as JaxNetwork
from repro.models import layers as JL
from repro.models.api import build_model as jax_build_model
from repro.models.partitioning import NULL
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.engine import WaveServingEngine as JaxWave
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, cell_is_runnable,
                                 get_config, list_archs)
from repro_torch.core.network import DeviceNetwork
from repro_torch.core.placement_bridge import (apply_layer_head_perms,
                                               permute_model_heads_layers)
from repro_torch.models import layers as L
from repro_torch.models.api import batch_extras, build_model
from repro_torch.serving.engine import ServingEngine, make_engine
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
T_MAX = 32
PROMPT_LENS = (5, 11, 8, 14, 6)
ARCHS = ("musicgen-large", "qwen1.5-32b")
# the config modules of the reference that the port registers
PORTED = ("glm4-9b", "llama3-8b", "mixtral-8x22b", "mixtral-8x7b",
          "musicgen-large", "paper-gpt", "qwen1.5-110b", "qwen1.5-32b",
          "rwkv6-7b")


def _seeded(params, names, seed=7):
    """The numpy params with every leaf whose key is in ``names`` set to
    0.5 N(0, 1) from ``seed``."""
    rng = np.random.default_rng(seed)

    def visit(tree):
        return {k: visit(v) if isinstance(v, dict) else
                (0.5 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in names else v for k, v in tree.items()}

    return visit(params)


BIASES = {"musicgen-large": ("ln1_b", "ln2_b", "ln_f_b", "b_up", "b_down"),
          "qwen1.5-32b": ("bq", "bk", "bv"),
          "rwkv6-7b": ("u", "lora_B", "lw_B")}


def _setup(name, **over):
    cfg_j = reduced_config(name, **over)
    cfg_t = get_config(name).with_overrides(**dataclasses.asdict(cfg_j))
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0)))
    return cfg_j, cfg_t, _seeded(params, BIASES[name])


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    cfg_j, cfg_t, params = _setup(request.param)
    assert cfg_j.n_heads == cfg_j.n_kv_heads          # MHA
    return cfg_j, cfg_t, params


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("name", PORTED)
def test_config_equals_reference(name):
    """Field for field, and every derived property the port copied."""
    got, want = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for active in (False, True):
        assert got.param_count(active) == want.param_count(active)
    assert got.attention_free == want.attention_free
    assert got.full_attention_only == want.full_attention_only
    for tp in (1, 4, 16):
        assert got.padded_heads(tp) == want.padded_heads(tp)
        assert got.expanded_kv_heads(tp) == want.expanded_kv_heads(tp)
    for shape in SHAPES:
        assert cell_is_runnable(got, SHAPES[shape]) == \
            jax_cell_is_runnable(want, JAX_SHAPES[shape])


def test_registry_and_shapes_equal_reference():
    assert list_archs() == sorted(PORTED)
    assert set(ASSIGNED_ARCHS) <= set(JAX_ASSIGNED)
    assert set(JAX_ASSIGNED) - set(ASSIGNED_ARCHS) == {
        "llama-3.2-vision-11b", "zamba2-2.7b"}
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    assert [SHAPES[k].is_decode for k in SHAPES] == \
        [JAX_SHAPES[k].is_decode for k in SHAPES]


def test_musicgen_builds_at_full_width_and_wants_the_gpu():
    """``build_model`` takes the full musicgen-large (no weights are drawn
    until ``init``); without a device it wants the GPU."""
    cfg = get_config("musicgen-large")
    model = build_model(cfg, device="cpu")
    assert (model.hd.H, model.hd.KvE, model.hd.dh) == (32, 32, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)


def test_batch_extras():
    """The audio frontend is stubbed to the codec tokens: no extras; the
    VLM's inputs wait for its port."""
    cfg = get_config("musicgen-large")
    assert batch_extras(cfg, 2, torch.float32) == {}
    with pytest.raises(NotImplementedError, match="Queue 1 #13"):
        batch_extras(cfg.with_overrides(family="vlm"), 2, torch.float32)
    with pytest.raises(NotImplementedError, match="Queue 1 #13"):
        build_model(cfg.with_overrides(family="vlm"), device="cpu")


# -------------------------------------------------------------- layers
def test_layernorm_matches_reference():
    rng = np.random.default_rng(3)
    cfg = reduced_config("musicgen-large")
    x = rng.standard_normal((2, 5, 64), np.float32) * 3 + 1
    p = {"ln": rng.standard_normal(64).astype(np.float32),
         "ln_b": rng.standard_normal(64).astype(np.float32)}
    want = JL.apply_norm(cfg, jax.tree.map(jnp.asarray, p), "ln",
                         jnp.asarray(x))
    got = L.apply_norm(cfg, params_from_jax(p, "cpu"), "ln",
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_gelu_mlp_is_the_tanh_form():
    """The reference's ``jax.nn.gelu`` is the tanh approximation: the
    port's GELU MLP matches it at 1e-5, and the exact (erf) GELU, torch's
    default, does not."""
    rng = np.random.default_rng(4)
    cfg = reduced_config("musicgen-large")
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"w_up": rng.standard_normal((D, Fd)).astype(np.float32) / 4,
         "b_up": rng.standard_normal(Fd).astype(np.float32),
         "w_down": rng.standard_normal((Fd, D)).astype(np.float32),
         "b_down": rng.standard_normal(D).astype(np.float32)}
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    want = np.asarray(JL.mlp_block(cfg, jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), NULL))
    pt, xt = params_from_jax(p, "cpu"), torch.from_numpy(x)
    got = L.mlp_block(cfg, pt, xt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    exact = (F.gelu(xt @ pt["w_up"] + pt["b_up"]) @ pt["w_down"]
             + pt["b_down"]).numpy()
    assert not np.allclose(exact, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["musicgen-large", "rwkv6-7b"])
def test_tied_embeddings_match_reference(name):
    """``tie_embeddings`` (no registered config ties): the reference's init
    has no ``lm_head``, nor has the port's, and the logits come from the
    transposed ``tok_embed`` in both (the transformer and RWKV-6)."""
    cfg_j, cfg_t, params = _setup(name, tie_embeddings=True)
    assert "lm_head" not in params
    init = build_model(cfg_t, device="cpu").init(torch.Generator())
    assert "lm_head" not in init and "tok_embed" in init
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (2, 9))
    lj, _ = jax_build_model(cfg_j).forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(toks))
    lt = build_model(cfg_t, device="cpu").forward(
        params_from_jax(params, "cpu"), torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


# --------------------------------------------------------------- model
def _tree(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree(v, f"{pre}{k}."))
        else:
            out[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("tie", [False, True])
def test_init_draws_the_reference_tree(tie):
    """Same names, shapes and dtypes as the reference's init; the biases
    the reference zeroes are zero."""
    cfg_j = reduced_config("musicgen-large", tie_embeddings=tie)
    cfg_t = get_config("musicgen-large").with_overrides(
        **dataclasses.asdict(cfg_j))
    want = jax.eval_shape(jax_build_model(cfg_j).init, jax.random.PRNGKey(1))
    got = build_model(cfg_t, device="cpu").init(
        torch.Generator().manual_seed(1))
    assert _tree(got) == _tree(want)
    for name in ("ln1_b", "ln2_b"):
        assert not got["layers"][name].any()
    assert not got["layers"]["mlp"]["b_up"].any()
    assert not got["layers"]["mlp"]["b_down"].any()
    assert not got["ln_f_b"].any()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference(arch, use_kernel):
    cfg_j, cfg_t, params = arch
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
def test_staggered_slot_decode_matches_reference(arch, use_kernel):
    """prefill_bucketed -> insert_slot -> 6 decode_steps with prompts
    admitted at different steps, so slots decode at unequal depths."""
    cfg_j, cfg_t, params = arch
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


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("use_kernel", [False, True])
def test_per_layer_migrations_are_invisible(use_kernel):
    """Random, different head permutations per layer, applied to the
    weights (with the seeded LayerNorm and MLP biases, which stay) AND the
    cache, leave the next decode step's logits equal — the port's copy of
    the reference's engine-level invariance test."""
    cfg_j, cfg_t, params = _setup("musicgen-large")
    eng = ServingEngine(cfg_t, n_slots=2, max_seq=48, lam=10 ** 9, seed=0,
                        use_kernel=use_kernel, device="cpu",
                        params=params_from_jax(params, "cpu"))
    assert eng.cost.layer_mode == "graph"
    assert eng.controller.n_layers == cfg_t.n_layers
    rng = np.random.default_rng(0)
    for n in (5, 9):
        eng.submit(rng.integers(0, cfg_t.vocab_size, size=n),
                   max_new_tokens=4)
    for _ in range(2):                          # populate per-slot caches
        eng.step()
    tokens = torch.as_tensor(eng._next)
    want, _ = eng.model.decode_step(eng.params, _clone(eng.state), tokens)
    H = eng.state["cache"]["k"].shape[-2]
    perms = np.stack([rng.permutation(H) for _ in range(cfg_t.n_layers)])
    assert any(not np.array_equal(perms[l], perms[0])
               for l in range(cfg_t.n_layers))
    params2 = permute_model_heads_layers(eng.params, perms)
    state2 = _clone(eng.state)
    state2["cache"]["k"], state2["cache"]["v"] = apply_layer_head_perms(
        eng.state["cache"]["k"], eng.state["cache"]["v"], perms,
        head_axis=-2)
    got, _ = eng.model.decode_step(params2, state2, tokens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


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


def _engines(cfg_j, cfg_t, params, n_devices=2, cost_cfg=None, **kw):
    """The reference engine (the seeded weights installed after
    construction) and the port's on the same weights, both driven through
    the scenario of ``tests/test_torch_glm4.py``: 2 slots, λ = 3,
    ``DeviceNetwork.sample(n_devices, seed=1)``, a 500x straggler at step
    4.  ``kw`` (``layer_mode``) goes to both; ``cost_cfg`` names a config
    each package resolves from its own registry."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_j.vocab_size, size=n)
               for n in PROMPT_LENS]
    kw = dict(n_slots=2, max_seq=64, lam=3, seed=0, use_kernel=True, **kw)
    ref = JaxEngine(cfg_j, net=JaxNetwork.sample(n_devices, seed=1),
                    cost_cfg=cost_cfg and jax_get_config(cost_cfg), **kw)
    ref.params = jax.tree.map(jnp.asarray, params)
    eng = ServingEngine(cfg_t, net=DeviceNetwork.sample(n_devices, seed=1),
                        cost_cfg=cost_cfg and get_config(cost_cfg),
                        device="cpu", params=params_from_jax(params, "cpu"),
                        **kw)
    return (_drive(ref, prompts, 4), ref), (_drive(eng, prompts, 4), eng)


def _assert_same_run(want, got):
    (want_streams, ref), (streams, eng) = want, got
    assert len(streams) == len(PROMPT_LENS) and streams == want_streams
    keys = ("step", "n_migrations", "mig_bytes", "applied")
    assert [tuple(e[k] for k in keys) for e in eng.migration_log] == \
        [tuple(e[k] for k in keys) for e in ref.migration_log]
    assert any(e["applied"] and e["n_migrations"]
               for e in eng.migration_log), "no migration was applied"
    np.testing.assert_array_equal(eng._phys_perms, ref._phys_perms)
    np.testing.assert_array_equal(eng._head_rows, ref._head_rows)
    np.testing.assert_array_equal(eng._head_inv, ref._head_inv)


def test_engine_streams_and_migrations_equal_reference(arch):
    cfg_j, cfg_t, params = arch
    _assert_same_run(*_engines(cfg_j, cfg_t, params))


@pytest.mark.parametrize("layer_mode", ["graph", "columns"])
def test_cost_cfg_plans_equal_reference(layer_mode):
    """The controller priced at the full musicgen-large's widths: per-layer
    plans over the served depth ("graph"), or one plan over its 48 layers
    applied to every served layer ("columns"); streams, logs, physical
    perms and row maps equal the reference engine's.  Four simulated
    devices, one head each: on two, the columns plan keeps its layout."""
    cfg_j, cfg_t, params = _setup("musicgen-large")
    want, got = _engines(cfg_j, cfg_t, params, n_devices=4,
                         cost_cfg="musicgen-large", layer_mode=layer_mode)
    eng = got[1]
    assert eng.cost.d_model == 2048 and eng.cost.layer_mode == layer_mode
    assert eng.cost.n_layers == (2 if layer_mode == "graph" else 48)
    assert eng._phys_perms.shape[0] == (2 if layer_mode == "graph" else 1)
    assert eng._head_rows.shape[0] == cfg_t.n_layers
    _assert_same_run(want, got)


@pytest.mark.parametrize("layer_mode", ["graph", "columns"])
def test_wave_engine_takes_cost_cfg_and_layer_mode(layer_mode):
    """``make_engine(mode="wave")`` passes ``cost_cfg`` and ``layer_mode``
    to the wave scheduler: two waves of 6-token prompts, a 500x straggler
    on the device holding the most heads after 4 decode steps; streams and
    migration logs equal the reference's wave engine, with a migration
    applied."""
    cfg_j, cfg_t, params = _setup("musicgen-large")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_j.vocab_size, size=6) for _ in range(4)]
    kw = dict(n_slots=2, max_seq=32, lam=3, seed=0, use_kernel=True,
              layer_mode=layer_mode)

    def drive(eng):
        fired = []

        def sink(req, tok, done):
            if not fired and eng.decode_steps == 4:
                dev = int(eng.controller.head_counts().argmax())
                eng.net.inject_straggler(dev, slowdown=500.0)
                fired.append(True)

        eng.token_sink = sink
        for p in prompts:
            eng.submit(p, max_new_tokens=12)
        return {r.rid: r.out_tokens for r in eng.run()}

    ref = JaxWave(cfg_j, net=JaxNetwork.sample(4, seed=1),
                  cost_cfg=jax_get_config("musicgen-large"), **kw)
    ref.params = jax.tree.map(jnp.asarray, params)
    want = drive(ref)
    eng = make_engine(cfg_t, mode="wave", net=DeviceNetwork.sample(4, seed=1),
                      cost_cfg=get_config("musicgen-large"), device="cpu",
                      params=params_from_jax(params, "cpu"), **kw)
    assert eng.cost.d_model == 2048 and eng.cost.layer_mode == layer_mode
    got = drive(eng)
    assert len(got) == 4 and got == want
    keys = ("step", "n_migrations", "mig_bytes", "applied")
    assert [tuple(e[k] for k in keys) for e in eng.migration_log] == \
        [tuple(e[k] for k in keys) for e in ref.migration_log]
    assert any(e["applied"] and e["n_migrations"]
               for e in eng.migration_log), "no migration was applied"


def test_paged_streams_equal_dense():
    """Inside the port, bit for bit: the paged cache (pages of 8) streams
    the dense cache's tokens, with migrations applied in both."""
    _, cfg_t, params = _setup("musicgen-large")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_t.vocab_size, size=n)
               for n in PROMPT_LENS]
    runs = []
    for paged in (False, True):
        eng = ServingEngine(cfg_t, n_slots=2, max_seq=64, lam=3, seed=0,
                            net=DeviceNetwork.sample(2, seed=1),
                            use_kernel=True, device="cpu", paged=paged,
                            page_size=8,
                            params=params_from_jax(params, "cpu"))
        runs.append(_drive(eng, prompts, 4))
        assert any(e["applied"] and e["n_migrations"]
                   for e in eng.migration_log)
    assert len(runs[0]) == len(PROMPT_LENS) and runs[0] == runs[1]


# ---------------------------------------------------------- entry points
def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO)])}


def _edge_numbers(text):
    """(requests served, decode steps, migrated head blocks, (straggler,
    heads before, heads after)) as an edge_serve run prints them."""
    served = re.search(r"served (\d+) requests, (\d+) decode steps", text)
    migrated = re.search(r"migrated (\d+) head-blocks", text)
    heads = re.search(r"heads on straggler slot (\d+): (\d+) -> (\d+)", text)
    return (tuple(map(int, served.groups())), int(migrated.group(1)),
            tuple(map(int, heads.groups())))


def test_edge_serve_moves_the_reference_heads():
    """``repro_torch.launch.edge_serve --device cpu`` against the
    reference's ``examples/edge_serve.py`` (run here, ~12 s): the same
    requests and decode steps, the same migrated head blocks, and the
    straggler's head count going the same way (8 -> 0)."""
    ref = subprocess.run([sys.executable, "examples/edge_serve.py"],
                         env=_env(), cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.edge_serve", "--device",
         "cpu"], env=_env(), cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert port.returncode == 0, port.stderr
    got, want = _edge_numbers(port.stdout), _edge_numbers(ref.stdout)
    assert got == want
    assert got[2][1] > got[2][2] and got[1] > 0


def test_serve_cli_defaults_to_musicgen():
    """``repro_torch.launch.serve`` with no ``--arch`` serves musicgen-large,
    as the reference's does."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--layers", "2", "--requests", "3", "--tokens", "4",
         "--slots", "2", "--lam", "2", "--use-kernel", "--straggler", "0"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[serve] musicgen-large engine: ServingEngine" in out.stdout
    assert "3 requests, 12 tokens" in out.stdout
