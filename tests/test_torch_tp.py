"""The tensor-parallel head layout in the port, against the JAX package.

At a TP degree ``tp`` query heads are zero-padded to ``Hp`` and, where
``tp`` exceeds the KV heads, each KV head is repeated ``rep`` times into
``KvE`` cache rows (``layers.head_dims``).  On the same weights (the
reference's ``init`` at that ``tp`` through ``weights.params_from_jax``)
and the same seeded inputs, the port must give the reference's logits
(float32, ``atol=rtol=1e-5``), its engine the reference engine's greedy
streams and migration log (bytes ``× rep`` included), and migrations must
move every KV replica with its query heads (the counterparts of
``tests/test_pipelined.py``'s rep > 1 tests).  Configs: reduced llama3-8b
with 8 heads over 2 KV heads (rep 2 at tp 4), reduced qwen1.5-32b with 6
heads (padded to 8 at tp 4; QKV bias seeded nonzero on the 6 real rows),
the VLM's cross layers at rep 2 and zamba2's shared block at rep 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, get_config as jax_get_config
from repro.core.network import DeviceNetwork as JaxNetwork
from repro.models import layers as JL
from repro.models.api import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.network import DeviceNetwork
from repro_torch.core.placement_bridge import (apply_layer_head_perms,
                                               expand_kv_perms,
                                               permute_model_heads_layers)
from repro_torch.models import layers as L
from repro_torch.models.api import build_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.test_torch_zamba2 import seeded_ssm_params
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
TPS = (1, 2, 4, 8, 16)
ARCHS = sorted(set(ASSIGNED_ARCHS) | {"paper-gpt"})
T_MAX = 24

# name -> (arch, reduced_config overrides, tp)
CASES = {
    "llama rep 2": ("llama3-8b", dict(n_heads=8, d_head=8, n_kv_heads=2),
                    4),
    "qwen padded": ("qwen1.5-32b", dict(n_heads=6, d_head=8, n_kv_heads=6),
                    4),
    "vlm rep 2": ("llama-3.2-vision-11b", dict(n_kv_heads=2), 4),
    "zamba2 rep 2": ("zamba2-2.7b", dict(n_kv_heads=2), 4),
}


def _cfgs(arch, **over):
    cfg_j = reduced_config(arch, **over)
    return cfg_j, get_config(arch).with_overrides(**dataclasses.asdict(cfg_j))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _seed_case(name, cfg_j, params, hd):
    """Nonzero values where the reference's init leaves zeros that would
    hide a fault: QKV biases on the real heads (padded rows stay zero),
    the VLM's gates, zamba2's SSM parameters."""
    rng = np.random.default_rng(7)
    if cfg_j.qkv_bias:
        lay = dict(params["layers"])
        attn = dict(lay["attn"])
        for n, real in (("bq", hd.H), ("bk", hd.K), ("bv", hd.K)):
            b = np.zeros_like(attn[n])
            b[..., :real, :] = 0.5 * rng.standard_normal(
                b[..., :real, :].shape)
            attn[n] = b
        lay["attn"] = attn
        params = dict(params, layers=lay)
    if cfg_j.family == "vlm":
        cross = dict(params["cross_layers"])
        cross["attn"] = dict(cross["attn"],
                             gate=np.full_like(cross["attn"]["gate"], 0.7))
        cross["gate_ffn"] = np.full_like(cross["gate_ffn"], 0.5)
        params = dict(params, cross_layers=cross)
    if cfg_j.family == "hybrid":
        params = seeded_ssm_params(params)
    return params


_CACHE = {}


def _case(name):
    """(cfg_j, cfg_t, tp, numpy params) of a case: the reference's init at
    its tp, seeded where the init leaves zeros."""
    if name not in _CACHE:
        arch, over, tp = CASES[name]
        cfg_j, cfg_t = _cfgs(arch, **over)
        params = _np_tree(jax.jit(jax_build_model(cfg_j, tp=tp).init)(
            jax.random.PRNGKey(0)))
        hd = JL.head_dims(cfg_j, tp)
        _CACHE[name] = (cfg_j, cfg_t, tp,
                        _seed_case(name, cfg_j, params, hd))
    return _CACHE[name]


def _images(cfg, B, seed=0):
    """Right-padded image embeddings and mask: rows of 5, 8 and 0."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    mask = np.zeros((B, 8), bool)
    for b in range(B):
        mask[b, :(5, 8, 0)[b % 3]] = True
    return img, mask


# ------------------------------------------------------------- head dims
@pytest.mark.parametrize("arch", ARCHS)
def test_head_dims_equal_reference_at_every_tp(arch):
    cfg_j, cfg_t = jax_get_config(arch), get_config(arch)
    for tp in TPS:
        assert cfg_t.padded_heads(tp) == cfg_j.padded_heads(tp)
        assert cfg_t.expanded_kv_heads(tp) == cfg_j.expanded_kv_heads(tp)
        try:
            want = dataclasses.astuple(JL.head_dims(cfg_j, tp))
        except AssertionError:
            with pytest.raises(ValueError, match="GQA layout mismatch"):
                L.head_dims(cfg_t, tp)
            continue
        except ZeroDivisionError:
            # attention-free (rwkv6-7b: no KV heads) past tp 1
            with pytest.raises(ZeroDivisionError):
                L.head_dims(cfg_t, tp)
            continue
        got = L.head_dims(cfg_t, tp)
        assert dataclasses.astuple(got) == want
        assert got.groups == JL.head_dims(cfg_j, tp).groups


@pytest.mark.parametrize("arch,tp", [("qwen1.5-32b", 16), ("llama3-8b", 16),
                                     ("llama3-8b", 4)])
def test_full_width_layout_of_the_chip_configs(arch, tp):
    """The card's configs: llama3-8b at tp 16 stores 16 KV rows (8 heads
    twice), G 2; qwen1.5-32b pads 40 heads to 48, G 1."""
    hd = L.head_dims(get_config(arch), tp)
    want = {("qwen1.5-32b", 16): (40, 40, 48, 48, 1, 48),
            ("llama3-8b", 16): (32, 8, 32, 8, 2, 16),
            ("llama3-8b", 4): (32, 8, 32, 8, 1, 8)}[arch, tp]
    assert (hd.H, hd.K, hd.Hp, hd.Kp, hd.rep, hd.KvE) == want


# ------------------------------------------------------------------ init
@pytest.mark.parametrize("name", sorted(CASES))
def test_init_pads_with_exact_zeros_in_the_reference_tree(name):
    """The port's init draws the logical heads and zero-pads them: every
    attention leaf has the reference's shape, and the padded rows of
    ``wq``/``wk``/``wv``/``wo`` and the biases are exactly zero."""
    cfg_j, cfg_t, tp, _ = _case(name)
    model = build_model(cfg_t, tp=tp, device="cpu")
    got = model.init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(jax_build_model(cfg_j, tp=tp).init,
                          jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = {tuple(str(p.key) for p in path): leaf.shape
            for path, leaf in shapes}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), v

    leaves = dict(walk(got))
    assert {k: tuple(v.shape) for k, v in leaves.items()} == flat
    hd = model.hd
    for path, t in leaves.items():
        if "attn" not in path:
            continue
        name_ = path[-1]
        n_lead = t.dim() - {"wq": 3, "wk": 3, "wv": 3, "wo": 3, "bq": 2,
                            "bk": 2, "bv": 2}.get(name_, t.dim())
        axis = n_lead + (0 if name_ in ("wo", "bq", "bk", "bv") else 1)
        real = hd.H if name_ in ("wq", "wo", "bq") else hd.K
        if name_ in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
            pad = t.narrow(axis, real, t.shape[axis] - real)
            assert pad.numel() == 0 or not pad.any(), path
            live = t.narrow(axis, 0, real)
            if name_.startswith("w"):
                assert live.abs().sum() > 0, path


@pytest.mark.parametrize("tp", [4, 16])
def test_params_from_jax_takes_a_padded_tree_unchanged(tp):
    """The reference's padded tree (reduced qwen1.5-32b, 40 heads of 8:
    48 at tp 16, 40 at tp 4) reaches the port leaf for leaf, bit for
    bit, with its ``Hp``/``Kp`` rows."""
    cfg_j, _ = _cfgs("qwen1.5-32b", n_heads=40, d_head=8, n_kv_heads=40)
    params = _np_tree(jax_build_model(cfg_j, tp=tp).init(
        jax.random.PRNGKey(1)))
    got = params_from_jax(params, "cpu")
    hd = JL.head_dims(cfg_j, tp)
    assert tuple(got["layers"]["attn"]["wq"].shape) == (2, 64, hd.Hp, 8)
    assert tuple(got["layers"]["attn"]["bk"].shape) == (2, hd.Kp, 8)
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat_j:
        t = got
        for p in path:
            t = t[p.key]
        np.testing.assert_array_equal(t.numpy(), leaf)


# ---------------------------------------------------------------- logits
def _compiled(model):
    """The reference's lock-step prefill and decode step, compiled once
    each (the state donated, as the reference engine does)."""
    return tuple(jax.jit(f, donate_argnums=(1,))
                 for f in (model.prefill, model.decode_step))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_logits_equal_reference(name, use_kernel):
    cfg_j, cfg_t, tp, params = _case(name)
    mj = jax_build_model(cfg_j, tp=tp, use_kernel=use_kernel)
    mt = build_model(cfg_t, tp=tp, use_kernel=use_kernel, device="cpu")
    toks = np.random.default_rng(2).integers(
        0, cfg_j.vocab_size, (3, 9)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if cfg_j.family == "vlm":
        img, mask = _images(cfg_j, 3)
        kw_j = dict(img_embeds=jnp.asarray(img), img_mask=jnp.asarray(mask))
        kw_t = dict(img_embeds=torch.from_numpy(img),
                    img_mask=torch.from_numpy(mask))
    want, _ = jax.jit(mj.forward)(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(toks), **kw_j)
    got, _ = mt.forward(params_from_jax(params, "cpu"),
                        torch.from_numpy(toks), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_and_decode_logits_equal_reference(name, use_kernel):
    """Lock-step ``prefill`` then 4 ``decode_step``s; the cache holds the
    KvE expanded rows in both packages (bit-equal replicas)."""
    cfg_j, cfg_t, tp, params = _case(name)
    mj = jax_build_model(cfg_j, tp=tp, use_kernel=use_kernel)
    mt = build_model(cfg_t, tp=tp, use_kernel=use_kernel, device="cpu")
    pj = jax.tree.map(jnp.asarray, params)
    pt = params_from_jax(params, "cpu")
    B = 3
    kw_j, kw_t = {}, {}
    if cfg_j.family == "vlm":
        img, mask = _images(cfg_j, B, seed=4)
        kw_j = dict(img_embeds=jnp.asarray(img), img_mask=jnp.asarray(mask))
        kw_t = dict(img_embeds=torch.from_numpy(img),
                    img_mask=torch.from_numpy(mask))
    sj = mj.init_decode_state(pj, B, T_MAX, **kw_j)
    st = mt.init_decode_state(pt, B, T_MAX, **kw_t)
    toks = np.random.default_rng(3).integers(
        0, cfg_j.vocab_size, (B, 7)).astype(np.int32)
    prefill, step = _compiled(mj)
    lj, sj = prefill(pj, sj, jnp.asarray(toks))
    lt, st = mt.prefill(pt, st, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    hd = mt.hd
    if cfg_j.family != "hybrid":
        k = st["cache"]["k"]
        assert k.shape[-2] == hd.KvE
        if hd.rep > 1:
            # replica r of KV head o is expanded row o * rep + r
            kk = k.reshape(k.shape[:-2] + (hd.Kp, hd.rep, hd.dh))
            assert torch.equal(kk[..., :1, :].expand_as(kk), kk)
    for _ in range(4):
        nxt = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)
        lj, sj = step(pj, sj, jnp.asarray(nxt))
        lt, st = mt.decode_step(pt, st, torch.from_numpy(nxt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


# ---------------------------------------------- rep > 1 migration (engine)
LLAMA_REP2 = dict(n_heads=8, d_head=8, n_kv_heads=2)
PROMPT_LENS = (5, 11, 8, 14, 6)


def _engine_params(cfg_j, tp):
    """The reference engine's weights: its model's init at ``tp`` from
    PRNGKey(0)."""
    return _np_tree(jax.jit(jax_build_model(cfg_j, tp=tp).init)(
        jax.random.PRNGKey(0)))


def test_supergroup_perms_of_weights_and_rep2_cache_keep_the_logits():
    """Per-layer supergroup permutations (Hp // Kp = 4 heads) applied to
    the weights and, through ``expand_kv_perms``, to the rep-2 cache leave
    the next decode step's logits unchanged; the KV weights move by Kp
    rows, the cache by KvE rows."""
    cfg_j, cfg_t = _cfgs("llama3-8b", **LLAMA_REP2)
    eng = ServingEngine(cfg_t, n_slots=2, max_seq=48, lam=10 ** 9, seed=0,
                        tp=4, net=DeviceNetwork.sample(4, seed=1),
                        device="cpu",
                        params=params_from_jax(_engine_params(cfg_j, 4),
                                               "cpu"))
    hd = eng.model.hd
    assert (hd.rep, hd.Kp, hd.KvE) == (2, 2, 4)
    rng = np.random.default_rng(0)
    for n in (5, 9):
        eng.submit(rng.integers(0, 97, size=n), max_new_tokens=4)
    eng._admit()
    for _ in range(2):
        eng.step()
    nxt = torch.from_numpy(eng._next.copy())

    def clone(state):
        return {k: ({n: t.clone() for n, t in v.items()}
                    if isinstance(v, dict) else
                    v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in state.items()}

    ref, _ = eng.model.decode_step(eng.params, clone(eng.state), nxt)
    perms = np.array([[4, 5, 6, 7, 0, 1, 2, 3], np.arange(8)])
    np.testing.assert_array_equal(expand_kv_perms(np.array([[1, 0]]), 2),
                                  [[2, 3, 0, 1]])
    params2 = permute_model_heads_layers(eng.params, perms, group_size=4)
    assert torch.equal(params2["layers"]["attn"]["wk"][0],
                       eng.params["layers"]["attn"]["wk"][0][:, [1, 0]])
    state = clone(eng.state)
    k2, v2 = apply_layer_head_perms(state["cache"]["k"], state["cache"]["v"],
                                    perms, head_axis=-2, group_size=4, rep=2)
    assert not torch.equal(k2, state["cache"]["k"])
    assert torch.equal(k2[0], state["cache"]["k"][0][..., [2, 3, 0, 1], :])
    state["cache"].update(k=k2, v=v2)
    out, _ = eng.model.decode_step(params2, state, nxt)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


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
def rep2_runs():
    """The reference engine and the port's (with and without migrations),
    rep 2 at tp 4, the kernels on, 4 simulated devices, λ 3, a 500x
    straggler at step 4."""
    cfg_j, cfg_t = _cfgs("llama3-8b", **LLAMA_REP2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n) for n in PROMPT_LENS]
    ref = JaxEngine(cfg_j, n_slots=2, max_seq=64, lam=3, seed=0, tp=4,
                    net=JaxNetwork.sample(4, seed=1), use_kernel=True)
    ref_streams = _drive(ref, prompts, straggle_at=4)
    params = _engine_params(cfg_j, 4)

    def port(lam, straggle_at, **kw):
        eng = ServingEngine(cfg_t, n_slots=2, max_seq=64, lam=lam, seed=0,
                            tp=4, net=DeviceNetwork.sample(4, seed=1),
                            use_kernel=True, device="cpu",
                            params=params_from_jax(params, "cpu"), **kw)
        return _drive(eng, prompts, straggle_at), eng

    return ref, ref_streams, port(3, 4), port(10 ** 9, None)


def test_rep2_engine_streams_equal_reference_and_migration_free(rep2_runs):
    ref, ref_streams, (streams, eng), (free, free_eng) = rep2_runs
    assert len(streams) == len(PROMPT_LENS)
    assert streams == ref_streams == free
    applied = [e for e in eng.migration_log
               if e["applied"] and e["n_migrations"]]
    assert applied, "rep 2 migration was not applied"
    assert all(e["reason"] is None for e in applied)
    assert not free_eng.migration_log


def test_rep2_migration_log_equals_reference_with_bytes_times_rep(rep2_runs):
    ref, _, (_, eng), _ = rep2_runs
    keys = ("step", "n_migrations", "mig_bytes", "applied", "reason")
    assert [tuple(e[k] for k in keys) for e in eng.migration_log] == \
        [tuple(e[k] for k in keys) for e in ref.migration_log]
    np.testing.assert_array_equal(eng._phys_perms, ref._phys_perms)
    np.testing.assert_array_equal(eng._head_rows, ref._head_rows)
    np.testing.assert_array_equal(eng._head_inv, ref._head_inv)
    hd = eng.model.hd
    per_row = eng.n_slots * eng.max_seq * 2 * hd.dh * 4
    for e in eng.migration_log:
        if e["n_migrations"]:
            assert e["mig_bytes"] % (hd.rep * per_row) == 0
            assert e["mig_bytes"] >= hd.rep * per_row


def _paged_streams(cfg, prompts, *, paged, lam, straggle_at):
    eng = ServingEngine(cfg, n_slots=2, max_seq=64, lam=lam, seed=0, tp=4,
                        net=DeviceNetwork.sample(4, seed=1), use_kernel=True,
                        paged=paged, page_size=8, device="cpu")
    logits, inner = [], eng.model.decode_step

    def decode_step(params, state, tokens):
        out, state = inner(params, state, tokens)
        logits.append(out[eng._active()].clone())
        return out, state

    eng.model.decode_step = decode_step
    return _drive(eng, prompts, straggle_at), logits, eng


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
def test_paged_equals_dense_bit_for_bit_at_rep2(kv_quant):
    """A rep-2 paged engine (the page store's head axis at KvE, int8
    scales too) streams the dense engine's tokens with bit-equal logits
    at every step.  With a straggler both apply migrations and their
    streams stay equal to each other and to the migration-free run; the
    paged controller prices page-rounded memory, so its plans (and with
    them the order the o-projection sums its heads in) may differ from
    the dense one's, and the logits are then held to 1e-5."""
    _, cfg = _cfgs("llama3-8b", kv_quant=kv_quant, **LLAMA_REP2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32)
               for n in PROMPT_LENS[:4]]
    free = {}
    for paged in (True, False):
        free[paged] = _paged_streams(cfg, prompts, paged=paged,
                                     lam=10 ** 9, straggle_at=None)
    (got, got_logits, eng), (want, want_logits, _) = free[True], free[False]
    assert eng.state["cache"]["k"].shape[-2] == 4
    assert got == want and len(got) == 4
    assert len(got_logits) == len(want_logits)
    for x, y in zip(got_logits, want_logits):
        assert torch.equal(x, y)
    eng.allocator.check_invariants()
    moved = {}
    for paged in (True, False):
        moved[paged] = _paged_streams(cfg, prompts, paged=paged, lam=3,
                                      straggle_at=4)
        streams, logits, m_eng = moved[paged]
        assert streams == want
        assert any(e["applied"] and e["n_migrations"]
                   for e in m_eng.migration_log), "no migration applied"
    for x, y in zip(moved[True][1], moved[False][1]):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)
