"""The port's Zamba2 slice against the JAX package's: the Mamba-2 block's
pieces (``_causal_conv``, ``ssd_scan``, ``mamba_block``), the attention
kernels' plain versions at head width 80, the model's forward, prefill and
per-step decode logits with and without the kernels, the weight
conversion, and serving through ``make_engine(mode="auto")`` (the wave
engine; head plans logged as not applied, "state has no addressable KV
cache").

Model tests use ``reduced_config("zamba2-2.7b")`` (4 layers, a shared
block every 2: two supergroups; 4 heads of 16, float32) and a variant at
zamba2's head width (d_model 160, 2 heads of 80).  Both packages run the
reference's weights (``weights.params_from_jax``) with ``conv_b``,
``A_log``, ``dt_bias`` and ``D`` — zero, zero, zero and one at the
reference's init, which would hide a wrong conv bias, decay or skip —
overwritten with the same seeded values, ``A_log`` spread over [-6, 3]
so that the decays reach both near 1 and near 0.  Inputs are made with
numpy from a seed.  The reference's Pallas kernels run in interpret
mode, as its own tests run them.  Tolerances (float32; the two frameworks
sum in different orders): one block or kernel ``atol=rtol=1e-5``; the
model's logits, caches and states ``1e-4``, as the RWKV-6 tests hold
theirs: each block's own gap stays at a few float32 ulps (<= 6e-6 on
values of ~4), but it compounds down the residual stream, and the dh-80
variant's logits end 2.5e-5 apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import (
    decode_attention_resident as jax_decode_resident)
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import mamba2 as jmamba2
from repro.models.api import build_model as jax_build_model
from repro.models.partitioning import NULL
from repro.serving.engine import make_engine as jax_make_engine
from repro.serving.engine import supports_continuous as \
    jax_supports_continuous
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention_resident
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import mamba2
from repro_torch.models.api import build_model
from repro_torch.models.zamba2 import Zamba2Model
from repro_torch.serving.engine import (ServingEngine, UnsupportedArchError,
                                        WaveServingEngine, make_engine,
                                        supports_continuous)
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_LOGITS = dict(atol=1e-4, rtol=1e-4)
LOG_KEYS = ("step", "n_migrations", "mig_bytes", "applied", "reason",
            "n_expert_migrations", "expert_applied")
NO_CACHE = "state has no addressable KV cache"
# the reduced hybrid (the reference's own) and zamba2's head width
CONFIGS = {"reduced": {},
           "dh80": dict(d_model=160, n_heads=2, n_kv_heads=2, d_head=80)}


def _port_cfg(cfg_j):
    return get_config(cfg_j.name).with_overrides(**dataclasses.asdict(cfg_j))


def seeded_ssm_params(params, seed=0):
    """The numpy params with every mamba layer's ``conv_b`` (0.3 N),
    ``A_log`` (evenly over [-6, 3] across all the SSM heads, shuffled:
    decays exp(-exp(A_log) dt) from near 1 to near 0), ``dt_bias``
    (0.5 N) and ``D`` (1 + 0.5 N) set from a seed; the reference's init
    leaves them at 0, 0, 0 and 1."""
    rng = np.random.default_rng(seed)
    lay = dict(params["layers"])

    def spread(shape):
        return rng.permutation(np.linspace(-6.0, 3.0, int(np.prod(shape)))
                               ).reshape(shape)

    for name, draw in (
            ("conv_b", lambda s: 0.3 * rng.standard_normal(s)),
            ("A_log", spread),
            ("dt_bias", lambda s: 0.5 * rng.standard_normal(s)),
            ("D", lambda s: 1.0 + 0.5 * rng.standard_normal(s))):
        lay[name] = draw(lay[name].shape).astype(lay[name].dtype)
    return dict(params, layers=lay)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def zamba(request):
    cfg_j = reduced_config("zamba2-2.7b", **CONFIGS[request.param])
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0)))
    return cfg_j, seeded_ssm_params(params)


@pytest.fixture(scope="module")
def reduced():
    cfg_j = reduced_config("zamba2-2.7b")
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0)))
    return cfg_j, seeded_ssm_params(params)


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


# ------------------------------------------------------------ mamba pieces
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    """The conv from a zero history and from a carried tail: outputs and
    the new tail."""
    rng = np.random.default_rng(1 + with_state)
    B, S, C, cw = 2, 7, 24, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = (0.5 * rng.standard_normal((cw, C))).astype(np.float32)
    b = (0.3 * rng.standard_normal(C)).astype(np.float32)
    st = rng.standard_normal((B, cw - 1, C)).astype(np.float32) \
        if with_state else None
    want, want_st = jmamba2._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    got, got_st = mamba2._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_array_equal(got_st.numpy(), _np(want_st))
    # one token at a time through the carried tail equals the whole call
    tail = torch.zeros((B, cw - 1, C)) if st is None else \
        torch.from_numpy(st)
    steps = []
    for t in range(S):
        y, tail = mamba2._causal_conv(torch.from_numpy(x[:, t:t + 1]),
                                      torch.from_numpy(w),
                                      torch.from_numpy(b), tail)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, dim=1), got, **TOL)


@pytest.mark.parametrize("decays", ["near0", "near1", "mixed"])
def test_ssd_scan_matches_reference(decays):
    """The recurrence at decays near 0 (the state forgets every step),
    near 1 (it keeps everything) and mixed per head, from a nonzero
    state; the input state is not written."""
    rng = np.random.default_rng(len(decays))
    B, S, nh, dh, ns = 2, 9, 3, 8, 6
    xh = rng.standard_normal((B, S, nh, dh)).astype(np.float32)
    Bt = rng.standard_normal((B, S, ns)).astype(np.float32)
    Ct = rng.standard_normal((B, S, ns)).astype(np.float32)
    dtv = rng.uniform(0.1, 1.5, (B, S, nh)).astype(np.float32)
    lo, hi = {"near0": (1e-6, 1e-3), "near1": (0.999, 0.99999),
              "mixed": (1e-6, 0.99999)}[decays]
    a = rng.uniform(lo, hi, (B, S, nh)).astype(np.float32)
    h0 = rng.standard_normal((B, nh, dh, ns)).astype(np.float32)
    want_y, want_h = jmamba2.ssd_scan(*map(jnp.asarray,
                                           (xh, Bt, Ct, a, dtv, h0)))
    h0_t = torch.from_numpy(h0.copy())
    y, h = mamba2.ssd_scan(*map(torch.from_numpy, (xh, Bt, Ct, a, dtv)),
                           h0_t)
    np.testing.assert_allclose(y.numpy(), _np(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), _np(want_h), **TOL)
    np.testing.assert_array_equal(h0_t.numpy(), h0)


def _mamba_layer(params, l=(0, 1)):
    lp = jax.tree.map(lambda x: x[l], params["layers"])
    return lp, params_from_jax(lp, "cpu")


def test_mamba_block_whole_and_stepwise(zamba):
    """``mamba_block`` over a whole prompt, and as a 5-token prefill then
    per-token decode from the carried conv and SSM states: outputs and
    both states match the reference's, and the steps match the whole
    call."""
    cfg_j, params = zamba
    cfg = _port_cfg(cfg_j)
    lp_j, lp = _mamba_layer(params)
    B, S = 2, 9
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    zero_j = jmamba2.zero_mamba_state(cfg_j, B)
    want, want_st = jmamba2.mamba_block(cfg_j, lp_j, jnp.asarray(x), zero_j,
                                        NULL)
    zero = mamba2.zero_mamba_state(cfg, B)
    got, got_st = mamba2.mamba_block(cfg, lp, torch.from_numpy(x), zero)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(got_st[name].numpy(), _np(want_st[name]),
                                   **TOL)
    assert not zero["conv"].any() and not zero["ssm"].any()
    st_j, st = zero_j, zero
    outs = []
    for a, b in ((0, 5),) + tuple((t, t + 1) for t in range(5, S)):
        out_j, st_j = jmamba2.mamba_block(cfg_j, lp_j, jnp.asarray(x[:, a:b]),
                                          st_j, NULL)
        out, st = mamba2.mamba_block(cfg, lp, torch.from_numpy(x[:, a:b]),
                                     st)
        np.testing.assert_allclose(out.numpy(), _np(out_j), **TOL)
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(st[name].numpy(), _np(st_j[name]),
                                       **TOL)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, dim=1), got, **TOL)


def test_seeded_params_reach_both_decay_extremes(zamba):
    """The seeded ``A_log`` and ``dt_bias`` give decays below 1e-3 and
    above 0.99 in the model's own arithmetic, so the parity tests hold the
    decay at both ends."""
    cfg_j, params = zamba
    a_log = params["layers"]["A_log"]
    dtv = np.log1p(np.exp(params["layers"]["dt_bias"]))
    a = np.exp(-np.exp(a_log) * dtv)
    assert a.min() < 1e-3 and a.max() > 0.99
    assert params["layers"]["conv_b"].any()
    assert not np.allclose(params["layers"]["D"], 1.0)


# ------------------------------------------------- kernels at head width 80
@pytest.mark.parametrize("lengths", [(0, 1, 37), (64, 65, 48)])
def test_plain_decode_at_dh80_matches_interpreted_pallas(lengths):
    """The resident decode kernel's plain version at zamba2's head width
    (identity rows, G 1) against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(sum(lengths))
    B, H, KvE, T, dh = 3, 4, 4, 64, 80
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, KvE, T, dh)).astype(np.float32)
    v = rng.standard_normal((B, KvE, T, dh)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    rows = np.arange(H, dtype=np.int32)
    want = jax_decode_resident(*map(jnp.asarray, (q, k, v, lens, rows)),
                               interpret=True)
    got = decode_attention_resident(*map(torch.from_numpy,
                                         (q, k, v, lens, rows)))
    assert got.shape == (B, H, dh)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("causal,Sq,Skv", [(True, 96, 96), (False, 64, 64),
                                           (True, 64, 128)])
def test_plain_flash_at_dh80_matches_interpreted_pallas(causal, Sq, Skv):
    """The flash kernel's plain version at zamba2's head width (H == KvE)
    against the Pallas kernel in interpret mode (bq = bk = 32)."""
    rng = np.random.default_rng(Sq + Skv)
    B, H, dh = 2, 2, 80
    q = rng.standard_normal((B, H, Sq, dh)).astype(np.float32)
    k = rng.standard_normal((B, H, Skv, dh)).astype(np.float32)
    v = rng.standard_normal((B, H, Skv, dh)).astype(np.float32)
    want = pallas_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                        bq=32, bk=32, interpret=True)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ------------------------------------------------------------------ model
def test_params_from_jax_carries_the_zamba2_tree(zamba):
    """The reference's ``layers`` ((G, g, ...) leaves) and ``shared`` trees
    arrive with their names, shapes, dtypes and values; the port's init
    draws the same tree, with the reference's zero and one leaves."""
    cfg_j, params = zamba
    got = params_from_jax(params, "cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got))
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, want), (_, leaf) in zip(flat_j, flat_t):
        assert leaf.dtype == want.dtype
        np.testing.assert_array_equal(leaf, want)
    G, g = cfg_j.n_layers // cfg_j.shared_attn_every, cfg_j.shared_attn_every
    assert got["layers"]["w_in"].shape[:2] == (G, g) == (2, 2)
    assert got["shared"]["attn"]["wq"].shape == (
        cfg_j.d_model, cfg_j.n_heads, cfg_j.d_head)
    mine = build_model(_port_cfg(cfg_j), device="cpu").init(
        torch.Generator().manual_seed(0))
    shapes = lambda tree: jax.tree.map(lambda t: tuple(t.shape), tree)
    assert shapes(jax.tree.map(lambda t: t.numpy(), mine)) == shapes(params)
    lay = mine["layers"]
    assert not lay["conv_b"].any() and not lay["A_log"].any() \
        and not lay["dt_bias"].any() and bool((lay["D"] == 1).all())
    assert lay["A_log"].dtype == lay["D"].dtype == torch.float32


def _models(cfg_j, use_kernel):
    ref_m = jax_build_model(cfg_j, use_kernel=use_kernel)
    mine = build_model(_port_cfg(cfg_j), use_kernel=use_kernel, device="cpu")
    assert isinstance(mine, Zamba2Model) and mine.use_kernel == use_kernel
    assert (mine.n_groups, mine.group) == (2, 2)
    return ref_m, mine


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_match_reference(zamba, use_kernel):
    """The cacheless forward (the port's flash kernel's plain version with
    ``use_kernel``) against the reference's forward."""
    cfg_j, params = zamba
    ref_m, mine = _models(cfg_j, use_kernel)
    tokens = np.random.default_rng(1).integers(0, 97, (2, 12)).astype(
        np.int32)
    want, _ = ref_m.forward(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(tokens))
    got, _ = mine.forward(params_from_jax(params, "cpu"),
                          torch.from_numpy(tokens))
    assert got.shape == (2, 12, 97) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL_LOGITS)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_logits_match_reference(zamba, use_kernel):
    """Prefill 7 tokens, then 6 teacher-forced decode steps (the
    reference's Pallas decode kernel in interpret mode with
    ``use_kernel``): every step's logits, the position, the stacked
    attention cache and the mamba states match the reference's; decode
    after prefill equals the forward over the whole sequence."""
    cfg_j, params = zamba
    ref_m, mine = _models(cfg_j, use_kernel)
    seq = np.random.default_rng(2).integers(0, 97, (3, 13)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, "cpu")
    j_state = ref_m.init_decode_state(jp, 3, 32)
    t_state = mine.init_decode_state(tp, 3, 32)
    want, j_state = ref_m.prefill(jp, j_state, jnp.asarray(seq[:, :7]))
    got, t_state = mine.prefill(tp, t_state, torch.from_numpy(seq[:, :7]))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL_LOGITS)
    steps = [got]
    for t in range(7, 13):
        want, j_state = ref_m.decode_step(jp, j_state, jnp.asarray(seq[:, t]))
        got, t_state = mine.decode_step(tp, t_state,
                                        torch.from_numpy(seq[:, t]))
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL_LOGITS)
        steps.append(got)
    assert t_state["pos"] == int(j_state["pos"]) == 13
    jc, tc = j_state["cache"], t_state["cache"]
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["attn_cache"][name].numpy(),
                                   _np(jc["attn_cache"][name]),
                                   **TOL_LOGITS)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tc["mamba"][name].numpy(),
                                   _np(jc["mamba"][name]), **TOL_LOGITS)
    full, _ = mine.forward(tp, torch.from_numpy(seq))
    torch.testing.assert_close(torch.stack(steps, dim=1), full[:, 6:],
                               **TOL_LOGITS)


def test_each_supergroup_writes_its_own_cache_slice(reduced):
    """The shared block writes supergroup g's K/V through a view of the
    stacked (G, B, T, KvE, dh) buffer: after a prefill both supergroups'
    slices hold the prompt's K/V (different: their activations differ),
    the positions past it stay zero, and decode from that cache equals
    the forward.  A write that landed in a copy would leave a slice at
    zero and change the decode logits."""
    cfg_j, params = reduced
    mine = build_model(_port_cfg(cfg_j), device="cpu")
    tp = params_from_jax(params, "cpu")
    seq = torch.from_numpy(np.random.default_rng(5).integers(
        0, 97, (2, 8)).astype(np.int32))
    state = mine.init_decode_state(tp, 2, 16)
    k_buf = state["cache"]["attn_cache"]["k"]
    _, state = mine.prefill(tp, state, seq[:, :6])
    assert state["cache"]["attn_cache"]["k"] is k_buf
    for g in range(mine.n_groups):
        assert bool((k_buf[g, :, :6].abs().sum(-1) > 0).all())
        assert not k_buf[g, :, 6:].any()
    assert not torch.equal(k_buf[0, :, :6], k_buf[1, :, :6])
    logits = [mine.decode_step(tp, state, seq[:, t])[0] for t in (6, 7)]
    full, _ = mine.forward(tp, seq)
    torch.testing.assert_close(torch.stack(logits, 1), full[:, 6:],
                               **TOL_LOGITS)


def test_full_width_builds_and_wants_the_gpu():
    """``build_model`` takes the full zamba2-2.7b (no weights are drawn
    until ``init``): 9 supergroups of 6, the shared block's 32 q over 32
    KV heads of 80, Mamba-2 with 80 SSM heads of 64; without a device it
    wants the GPU."""
    cfg = get_config("zamba2-2.7b")
    model = build_model(cfg, device="cpu")
    assert isinstance(model, Zamba2Model)
    assert (model.n_groups, model.group) == (9, 6)
    assert (model.hd.H, model.hd.KvE, model.hd.dh) == (32, 32, 80)
    assert mamba2.mamba_dims(cfg) == (5120, 80, 64, 64, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    with pytest.raises(ValueError, match="supergroups"):
        Zamba2Model(cfg.with_overrides(n_layers=10), device="cpu")


# ---------------------------------------------------------------- serving
def _drive(eng, prompts, max_new, straggle_at):
    """Submit and run; at ``straggle_at`` decode steps a 500x straggler
    lands on the device holding the most heads (from the token hook,
    which the wave scheduler fires between its decode steps)."""
    fired = []

    def sink(req, tok, done):
        if not fired and eng.decode_steps == straggle_at:
            dev = int(np.argmax(eng.controller.head_counts()))
            eng.net.inject_straggler(dev, slowdown=500.0)
            fired.append(True)

    eng.token_sink = sink
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    out = {r.rid: r.out_tokens for r in eng.run()}
    assert fired
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("layer_mode", ["graph", "columns"])
def test_make_engine_serves_like_the_reference(reduced, layer_mode,
                                               use_kernel):
    """``make_engine(mode="auto")`` picks the wave engine in both
    packages; two waves with a straggler at step 3 stream the same greedy
    tokens with the same migration logs, and every plan that moved heads
    is logged as not applied, with the reference's reason, and permutes
    nothing."""
    cfg_j, params = reduced
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 97, size=6).astype(np.int32)
               for _ in range(4)]
    kw = dict(mode="auto", n_slots=2, max_seq=32, lam=3, seed=0,
              use_kernel=use_kernel, layer_mode=layer_mode)
    ref_eng = jax_make_engine(cfg_j, **kw)
    ref_eng.params = jax.tree.map(jnp.asarray, params)
    want = _drive(ref_eng, prompts, 10, straggle_at=3)
    tp = params_from_jax(params, "cpu")
    eng = make_engine(_port_cfg(cfg_j), device="cpu", params=tp, **kw)
    assert type(eng).__name__ == type(ref_eng).__name__ \
        == "WaveServingEngine"
    got = _drive(eng, prompts, 10, straggle_at=3)
    assert got == want and len(got) == 4
    assert all(len(t) == 10 for t in got.values())
    log = [tuple(e[k] for k in LOG_KEYS) for e in eng.migration_log]
    assert log == [tuple(e[k] for k in LOG_KEYS)
                   for e in ref_eng.migration_log]
    assert len(eng.interval_times) == len(eng.migration_log) \
        == len(ref_eng.migration_log) > 0
    moved = [e for e in eng.migration_log if e["n_migrations"]]
    assert moved and all(not e["applied"] and e["reason"] == NO_CACHE
                         for e in moved)
    assert all(e["reason"] is None for e in eng.migration_log
               if not e["n_migrations"])
    # nothing was permuted: the weights are the ones handed in
    for a, b in zip(jax.tree_util.tree_leaves(eng.params),
                    jax.tree_util.tree_leaves(params_from_jax(params,
                                                              "cpu"))):
        assert torch.equal(a, b)


def test_migrate_state_refuses_a_hybrid_state(reduced):
    """A plan handed to ``_migrate_state`` for a zamba2 decode state
    applies nothing, permutes neither the weights nor the cache, and
    gives the reference's reason."""
    cfg_j, params = reduced
    eng = WaveServingEngine(_port_cfg(cfg_j), n_slots=2, max_seq=16,
                            device="cpu",
                            params=params_from_jax(params, "cpu"))
    state = eng.model.init_decode_state(eng.params, 2, 16)
    _, state = eng.model.prefill(eng.params, state,
                                 torch.arange(10).reshape(2, 5) % 97)
    before = jax.tree.map(lambda t: t.clone(), state["cache"])
    wq = eng.params["shared"]["attn"]["wq"].clone()
    H = cfg_j.n_heads
    plan = {"prev_perms": np.arange(H)[None].repeat(cfg_j.n_layers, 0),
            "perms": np.roll(np.arange(H), 1)[None].repeat(cfg_j.n_layers,
                                                          0)}
    assert eng._migrate_state(state, plan) == (False, NO_CACHE)
    assert torch.equal(eng.params["shared"]["attn"]["wq"], wq)
    for a, b in zip(jax.tree_util.tree_leaves(state["cache"]),
                    jax.tree_util.tree_leaves(before)):
        assert torch.equal(a, b)


def test_continuous_engine_refuses_zamba2_as_the_reference_does(reduced):
    """The continuous engine refuses a hybrid with the reference's
    message, before building params."""
    cfg_j = reduced[0]
    want = jax_supports_continuous(cfg_j, 32)
    assert want is not None
    assert supports_continuous(_port_cfg(cfg_j), 32) == want
    with pytest.raises(UnsupportedArchError, match=want):
        ServingEngine(_port_cfg(cfg_j), n_slots=2, max_seq=32, device="cpu")
