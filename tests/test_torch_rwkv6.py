"""The port's RWKV-6 slice against the JAX package's: the WKV6 kernel's
plain version, ``layer_norm``, the model's forward and per-step decode
logits, and serving through ``make_engine(mode="auto")`` (the wave
engine, head plans logged as not applied).

Kernel inputs are made with numpy from a seed and handed to both; the JAX
kernel runs in interpret mode, as its own tests run it (the Pallas
kernel needs ``S % min(128, S) == 0``, so S <= 128 here).  Model tests
use ``reduced_config("rwkv6-7b")`` (4 heads of 16, 2 layers, float32) on
the reference's weights through ``weights.params_from_jax``, with ``u``,
``lora_B`` and ``lw_B`` — zero at the reference's init, which would hide
the bonus term and the data-dependent shift and decay — overwritten in
both packages' params with the same seeded values.  Tolerances (float32;
the two frameworks sum in different orders): kernels ``atol=rtol=1e-5``,
logits ``1e-4``.  The chunked form (``rwkv6_chunkwise_plain``, what the
CUDA kernel computes for 16 or more steps) is held to the same 1e-5
against the step-by-step form and the Pallas kernel: it regroups the
same float32 sums and takes its decay exponents in float64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_kernel import rwkv6_chunked as jax_rwkv6_chunked
from repro.models import layers as jlayers
from repro.models.api import build_model as jax_build_model
from repro.serving.engine import make_engine as jax_make_engine
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rwkv6 import (CHUNK, rwkv6_chunked,
                                      rwkv6_chunked_plain,
                                      rwkv6_chunkwise_plain)
from repro_torch.models import layers
from repro_torch.models.api import build_model
from repro_torch.models.rwkv6 import RWKV6Model
from repro_torch.serving.engine import (ServingEngine, UnsupportedArchError,
                                        WaveServingEngine, make_engine)
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_LOGITS = dict(atol=1e-4, rtol=1e-4)
LOG_KEYS = ("step", "n_migrations", "mig_bytes", "applied", "reason",
            "n_expert_migrations", "expert_applied")
NO_HEADS = "model has no addressable attention heads"


def _extreme_decays(rng, smooth):
    """Decays as the rwkv6 path meets them (exact 0.0, below 1e-30, exact
    1.0, above 0.999), mixed per element into ``smooth``: 0.0 (3 %),
    10^-30 to 10^-44 (3 %; below 1e-38 a float32 denormal), 1.0 (20 %),
    1 - 10^-3 x (0, 1] (40 %), else ``smooth``."""
    f = rng.random(smooth.shape)
    w = np.where(f < 0.66, 1.0 - 1e-3 * (0.66 - f) / 0.4, smooth)
    w = np.where(f < 0.26, 1.0, w)
    w = np.where(f < 0.06, 10.0 ** (-30.0 - 14.0 * (f - 0.03) / 0.03), w)
    return np.where(f < 0.03, 0.0, w).astype(np.float32)


def _wkv_inputs(B, H, S, dh, seed, zero_state=False, decays="smooth"):
    """r, k, v (0.5 N), w in (0.45, 0.95) (``decays="extreme"``: with the
    path's extremes mixed in, ``_extreme_decays``), u (0.1 N), state
    (0.1 N), as numpy float32 in the kernel's (B, H, S, dh) layout."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape, s=0.5: (s * rng.standard_normal(shape)).astype(
        np.float32)
    r, k, v = mk(B, H, S, dh), mk(B, H, S, dh), mk(B, H, S, dh)
    w = (0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((B, H, S, dh))))
         ).astype(np.float32)
    if decays == "extreme":
        w = _extreme_decays(rng, w)
    u = mk(H, dh, s=0.1)
    s0 = np.zeros((B, H, dh, dh), np.float32) if zero_state \
        else mk(B, H, dh, dh, s=0.1)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,H,S,dh,chunk", [
    (2, 3, 64, 16, 16),
    (1, 2, 128, 32, 32),
    (2, 1, 96, 64, 96),
])
def test_plain_matches_interpreted_pallas_kernel_and_refs(B, H, S, dh,
                                                          chunk):
    """``tests/test_kernels.py``'s shapes: the plain version (the wrapper
    on CPU tensors) against the Pallas kernel in interpret mode, the JAX
    oracle and the port's own oracle."""
    args = _wkv_inputs(B, H, S, dh, seed=S + dh)
    y_j, s_j = jax_rwkv6_chunked(*(jnp.asarray(a) for a in args),
                                 chunk=chunk, interpret=True)
    y_o, s_o = jref.rwkv6_ref(*(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a) for a in args]
    y, s = rwkv6_chunked(*targs)
    y_r, s_r = ref.rwkv6_ref(*targs)
    assert y.shape == (B, H, S, dh) and y.dtype == torch.float32
    for want_y, want_s in ((y_j, s_j), (y_o, s_o)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_allclose(y.numpy(), y_r.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), s_r.numpy(), **TOL)


def test_plain_state_chaining_equals_one_call():
    """Two calls, the second from the first's final state, equal one call
    over the whole sequence (the reference's chaining test), and the state
    may be written over its input."""
    B, H, S, dh = 1, 2, 64, 16
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _wkv_inputs(B, H, S, dh, seed=5, zero_state=True))
    y_full, s_full = rwkv6_chunked(r, k, v, w, u, s0)
    y_jax, s_jax = jax_rwkv6_chunked(
        *(jnp.asarray(t.numpy()) for t in (r, k, v, w, u, s0)), chunk=32,
        interpret=True)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(y_jax), **TOL)
    np.testing.assert_allclose(s_full.numpy(), np.asarray(s_jax), **TOL)
    half = S // 2
    state = s0.clone()
    y1, s1 = rwkv6_chunked(r[:, :, :half], k[:, :, :half], v[:, :, :half],
                           w[:, :, :half], u, state, out_state=state)
    y2, s2 = rwkv6_chunked(r[:, :, half:], k[:, :, half:], v[:, :, half:],
                           w[:, :, half:], u, state, out_state=state)
    assert s1 is state and s2 is state
    torch.testing.assert_close(torch.cat([y1, y2], dim=2), y_full, **TOL)
    torch.testing.assert_close(state, s_full, **TOL)
    assert not s0.any()                      # the input was not written


@pytest.mark.parametrize("decays", ["smooth", "extreme"])
@pytest.mark.parametrize("dh,S", [
    (16, 1), (16, CHUNK - 1), (16, CHUNK + 1), (16, 40),
    (32, CHUNK), (32, 3 * CHUNK + 5),
    (64, 1), (64, CHUNK - 1), (64, CHUNK + 1), (64, 4 * CHUNK),
])
def test_chunkwise_plain_matches_sequential_and_pallas(dh, S, decays):
    """The chunked form the CUDA kernel computes against the step-by-step
    plain version and the Pallas kernel in interpret mode: one step, a
    chunk less one, a chunk and one, ragged and whole several chunks; the
    extreme decays hold exact 0.0, values below 1e-30 (denormals too),
    exact 1.0 and values above 0.999, which a factored 2^L / 2^L form
    cannot take.  Every output is finite."""
    args = _wkv_inputs(2, 3, S, dh, seed=7 * S + dh, decays=decays)
    if decays == "extreme":
        w = args[3]
        assert (w == 0).any() and ((w > 0) & (w < 1e-30)).any() \
            and (w == 1).any() and ((w > 0.999) & (w < 1)).any()
    targs = [torch.from_numpy(a) for a in args]
    y, s = rwkv6_chunkwise_plain(*targs)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_seq, s_seq = rwkv6_chunked_plain(*targs)
    torch.testing.assert_close(y, y_seq, **TOL)
    torch.testing.assert_close(s, s_seq, **TOL)
    y_j, s_j = jax_rwkv6_chunked(*(jnp.asarray(a) for a in args),
                                 chunk=min(S, 128), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)


@pytest.mark.parametrize("split", [1, CHUNK, CHUNK + 3])
def test_chunkwise_plain_chains_state_in_place(split):
    """Two chunked calls, the second from the first's final state written
    over its input, equal one step-by-step call at the extreme decays."""
    B, H, S, dh = 2, 2, 3 * CHUNK + 7, 32
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(
        B, H, S, dh, seed=split, decays="extreme"))
    y_seq, s_seq = rwkv6_chunked_plain(r, k, v, w, u, s0)
    state = s0.clone()
    ys = [rwkv6_chunkwise_plain(r[:, :, a:b], k[:, :, a:b], v[:, :, a:b],
                                w[:, :, a:b], u, state, out_state=state)[0]
          for a, b in ((0, split), (split, S))]
    torch.testing.assert_close(torch.cat(ys, dim=2), y_seq, **TOL)
    torch.testing.assert_close(state, s_seq, **TOL)


def test_chunkwise_floor_keeps_zero_decays_finite():
    """A chunk whose decays are all exactly 0 (log2 w = -inf) forgets the
    state as the step-by-step form does; an unfloored L would give
    -inf - -inf = NaN in the pairwise differences."""
    B, H, S, dh = 1, 2, 2 * CHUNK, 16
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _wkv_inputs(B, H, S, dh, seed=3))
    w = torch.zeros_like(w)
    y, s = rwkv6_chunkwise_plain(r, k, v, w, u, s0)
    y_seq, s_seq = rwkv6_chunked_plain(r, k, v, w, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, y_seq, **TOL)
    torch.testing.assert_close(s, s_seq, **TOL)


def test_ops_rwkv6_in_model_layout_matches_reference():
    """``ops.rwkv6`` takes (B, S, H, dh) activations as strided views and
    returns y (B, S, H, dh), contiguous, as the reference's ``ops.rwkv6``
    (interpret mode); a bfloat16 u is read as float32."""
    B, H, S, dh = 2, 4, 12, 16
    *rkvw, u, s0 = _wkv_inputs(B, H, S, dh, seed=9)
    r, k, v, w = (a.transpose(0, 2, 1, 3) for a in rkvw)
    y_j, s_j = jops.rwkv6(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)),
                          interpret=True)
    y, s = ops.rwkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)))
    assert y.shape == (B, S, H, dh) and y.is_contiguous()
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)
    u16 = torch.from_numpy(u).to(torch.bfloat16)
    y16, _ = ops.rwkv6(*(torch.from_numpy(a) for a in (r, k, v, w)), u16,
                       torch.from_numpy(s0))
    want, _ = rwkv6_chunked_plain(
        *(torch.from_numpy(a).transpose(1, 2) for a in (r, k, v, w)),
        u16.float(), torch.from_numpy(s0))
    torch.testing.assert_close(y16, want.transpose(1, 2), **TOL)


def test_wrapper_rejects_mismatched_shapes():
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _wkv_inputs(1, 2, 4, 16, seed=1))
    with pytest.raises(ValueError, match="u must be"):
        rwkv6_chunked(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="w must be"):
        rwkv6_chunked(r, k, v, w[:, :, :2], u, s0)
    with pytest.raises(ValueError, match="state must be"):
        rwkv6_chunked(r, k, v, w, u, s0[:, :1])


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias), 1e-5)
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    assert layers.layer_norm(x16, torch.from_numpy(scale),
                             torch.from_numpy(bias), 1e-5).dtype \
        == torch.bfloat16


# ------------------------------------------------------------------ model
def _port_cfg(cfg_j):
    return get_config(cfg_j.name).with_overrides(**dataclasses.asdict(cfg_j))


def nonzero_adapters(params, seed=0):
    """The numpy params with ``u``, ``lora_B`` and ``lw_B`` set to seeded
    small random values (the reference's init leaves them at zero)."""
    rng = np.random.default_rng(seed)
    lay = dict(params["layers"])
    for name, scale in (("u", 0.5), ("lora_B", 0.1), ("lw_B", 0.5)):
        lay[name] = (scale * rng.standard_normal(lay[name].shape)).astype(
            lay[name].dtype)
    return dict(params, layers=lay)


@pytest.fixture(scope="module")
def rwkv():
    cfg_j = reduced_config("rwkv6-7b")
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0)))
    return cfg_j, nonzero_adapters(params)


def test_params_from_jax_carries_rwkv_leaves(rwkv):
    """The rwkv leaves arrive with the reference's names, shapes and
    values; the port's init draws the same tree."""
    cfg_j, params = rwkv
    got = params_from_jax(params, "cpu")
    L, D, H = cfg_j.n_layers, cfg_j.d_model, cfg_j.n_heads
    shapes = {"mix_mu": (L, 5, D), "lora_B": (L, 5, 32, D),
              "lw_B": (L, 64, D), "u": (L, H, D // H), "ln1_b": (L, D),
              "gn_bias": (L, D)}
    for name, shape in shapes.items():
        assert tuple(got["layers"][name].shape) == shape
        np.testing.assert_array_equal(got["layers"][name].numpy(),
                                      params["layers"][name])
    np.testing.assert_array_equal(got["ln_f_b"].numpy(), params["ln_f_b"])
    mine = build_model(_port_cfg(cfg_j), device="cpu").init(
        torch.Generator().manual_seed(0))
    for name, leaf in params["layers"].items():
        assert tuple(mine["layers"][name].shape) == leaf.shape, name
    assert set(mine) == set(params) and \
        set(mine["layers"]) == set(params["layers"])
    assert not mine["layers"]["u"].any() and not mine["layers"]["lw_B"].any()


def _models(cfg_j, use_kernel):
    ref_m = jax_build_model(cfg_j, use_kernel=use_kernel)
    mine = build_model(_port_cfg(cfg_j), use_kernel=use_kernel,
                       device="cpu")
    assert isinstance(mine, RWKV6Model) and mine.dh == 16
    return ref_m, mine


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_match_reference(rwkv, use_kernel):
    cfg_j, params = rwkv
    ref_m, mine = _models(cfg_j, use_kernel)
    tokens = np.random.default_rng(1).integers(0, 97, (2, 12)).astype(
        np.int32)
    want, _ = ref_m.forward(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(tokens))
    got = mine.forward(params_from_jax(params, "cpu"),
                       torch.from_numpy(tokens))
    assert got.shape == (2, 12, 97) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_LOGITS)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_logits_match_reference(rwkv, use_kernel):
    """Prefill 7 tokens, then 6 teacher-forced decode steps: the logits of
    every step match, so the token shifts carry across calls; decode
    after prefill equals the forward over the whole sequence."""
    cfg_j, params = rwkv
    ref_m, mine = _models(cfg_j, use_kernel)
    rng = np.random.default_rng(2)
    seq = rng.integers(0, 97, (3, 13)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, "cpu")
    j_state = ref_m.init_decode_state(jp, 3, 32)
    t_state = mine.init_decode_state(tp, 3, 32)
    want, j_state = ref_m.prefill(jp, j_state, jnp.asarray(seq[:, :7]))
    got, t_state = mine.prefill(tp, t_state, torch.from_numpy(seq[:, :7]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_LOGITS)
    steps = [got]
    for t in range(7, 13):
        want, j_state = ref_m.decode_step(jp, j_state, jnp.asarray(seq[:, t]))
        got, t_state = mine.decode_step(tp, t_state,
                                        torch.from_numpy(seq[:, t]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL_LOGITS)
        steps.append(got)
    assert t_state["pos"] == int(j_state["pos"]) == 13
    for name in ("shift_t", "shift_c", "wkv"):
        np.testing.assert_allclose(t_state["cache"][name].numpy(),
                                   np.asarray(j_state["cache"][name]),
                                   **TOL_LOGITS)
    full = mine.forward(tp, torch.from_numpy(seq))
    torch.testing.assert_close(torch.stack(steps, dim=1), full[:, 6:],
                               **TOL_LOGITS)


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
def test_make_engine_serves_like_the_reference(rwkv, use_kernel):
    """``make_engine(mode="auto")`` picks the wave engine in both
    packages; two waves with a straggler at step 3 stream the same greedy
    tokens with the same migration logs, and every plan that moved heads
    is logged as not applied, with the reference's reason."""
    cfg_j, params = rwkv
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 97, size=6).astype(np.int32)
               for _ in range(4)]
    kw = dict(mode="auto", n_slots=2, max_seq=32, lam=3, seed=0,
              use_kernel=use_kernel)
    ref_eng = jax_make_engine(cfg_j, **kw)
    ref_eng.params = jax.tree.map(jnp.asarray, params)
    want = _drive(ref_eng, prompts, 10, straggle_at=3)
    eng = make_engine(_port_cfg(cfg_j), device="cpu",
                      params=params_from_jax(params, "cpu"), **kw)
    assert type(eng).__name__ == type(ref_eng).__name__ \
        == "WaveServingEngine"
    assert eng.controller.cfg.heads_per_slot == 1       # 4 heads, 4 devices
    got = _drive(eng, prompts, 10, straggle_at=3)
    assert got == want and len(got) == 4
    assert all(len(t) == 10 for t in got.values())
    log = [tuple(e[k] for k in LOG_KEYS) for e in eng.migration_log]
    assert log == [tuple(e[k] for k in LOG_KEYS)
                   for e in ref_eng.migration_log]
    moved = [e for e in eng.migration_log if e["n_migrations"]]
    assert moved and all(not e["applied"] and e["reason"] == NO_HEADS
                         and e["mig_bytes"] == 0 for e in moved)
    assert all(e["reason"] is None for e in eng.migration_log
               if not e["n_migrations"])


def test_full_width_controller_places_64_heads_per_layer():
    """At rwkv6-7b's widths (depth cut to 1 layer) the engine's controller
    places the config's 64 heads per layer, 16 per device slot, in groups
    of 1, as the reference's does."""
    cfg = get_config("rwkv6-7b").with_overrides(
        n_layers=1, d_model=64, d_ff=64, vocab_size=16)
    assert cfg.n_heads == 64
    eng = WaveServingEngine(cfg, n_slots=1, max_seq=8, device="cpu")
    assert eng.controller.cfg.heads_per_slot == 16
    assert eng.controller.cfg.group_size == 1
    assert sum(b.kind == "head" for b in eng.controller.blocks) == 64
    assert eng._migration_bytes([(0, 1, 0, 1)]) == 0


def test_continuous_engine_refuses_rwkv6(rwkv):
    cfg = _port_cfg(rwkv[0])
    with pytest.raises(UnsupportedArchError, match="ssm archs"):
        ServingEngine(cfg, n_slots=2, max_seq=32, device="cpu")
    assert isinstance(make_engine(cfg, mode="wave", n_slots=2, max_seq=32,
                                  device="cpu"), WaveServingEngine)
    ref_cfg = jax_get_config("rwkv6-7b")
    assert get_config("rwkv6-7b") == _port_cfg(ref_cfg)
