"""The port's Mixtral serving against the JAX package's engines: the wave
scheduler over the ring cache, the continuous engine over a linear cache
below the window, expert migrations applied mid-serve, and the engine
choice of ``make_engine``.

Both packages serve the reference's weights (``params_from_jax`` of the
reference engine's init at the same seed), greedy, on the same simulated
network.  Streams, migration logs and expert layouts are compared exactly;
inside the port, streams must also be bit-identical to a migration-free
run (migrations move data only).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.network import DeviceNetwork as JaxNetwork
from repro.models.api import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.engine import WaveServingEngine as JaxWave
from repro.serving.engine import make_engine as jax_make_engine
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.network import DeviceNetwork
from repro_torch.kernels import ops
from repro_torch.serving.engine import (ServingEngine, UnsupportedArchError,
                                        WaveServingEngine, make_engine,
                                        supports_continuous)
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

LOG_KEYS = ("step", "n_migrations", "mig_bytes", "n_expert_migrations",
            "expert_mig_bytes", "applied", "expert_applied")


def _port_cfg(cfg_j):
    return get_config(cfg_j.name).with_overrides(**dataclasses.asdict(cfg_j))


def _params(cfg_j):
    """The reference engine's weights at seed 0, as numpy."""
    return jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0)))


def _expert_straggler(eng, at):
    """After ``at`` decode steps, a 500x straggler on the device holding
    the most expert blocks (the reference's scenario)."""
    counts = np.zeros(eng.net.n_devices)
    for b in eng.controller.blocks:
        if b.kind == "expert":
            counts[int(eng.controller.place[b.index])] += 1
    eng.net.inject_straggler(int(counts.argmax()), slowdown=500.0)


def _drive_wave(eng, prompts, max_new, straggle_at=None):
    """Submit and run; the straggler lands from the token hook, which the
    wave scheduler fires between its decode steps."""
    fired = []

    def sink(req, tok, done):
        if straggle_at is not None and not fired \
                and eng.decode_steps == straggle_at:
            _expert_straggler(eng, straggle_at)
            fired.append(True)

    eng.token_sink = sink
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    out = {r.rid: r.out_tokens for r in eng.run()}
    assert fired or straggle_at is None
    return out


def _drive_continuous(eng, prompts, straggle_at=None):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=10 + 3 * (i % 2))
    while True:
        if straggle_at is not None and eng.decode_steps == straggle_at:
            _expert_straggler(eng, straggle_at)
        if not eng.step():
            break
    return {r.rid: r.out_tokens for r in eng.finished}


def _log(eng):
    return [tuple(e[k] for k in LOG_KEYS) for e in eng.migration_log]


# ------------------------------------------------------------ wave + ring
@pytest.fixture(scope="module")
def ring():
    cfg_j = reduced_config("mixtral-8x7b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=6).astype(np.int32)
               for _ in range(4)]
    return cfg_j, _params(cfg_j), prompts


@pytest.mark.parametrize("use_kernel", [False, True])
def test_wave_ring_streams_equal_reference(ring, use_kernel, monkeypatch):
    """Decode past the window (8) on the ring: the port's wave engine
    streams the reference's greedy tokens, with and without the ring
    kernel, and the kernel branch dispatched on every decode step of
    every layer."""
    cfg_j, params, prompts = ring
    kw = dict(n_slots=2, max_seq=32, lam=10 ** 9, seed=0,
              use_kernel=use_kernel)
    want = _drive_wave(JaxWave(cfg_j, **kw), prompts[:2], 12)
    calls = {"n": 0}
    orig = ops.decode_attention_ring_bshd

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(ops, "decode_attention_ring_bshd", spy)
    eng = WaveServingEngine(_port_cfg(cfg_j), device="cpu",
                            params=params_from_jax(params, "cpu"), **kw)
    got = _drive_wave(eng, prompts[:2], 12)
    assert got == want and len(got) == 2
    assert eng.model.cache_len(32) == 8
    assert calls["n"] == (eng.decode_steps * cfg_j.n_layers
                          if use_kernel else 0)


def test_wave_ring_applies_head_and_expert_migrations(ring):
    """Two waves with a straggler at step 4: streams, migration logs and
    the expert layout equal the reference's; at least one head and one
    expert migration were applied; and the streams equal a migration-free
    run of the port bit for bit."""
    cfg_j, params, prompts = ring
    kw = dict(n_slots=2, max_seq=32, seed=0, use_kernel=True)
    ref = JaxWave(cfg_j, lam=3, net=JaxNetwork.sample(2, seed=1), **kw)
    want = _drive_wave(ref, prompts, 12, straggle_at=4)
    eng = WaveServingEngine(_port_cfg(cfg_j), lam=3,
                            net=DeviceNetwork.sample(2, seed=1),
                            device="cpu", params=params_from_jax(params, "cpu"),
                            **kw)
    got = _drive_wave(eng, prompts, 12, straggle_at=4)
    free = _drive_wave(WaveServingEngine(
        _port_cfg(cfg_j), lam=10 ** 9, net=DeviceNetwork.sample(2, seed=1),
        device="cpu", params=params_from_jax(params, "cpu"), **kw),
        prompts, 12)
    assert got == want == free and len(got) == 4
    assert _log(eng) == _log(ref)
    assert any(e["applied"] and e["n_migrations"] for e in eng.migration_log)
    assert any(e["expert_applied"] and e["n_expert_migrations"]
               for e in eng.migration_log)
    np.testing.assert_array_equal(eng.controller.expert_perms,
                                  ref.controller.expert_perms)
    np.testing.assert_array_equal(
        eng.params["layers"]["moe"]["owner"].numpy(),
        np.asarray(ref.params["layers"]["moe"]["owner"]))


# ------------------------------------------ continuous, linear cache
def test_continuous_expert_migration_roundtrip_equals_reference():
    """The reference's scenario (``tests/test_expert_blocks.py``): a
    mixtral served below its window (64 > max_seq 48, so the cache stays
    linear) by the continuous engine, a straggler at step 4 on the
    expert-heavy device.  Streams, logs, the expert perms and the
    physical owner maps equal the reference's; streams equal a
    migration-free port run; the injected weights are not moved."""
    cfg_j = jax_get_config("mixtral-8x7b").with_overrides(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
        d_ff=64, vocab_size=97, sliding_window=64,
        dtype="float32", param_dtype="float32")
    params = _params(cfg_j)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n) for n in (5, 11, 8, 14, 6)]
    kw = dict(n_slots=2, max_seq=48, seed=0)
    ref = JaxEngine(cfg_j, lam=3, net=JaxNetwork.sample(2, seed=1), **kw)
    want = _drive_continuous(ref, prompts, straggle_at=4)
    given = params_from_jax(params, "cpu")
    before = given["layers"]["moe"]["w_gate"].clone()
    eng = ServingEngine(_port_cfg(cfg_j), lam=3,
                        net=DeviceNetwork.sample(2, seed=1), device="cpu",
                        params=given, **kw)
    got = _drive_continuous(eng, prompts, straggle_at=4)
    free = _drive_continuous(ServingEngine(
        _port_cfg(cfg_j), lam=10 ** 9, net=DeviceNetwork.sample(2, seed=1),
        device="cpu", params=params_from_jax(params, "cpu"), **kw), prompts)
    assert got == want == free and len(got) == 5
    assert _log(eng) == _log(ref)
    applied = [e for e in eng.migration_log
               if e["expert_applied"] and e["n_expert_migrations"]]
    assert applied and all(e["expert_reason"] is None for e in applied)
    np.testing.assert_array_equal(eng.controller.expert_perms,
                                  ref.controller.expert_perms)
    owner = eng.params["layers"]["moe"]["owner"].numpy()
    np.testing.assert_array_equal(
        owner, np.asarray(ref.params["layers"]["moe"]["owner"]))
    assert not np.array_equal(owner, np.tile(np.arange(4), (2, 1)))
    assert "owner" not in given["layers"]["moe"]
    assert given["layers"]["moe"]["w_gate"].equal(before)


# ----------------------------------------------------------- engine choice
def test_make_engine_chooses_as_the_reference_does():
    """``tests/test_serving.py``'s picker cases: a ring falls back to the
    wave engine and the continuous engine refuses it; a window above the
    served extent stays continuous; llama is continuous; rwkv6 and zamba2
    are refused by the continuous engine, and ``auto`` serves rwkv6 from
    the wave engine, as the reference does, while the port builds no
    zamba2."""
    moe = reduced_config("mixtral-8x7b")
    kw = dict(n_slots=2, lam=10 ** 9, seed=0)
    for max_seq, want in ((32, "WaveServingEngine"), (7, "ServingEngine")):
        ref = jax_make_engine(moe, max_seq=max_seq, **kw)
        eng = make_engine(_port_cfg(moe), max_seq=max_seq, device="cpu",
                          **kw)
        assert type(ref).__name__ == type(eng).__name__ == want
        assert (supports_continuous(_port_cfg(moe), max_seq) is None) \
            == (want == "ServingEngine")
    with pytest.raises(UnsupportedArchError, match="WaveServingEngine"):
        ServingEngine(_port_cfg(moe), max_seq=32, device="cpu", **kw)
    assert isinstance(make_engine(_port_cfg(moe), mode="continuous",
                                  max_seq=7, device="cpu", **kw),
                      ServingEngine)
    assert isinstance(make_engine(_port_cfg(moe), mode="wave", max_seq=7,
                                  device="cpu", **kw), WaveServingEngine)
    assert supports_continuous(_port_cfg(moe)) is not None
    dense = _port_cfg(reduced_config("llama3-8b"))
    assert isinstance(make_engine(dense, max_seq=32, device="cpu", **kw),
                      ServingEngine)
    for arch in ("rwkv6-7b", "zamba2-2.7b"):
        cfg = ModelConfig(**dataclasses.asdict(reduced_config(arch)))
        assert supports_continuous(cfg, 32) is not None
        with pytest.raises(NotImplementedError):
            ServingEngine(cfg, max_seq=32, device="cpu", **kw)
        if arch == "rwkv6-7b":
            ref = jax_make_engine(reduced_config(arch), max_seq=32, **kw)
            eng = make_engine(cfg, max_seq=32, device="cpu", **kw)
            assert type(ref).__name__ == type(eng).__name__ \
                == "WaveServingEngine"
        else:
            with pytest.raises(NotImplementedError, match="Queue 1 #14"):
                make_engine(cfg, max_seq=32, device="cpu", **kw)
    with pytest.raises(ValueError, match="mode"):
        make_engine(dense, mode="waves", max_seq=32, device="cpu", **kw)
