"""The port's flash attention against the JAX package's Pallas kernel, and
where the model reaches it.

On the CPU the port's ``flash_attention`` runs its plain version (the
reference model's own ``attend`` arithmetic on aligned positions).  It is
held against the reference's Pallas ``flash_attention`` run in interpret
mode, as ``tests/test_kernels.py`` runs it (``bq = bk = 32``), and against
``ref.flash_attention_ref`` of both packages.  Inputs are made with numpy
from a seed.  Tolerances: float32 ``atol=rtol=1e-5`` (summation order
only); bfloat16 ``atol=2e-2`` after upcasting (the plain version rounds
the probabilities and the output to bfloat16, the Pallas kernel only the
output).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.attention_plain import (attention_scores,
                                                 causal_mask,
                                                 chunked_attention)
from repro_torch.kernels.flash_attention import (_check_kernel_inputs,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.serving.engine import ServingEngine, WaveServingEngine
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5),
        torch.bfloat16: dict(atol=2e-2, rtol=0.0)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# (B, H, KvE, Sq, Skv, dh, causal, window)
CASES = {
    "causal_mha": (2, 4, 4, 128, 128, 16, True, 0),
    "causal_gqa2": (2, 4, 2, 96, 96, 32, True, 0),
    "causal_gqa4": (1, 8, 2, 256, 256, 16, True, 0),
    "window": (2, 4, 2, 160, 160, 16, True, 48),
    "noncausal": (2, 4, 1, 64, 64, 32, False, 0),
    "short_q_causal": (1, 4, 2, 64, 192, 16, True, 0),
    "short_q_window": (1, 4, 4, 96, 160, 32, True, 40),
    "short_q_noncausal": (2, 4, 2, 32, 128, 16, False, 0),
}


def _inputs(B, H, KvE, Sq, Skv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, dh), np.float32),
            rng.standard_normal((B, KvE, Skv, dh), np.float32),
            rng.standard_normal((B, KvE, Skv, dh), np.float32))


def _as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_interpreted_pallas_kernel(case, dtype):
    B, H, KvE, Sq, Skv, dh, causal, window = CASES[case]
    arrays = _inputs(B, H, KvE, Sq, Skv, dh, seed=len(case))
    jq, jk, jv = (jnp.asarray(a, JNP[dtype]) for a in arrays)
    want = pallas_flash(jq, jk, jv, causal=causal, window=window, bq=32,
                        bk=32, interpret=True)
    want_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.shape == (B, H, Sq, dh) and got.dtype == dtype
    assert flash_attention.launches == before     # the CPU runs no kernel
    for other in (want, want_ref):
        np.testing.assert_allclose(got.float().numpy(), _as_np(other),
                                   **TOLS[dtype])
    port_ref = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(port_ref.float().numpy(), _as_np(want_ref),
                               **TOLS[dtype])


@pytest.mark.parametrize("extent", [100, 2048])
def test_plain_flash_is_the_models_attend_bit_for_bit(extent):
    """Below a KV extent of 2048 the plain version is ``attention_scores``
    under ``causal_mask``; at 2048 (a multiple of 1024) it is
    ``chunked_attention`` in 1024-key chunks — exactly, so a prefill
    through the wrapper on the CPU keeps the model's bits."""
    B, H, KvE, dh = 1, 4, 2, 16
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(B, H, KvE, extent, extent, dh, seed=extent))
    pos = torch.arange(extent, dtype=torch.int32)[None].expand(B, extent)
    qm, km, vm = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if extent >= 2048:
        want = chunked_attention(qm, km, vm, pos, pos, window=300,
                                 chunk=1024)
    else:
        want = attention_scores(qm, km, vm, causal_mask(pos, pos, 300))
    got = flash_attention_plain(q, k, v, causal=True, window=300)
    assert torch.equal(got.transpose(1, 2), want)


def test_bshd_wrapper_reads_views_and_matches_jax_twin():
    """``ops.flash_attention_bshd`` on model-layout views (q a transpose,
    k/v the first rows of a longer cache) equals the same call on
    contiguous copies, the JAX twin, and returns (B, S, H, dh) memory."""
    rng = np.random.default_rng(3)
    B, S, T, H, KvE, dh = 2, 40, 64, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, H, S, dh), np.float32)
                         ).transpose(1, 2)
    cache = torch.from_numpy(rng.standard_normal((2, B, T, KvE, dh),
                                                 np.float32))
    k, v = cache[0, :, :S], cache[1, :, :S]
    assert not q.is_contiguous() and not k.is_contiguous()
    out = ops.flash_attention_bshd(q, k, v, causal=True, window=16)
    copies = ops.flash_attention_bshd(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=True, window=16)
    assert out.shape == (B, S, H, dh) and out.is_contiguous()
    assert torch.equal(out, copies)
    want = jops.flash_attention_bshd(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=True, window=16, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               **TOLS[torch.float32])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 3, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple of KvE"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="v must have"):
        flash_attention(q[:, :2], k, k[:, :, :4])
    with pytest.raises(ValueError, match="window"):
        flash_attention(q[:, :2], k, k, window=-1)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(q[:, :2].to("meta"), k.to("meta"), k.to("meta"))


def test_kernel_input_check_refuses_unaligned_kv():
    """The check run before a launch: K/V whose position stride (129
    values) is not a multiple of 8, or whose base is not 16-byte aligned,
    are refused; transposed views of a model-layout cache pass."""
    cache = torch.zeros((1, 150, 2, 128), dtype=torch.bfloat16)
    q = torch.zeros((1, 8, 150, 128), dtype=torch.bfloat16)
    kv = cache.transpose(1, 2)
    _check_kernel_inputs(q, kv, kv)
    wide = torch.zeros((1, 150, 2, 129), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        _check_kernel_inputs(q, wide[..., :128].transpose(1, 2), kv)
    shifted = torch.zeros(150 * 2 * 128 + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="multiples of 8"):
        _check_kernel_inputs(q, kv, shifted.view(1, 150, 2, 128)
                             .transpose(1, 2))


def test_kernel_input_check_refuses_unaligned_q():
    """The bf16 wgmma body reads q through TMA as well: a q whose base is
    not 16-byte aligned, or whose head stride (129 values) is not a
    multiple of 8, is refused before a launch."""
    kv = torch.zeros((1, 150, 2, 128), dtype=torch.bfloat16).transpose(1, 2)
    shifted = torch.zeros(150 * 8 * 128 + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="multiples of 8"):
        _check_kernel_inputs(shifted.view(1, 150, 8, 128).transpose(1, 2),
                             kv, kv)
    wide = torch.zeros((1, 150, 8, 129), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        _check_kernel_inputs(wide[..., :128].transpose(1, 2), kv, kv)


# ------------------------------------------- where the model reaches it
def _port_cfg(cfg_j, **over):
    return get_config(cfg_j.name).with_overrides(
        **{**dataclasses.asdict(cfg_j), **over})


@pytest.fixture
def flash_calls(monkeypatch):
    calls = []
    orig = ops.flash_attention_bshd

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention_bshd", spy)
    return calls


def _serve(eng, prompts, max_new=4):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: r.out_tokens for r in eng.run()}


PROMPTS = [np.arange(1, 6), np.arange(3, 14), np.arange(2, 5)]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
def test_dense_bucketed_prefill_reaches_the_flash_wrapper(flash_calls,
                                                          kv_quant):
    """Every bucketed prefill runs the flash wrapper once per layer, over
    the bucket's keys (dequantized for int8), causal and unwindowed;
    decode never does, and without ``use_kernel`` nothing does."""
    cfg = _port_cfg(reduced_config("llama3-8b", n_kv_heads=2),
                    kv_quant=kv_quant)
    kw = dict(n_slots=2, max_seq=32, lam=10 ** 9, seed=0, device="cpu")
    plain = _serve(ServingEngine(cfg, **kw), PROMPTS)
    assert not flash_calls
    eng = ServingEngine(cfg, use_kernel=True, **kw)
    assert _serve(eng, PROMPTS) == plain
    buckets = [8, 16, 8]
    assert len(flash_calls) == len(PROMPTS) * cfg.n_layers
    for (qs, ks, kw_), Lb in zip(flash_calls[::cfg.n_layers], buckets):
        assert qs == (1, Lb, 4, 16) and ks == (1, Lb, 2, 16)
        assert kw_ == dict(causal=True, window=0)


def test_paged_chunk_prefill_keeps_the_plain_path(flash_calls):
    cfg = _port_cfg(reduced_config("llama3-8b", n_kv_heads=2))
    eng = ServingEngine(cfg, n_slots=2, max_seq=32, lam=10 ** 9, seed=0,
                        paged=True, page_size=8, use_kernel=True,
                        device="cpu")
    assert len(_serve(eng, PROMPTS)) == 3
    assert not flash_calls


def test_ring_prefill_reaches_the_flash_wrapper_with_its_window(
        flash_calls):
    """The wave engine's lock-step prefill over the ring's in-flight K/V
    (a 12-token wave past the window of 8) runs the wrapper once per
    layer with the window."""
    cfg = _port_cfg(reduced_config("mixtral-8x7b"))
    eng = WaveServingEngine(cfg, n_slots=2, max_seq=32, lam=10 ** 9, seed=0,
                            use_kernel=True, device="cpu")
    rng = np.random.default_rng(1)
    out = _serve(eng, [rng.integers(0, 97, 12) for _ in range(2)])
    assert len(out) == 2 and eng.model.cache_len(32) == 8
    assert [c[2] for c in flash_calls] == \
        [dict(causal=True, window=8)] * cfg.n_layers
    assert {c[1] for c in flash_calls} == {(2, 12, 4, 16)}


def test_cacheless_forward_reaches_the_flash_wrapper(flash_calls):
    from repro_torch.models.api import build_model
    cfg = _port_cfg(reduced_config("llama3-8b"))
    m = build_model(cfg, use_kernel=True, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 97, (2, 9)))
    got = m.forward(params, toks)
    assert len(flash_calls) == cfg.n_layers
    want = build_model(cfg, device="cpu").forward(params, toks)
    assert torch.equal(got, want)
