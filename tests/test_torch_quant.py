"""int8 weights and the identity-row decode wrappers in the port, against
the JAX package on the same weights.

Configs: ``reduced_config`` of llama3-8b, glm4-9b, mixtral-8x7b (4
experts, window 8), musicgen-large, llama-3.2-vision-11b (5 layers: the
(G, 4, ...) self stacks and (G, ...) cross stacks; gates 0.7 / 0.5, zero
at init) and zamba2-2.7b (4 layers, the shared block every 2), float32.
Weights come from the reference's ``init`` and reach the port through
``weights.params_from_jax``; inputs are made with numpy from a seed.

Tolerances: ``quantize_weight``, ``dequantize_weight`` and
``quantize_params`` bit for bit (the same float32 arithmetic: a maximum,
one division, round half to even, a clip); logits with quantized weights
``atol=rtol=1e-4`` (float32; the frameworks sum in different orders),
an int8 KV cache included; the quantized model against its float weights, the
reference's own bounds (0.08 relative, top-1 agreement > 0.9 for the MoE);
the decode wrappers' plain versions against the interpreted Pallas
kernels ``atol=rtol=2e-5`` (the reference's kernel tests' float32 bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ops as jops
from repro.kernels.decode_attention import (
    decode_attention as jax_decode_attention,
    decode_attention_int8 as jax_decode_attention_int8)
from repro.models import quantization as jq
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models import quantization as q
from repro_torch.models.api import build_model
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)
FAMILIES = ["llama3-8b", "glm4-9b", "mixtral-8x7b", "musicgen-large",
            "llama-3.2-vision-11b", "zamba2-2.7b"]
I_IMG = 6
T_MAX = 24


def _port_cfg(cfg_j):
    return get_config(cfg_j.name).with_overrides(**dataclasses.asdict(cfg_j))


def _reference_params(cfg_j, seed=0):
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(seed)))
    if cfg_j.family == "vlm":
        cross = dict(params["cross_layers"])
        cross["attn"] = dict(cross["attn"],
                             gate=np.full_like(cross["attn"]["gate"], 0.7))
        cross["gate_ffn"] = np.full_like(cross["gate_ffn"], 0.5)
        params = dict(params, cross_layers=cross)
    return params


_SETUPS = {}


def _setup(arch, **over):
    """(reference config, port config, numpy params), cached per case."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _SETUPS:
        cfg_j = reduced_config(arch, **over)
        _SETUPS[key] = (cfg_j, _port_cfg(cfg_j), _reference_params(cfg_j))
    return _SETUPS[key]


def _assert_trees_equal(got, want, path=""):
    """Port tree == reference tree: same keys, every leaf equal bit for
    bit (int8 values, float32 scales and the leaves left as they were)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    w = np.asarray(want)
    g = got.float().numpy() if got.dtype == torch.bfloat16 \
        else got.numpy()
    assert g.shape == w.shape, (path, g.shape, w.shape)
    np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=path)
    assert str(got.dtype).split(".")[1] == w.dtype.name, (path, got.dtype)


# ------------------------------------------------------ (a) the bits
def _weights(dtype, seed=0):
    """Weights in the layouts the models quantize, with one column of exact
    half-integers (scale 1: round half to even decides them) and one all
    zero (the 1e-8 floor)."""
    rng = np.random.default_rng(seed)
    cases = []
    for shape, base in (((4, 64, 8, 16), 3), ((64, 32), 2),
                        ((2, 4, 16, 8), 2), ((3, 4, 16, 32), 3),
                        ((16, 4, 8), 3)):
        w = (0.3 * rng.standard_normal(shape)).astype(np.float32)
        w[..., 0] = 0.0
        col = np.zeros(shape[:-1], np.float32)
        col.reshape(-1)[:4] = [127.0, 2.5, -3.5, 0.5]
        w[..., 1] = col
        cases.append((jnp.asarray(w, dtype), base))
    return cases


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_weight_give_the_reference_bits(dtype):
    for w, base in _weights(getattr(jnp, dtype)):
        want = jq.quantize_weight(w, base)
        got = q.quantize_weight(params_from_jax(np.asarray(w), "cpu"), base)
        _assert_trees_equal(got, jax.tree.map(np.asarray, want))
        for out in (jnp.float32, jnp.bfloat16):
            tout = getattr(torch, jnp.dtype(out).name)
            _assert_trees_equal(q.dequantize_weight(got, tout),
                                np.asarray(jq.dequantize_weight(want, out)))
    # the crafted column: scale exactly 1, halves to even
    w = np.zeros((8, 4), np.float32)
    w[:4, 1] = [127.0, 2.5, -3.5, 0.5]
    got = q.quantize_weight(torch.from_numpy(w), 2)
    assert got["q8"][:4, 1].tolist() == [127, 2, -4, 0]
    assert got["sc"][1].item() == 1.0 and got["sc"][0].item() == np.float32(
        1e-8) / np.float32(127.0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_quantize_params_gives_the_reference_tree(arch):
    """Every quantized leaf's q8 and sc (the moe base-3 rule, the VLM's
    (G, 4, ...) stacks, zamba2's unstacked shared block) and every other
    leaf equal the reference's bit for bit."""
    cfg_j, _, params = _setup(arch)
    want = jax.tree.map(np.asarray, jq.quantize_params(
        jax.tree.map(jnp.asarray, params)))
    got = q.quantize_params(params_from_jax(params, "cpu"))
    _assert_trees_equal(got, want)
    if cfg_j.is_moe:
        moe = got["layers"]["moe"]
        assert moe["w_gate"]["sc"].shape == (cfg_j.n_layers, cfg_j.d_ff)
        assert not q.is_quantized(moe["router"])


def test_wt_reads_quantized_and_float_leaves():
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 8, 4)).astype(np.float32))
    p = {"w_up": w, "wq": q.quantize_weight(w, 3)}
    assert q.wt(p, "w_up", torch.bfloat16).dtype == torch.bfloat16
    got = q.wt(p, "wq", torch.float32)
    torch.testing.assert_close(got, w, atol=w.abs().max().item() / 127,
                               rtol=0)


# ------------------------------------------- (b) logits on int8 weights
def _compiled(model):
    """The reference's prefill and decode step, compiled once each (the
    state donated, as its engine does)."""
    return tuple(jax.jit(f, donate_argnums=(1,))
                 for f in (model.prefill, model.decode_step))


def _extras(cfg, B, seed=5):
    """The VLM's image inputs (rows of I_IMG, 3 and I_IMG valid
    positions); nothing for the other families."""
    if cfg.family != "vlm":
        return {}, {}
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, I_IMG, cfg.d_model)).astype(np.float32)
    mask = np.zeros((B, I_IMG), bool)
    for b, n in enumerate([I_IMG, 3, I_IMG][:B]):
        mask[b, :n] = True
    return ({"img_embeds": jnp.asarray(img), "img_mask": jnp.asarray(mask)},
            {"img_embeds": torch.from_numpy(img),
             "img_mask": torch.from_numpy(mask)})


def _quantized_pair(arch, **over):
    cfg_j, cfg_t, params = _setup(arch, **over)
    pj = jq.quantize_params(jax.tree.map(jnp.asarray, params))
    pt = q.quantize_params(params_from_jax(params, "cpu"))
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_on_int8_weights_matches_reference(arch):
    cfg_j, cfg_t, pj, pt = _quantized_pair(arch)
    mj = jax_build_model(cfg_j)
    mt = build_model(cfg_t, device="cpu")
    toks = np.random.default_rng(2).integers(
        0, cfg_j.vocab_size, (3, 11)).astype(np.int32)
    ej, et = _extras(cfg_j, 3)
    want, _ = jax.jit(mj.forward)(pj, jnp.asarray(toks), **ej)
    got, _ = mt.forward(pt, torch.from_numpy(toks), **et)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


DECODE_CASES = [(a, {}, False) for a in FAMILIES] + [
    ("llama3-8b", {"kv_quant": True}, False),
    ("llama3-8b", {}, True), ("llama3-8b", {"kv_quant": True}, True),
    ("mixtral-8x7b", {}, True)]


@pytest.mark.parametrize(
    "arch,over,use_kernel", DECODE_CASES,
    ids=[f"{a}{'-int8kv' if o else ''}{'-kernel' if k else ''}"
         for a, o, k in DECODE_CASES])
def test_prefill_and_decode_on_int8_weights_match_reference(arch, over,
                                                            use_kernel):
    """Lock-step prefill of 10 tokens (past mixtral's window of 8: its
    ring) and 4 greedy decode steps; with ``use_kernel`` the port runs the
    kernels' plain versions, the reference its Pallas kernels in interpret
    mode (the other families' kernel paths are held by their own test
    files)."""
    cfg_j, cfg_t, pj, pt = _quantized_pair(arch, **over)
    mj = jax_build_model(cfg_j, use_kernel=use_kernel)
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg_j.vocab_size, (3, 10)).astype(np.int32)
    ej, et = _extras(cfg_j, 3)
    sj = mj.init_decode_state(pj, 3, T_MAX, **ej)
    st = mt.init_decode_state(pt, 3, T_MAX, **et)
    if cfg_j.kv_quant:
        assert st["cache"]["k"].dtype == torch.int8 and "k_sc" in st["cache"]
    prefill, step = _compiled(mj)
    lj, sj = prefill(pj, sj, jnp.asarray(toks))
    lt, st = mt.prefill(pt, st, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for _ in range(4):
        nxt = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)
        lj, sj = step(pj, sj, jnp.asarray(nxt))
        lt, st = mt.decode_step(pt, st, torch.from_numpy(nxt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_embed_gathers_int8_rows_into_the_working_dtype():
    """The int8 table's rows are dequantized into ``cfg.dtype``, as the
    reference casts them, whatever the table's scale dtype."""
    from repro_torch.models import layers as L
    cfg = _port_cfg(reduced_config("llama3-8b")).with_overrides(
        dtype="bfloat16")
    tab = torch.randn(11, 8)
    p = {"tok_embed": q.quantize_weight(tab, 2)}
    toks = torch.tensor([[3, 0, 10]])
    x = L.embed(cfg, p, toks)
    assert x.dtype == torch.bfloat16
    want = (p["tok_embed"]["q8"][toks].float()
            * p["tok_embed"]["sc"]).to(torch.bfloat16)
    assert torch.equal(x, want)


# ------------------------------------ (c) the reference's own tolerances
@pytest.mark.parametrize("arch", ["llama3-8b", "musicgen-large"])
def test_int8_weights_close_to_float(arch):
    _, cfg_t, params = _setup(arch)
    m = build_model(cfg_t, device="cpu")
    pf = params_from_jax(params, "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg_t.vocab_size, (2, 16)))
    lf, _ = m.forward(pf, toks)
    lq, _ = m.forward(q.quantize_params(pf), toks)
    rel = (lf - lq).abs().max().item() / (lf.abs().max().item() + 1e-9)
    assert rel < 0.08, rel


def test_int8_weights_moe_top1_agreement():
    _, cfg_t, params = _setup("mixtral-8x7b")
    m = build_model(cfg_t, device="cpu")
    pf = params_from_jax(params, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg_t.vocab_size, (2, 32)))
    lf, _ = m.forward(pf, toks)
    lq, _ = m.forward(q.quantize_params(pf), toks)
    agree = (lf.argmax(-1) == lq.argmax(-1)).float().mean().item()
    assert agree > 0.9, agree


# ------------------------------------------------- (d) rwkv6 refuses
def test_rwkv6_refuses_int8_weights_in_both_packages():
    cfg_j, cfg_t, params = _setup("rwkv6-7b")
    toks = np.random.default_rng(6).integers(0, 97, (2, 5)).astype(np.int32)
    with pytest.raises(Exception):
        jax_build_model(cfg_j).forward(
            jq.quantize_params(jax.tree.map(jnp.asarray, params)),
            jnp.asarray(toks))
    mt = build_model(cfg_t, device="cpu")
    pt = q.quantize_params(params_from_jax(params, "cpu"))
    with pytest.raises(NotImplementedError, match="RWKV-6"):
        mt.forward(pt, torch.from_numpy(toks))
    st = mt.init_decode_state(pt, 2, 8)
    with pytest.raises(NotImplementedError, match="RWKV-6"):
        mt.prefill(pt, st, torch.from_numpy(toks))


# ------------------------------------ (g) the identity-row wrappers
def _kv(B, H, KvE, T, dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q_ = rng.standard_normal((B, H, dh)).astype(dtype)
    k = rng.standard_normal((B, KvE, T, dh)).astype(dtype)
    v = rng.standard_normal((B, KvE, T, dh)).astype(dtype)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = T
    return q_, k, v, lens


@pytest.mark.parametrize("B,H,KvE,T,dh,bk", [
    (2, 8, 4, 256, 64, 64),
    (3, 4, 1, 128, 128, 128),
    (1, 2, 2, 512, 32, 256),
])
def test_decode_attention_plain_matches_interpreted_pallas(B, H, KvE, T, dh,
                                                           bk):
    q_, k, v, lens = _kv(B, H, KvE, T, dh, seed=T + dh)
    want = jax_decode_attention(*map(jnp.asarray, (q_, k, v, lens)), bk=bk,
                                interpret=True)
    args = tuple(map(torch.from_numpy, (q_, k, v, lens)))
    got = da.decode_attention(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    assert torch.equal(got, da.decode_attention_plain(*args))
    assert torch.equal(got, da.decode_attention_resident_plain(
        *args, torch.arange(H)))


@pytest.mark.parametrize("B,H,KvE,T,dh,bk", [
    (2, 4, 2, 256, 64, 64),
    (1, 4, 4, 128, 32, 128),
])
def test_decode_attention_int8_plain_matches_interpreted_pallas(B, H, KvE,
                                                                T, dh, bk):
    from repro_torch.models.layers import _q8
    q_, k, v, lens = _kv(B, H, KvE, T, dh, seed=T + dh + 1)
    (kq, ks), (vq, vs) = _q8(torch.from_numpy(k)), _q8(torch.from_numpy(v))
    want = jax_decode_attention_int8(
        jnp.asarray(q_), jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()), jnp.asarray(lens),
        bk=bk, interpret=True)
    args = (torch.from_numpy(q_), kq, ks, vq, vs, torch.from_numpy(lens))
    got = da.decode_attention_int8(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    assert torch.equal(got, da.decode_attention_int8_plain(*args))


def test_decode_attention_bshd_matches_reference():
    """Model layout: q (B, 1, H, dh), cache (B, T, KvE, dh)."""
    q_, k, v, lens = _kv(2, 8, 2, 128, 64, seed=9)
    qb, kb, vb = q_[:, None], k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    want = jops.decode_attention_bshd(*map(jnp.asarray, (qb, kb, vb, lens)),
                                      interpret=True)
    got = ops.decode_attention_bshd(*map(torch.from_numpy,
                                         (qb, kb, vb, lens)))
    assert got.shape == (2, 1, 8, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_wrappers_count_their_own_launches_only_on_the_card():
    """On CPU tensors the wrappers run their plain versions and count no
    launch, their own or the resident entry points'."""
    q_, k, v, lens = map(torch.from_numpy, _kv(1, 4, 2, 64, 16, seed=1))
    before = (da.decode_attention.launches, da.decode_attention_int8.launches,
              da.decode_attention_resident.launches)
    da.decode_attention(q_, k, v, lens)
    assert (da.decode_attention.launches, da.decode_attention_int8.launches,
            da.decode_attention_resident.launches) == before


# ------------------------- (h) drawing int8 weights one layer at a time
@pytest.mark.parametrize("arch,dtype", [("mixtral-8x7b", "float32"),
                                        ("mixtral-8x7b", "bfloat16"),
                                        ("llama3-8b", "bfloat16")])
def test_layerwise_quantization_equals_quantize_params(arch, dtype):
    """``chip_smoke.int8_layerwise`` (a 1-layer model drawn and quantized
    per layer, copied into preallocated stacks) equals ``quantize_params``
    of the stacked tree of the same draws bit for bit: every scale is per
    layer."""
    cfg = _port_cfg(reduced_config(arch, n_layers=3)).with_overrides(
        param_dtype=dtype, dtype=dtype)
    one = build_model(cfg.with_overrides(n_layers=1), device="cpu")
    draws = [one.init(torch.Generator().manual_seed(7 + l))
             for l in range(3)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.cat(trees)

    full = dict(draws[0], layers=stack([d["layers"] for d in draws]))
    want = q.quantize_params(full)
    got = chip_smoke.int8_layerwise(cfg, "cpu", seed=7)

    def same(g, w, path=""):
        if isinstance(w, dict):
            assert isinstance(g, dict) and set(g) == set(w), path
            for k in w:
                same(g[k], w[k], f"{path}/{k}")
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), path

    same(got, want)
    assert got["layers"]["attn"]["wq"]["q8"].shape[0] == 3
