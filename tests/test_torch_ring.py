"""The port's sliding-window path against the JAX package's: the ring
flash-decode kernel's plain version, windowed (chunked) attention, and the
lock-step prefill / decode over a ring cache.

Kernel inputs are made with numpy from a seed and handed to both; the JAX
kernel runs in interpret mode, as its own tests run it.  Model tests use
``reduced_config("mixtral-8x7b")`` (4 experts, window 8, float32) on the
reference's weights through ``weights.params_from_jax``.  Tolerances
(float32; the two frameworks sum in different orders): kernels and
attention ``atol=rtol=1e-5``, logits ``1e-4``.  Ring slot positions are
data moves and must match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import (
    decode_attention_ring_resident as jax_decode_ring)
from repro.models import layers as jlayers
from repro.models.api import build_model as jax_build_model
from repro.models.partitioning import NULL
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    decode_attention_ring_resident, decode_attention_ring_resident_plain)
from repro_torch.models import layers
from repro_torch.models.api import build_model
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.test_torch_gpu import ring_slot_pos
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

B, H, KvE, W, DH = 3, 8, 2, 64, 16
G = H // KvE
TOL = dict(atol=1e-5, rtol=1e-5)
TOL_LOGITS = dict(atol=1e-4, rtol=1e-4)


def _rows(kind, rng):
    if kind == "identity":
        return np.arange(H, dtype=np.int32)
    groups = rng.permutation(KvE)            # whole KV groups, reordered
    return np.concatenate([g * G + rng.permutation(G)
                           for g in groups]).astype(np.int32)


# (written positions, per-row lengths = query position + 1)
RING_CASES = {
    "wrapped": (3 * W + 5, (3 * W + 5, 3 * W + 1, 2 * W + 7)),
    "partly_filled": (37, (1, 20, 37)),          # 27 slots at -2**30
    "short_and_long": (W, (5, W, 10 * W)),       # length <= W and >> W
}


@pytest.mark.parametrize("rows_kind", ["identity", "group_perm"])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_plain_matches_interpreted_pallas_kernel(case, rows_kind):
    """GQA (8 q heads over 2 KV heads), wrapped and partly filled rings,
    identity and group-permuted resident rows."""
    n, lengths = RING_CASES[case]
    rng = np.random.default_rng(len(case) + len(rows_kind))
    q = rng.standard_normal((B, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, KvE, W, DH)).astype(np.float32)
    v = rng.standard_normal((B, KvE, W, DH)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    slot_pos = ring_slot_pos(W, n).astype(np.int32)
    rows = _rows(rows_kind, rng)
    want = np.asarray(jax_decode_ring(
        *(jnp.asarray(a) for a in (q, k, v, lens, slot_pos, rows)),
        window=W, interpret=True))
    got = decode_attention_ring_resident(
        *(torch.from_numpy(a) for a in (q, k, v, lens, slot_pos, rows)),
        window=W)
    assert got.shape == (B, H, DH)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ring_row_with_no_valid_slot_returns_zeros():
    """A length whose window holds no written slot (here: positions
    written far past it) gives zeros, as the Pallas kernel does."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, H, DH)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, KvE, W, DH))
                          .astype(np.float32))
    lens = torch.tensor([3 * W, 0], dtype=torch.int32)
    slot_pos = torch.from_numpy(ring_slot_pos(W, 5 * W))
    out = decode_attention_ring_resident_plain(
        q, kv, kv, lens, slot_pos, torch.arange(H), window=W)
    assert not out.any()


def test_ring_bshd_wrapper_matches_jax_twin():
    """Model layout, the ring as a strided view and the inv_rows
    scatter."""
    rng = np.random.default_rng(5)
    q4 = rng.standard_normal((B, 1, H, DH)).astype(np.float32)
    kc = rng.standard_normal((B, W, KvE, DH)).astype(np.float32)
    vc = rng.standard_normal((B, W, KvE, DH)).astype(np.float32)
    n = 2 * W + 9
    lens = np.full((B,), n, np.int32)
    slot_pos = ring_slot_pos(W, n).astype(np.int32)
    rows = _rows("group_perm", rng)
    inv = np.argsort(rows).astype(np.int32)
    want = np.asarray(jops.decode_attention_ring_bshd(
        *(jnp.asarray(a) for a in (q4, kc, vc, lens, slot_pos)), window=W,
        rows=jnp.asarray(rows), inv_rows=jnp.asarray(inv)))
    got = ops.decode_attention_ring_bshd(
        *(torch.from_numpy(a) for a in (q4, kc, vc, lens, slot_pos)),
        window=W, rows=torch.from_numpy(rows),
        inv_rows=torch.from_numpy(inv))
    assert got.shape == (B, 1, H, DH)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ring_oracle_matches_plain_version():
    """``ref.decode_attention_ring_ref`` (a softmax over -inf-masked
    scores) against the plain version, every row with a valid slot."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, H, DH)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, KvE, W, DH))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, KvE, W, DH))
                         .astype(np.float32))
    lens = torch.tensor([2 * W + 3, 2 * W + 1, W + 40], dtype=torch.int32)
    slot_pos = torch.from_numpy(ring_slot_pos(W, 2 * W + 3))
    want = ref.decode_attention_ring_ref(q, k, v, lens, slot_pos, W)
    got = decode_attention_ring_resident_plain(
        q, k, v, lens, slot_pos, torch.arange(H), window=W)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_ring_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, H, DH))
    k = torch.zeros((1, KvE, W, DH))
    lens = torch.ones(1, dtype=torch.int32)
    rows = torch.arange(H)
    with pytest.raises(ValueError, match="window"):
        decode_attention_ring_resident(q, k, k, lens,
                                       torch.zeros(W, dtype=torch.int32),
                                       rows, window=W // 2)
    with pytest.raises(ValueError, match="window"):
        decode_attention_ring_resident(q, k, k, lens,
                                       torch.zeros(W + 1, dtype=torch.int32),
                                       rows, window=W)


@pytest.mark.parametrize("B,KvE_,window,sms", [
    (4, 8, 4096, 132),      # the mixtral path: 16 splits of 256, 512 blocks
    (1, 8, 4096, 132),
    (4, 2, 600, 132),       # a window that is no multiple of the split
    (8, 8, 96, 132),        # a window shorter than one split
    (1, 1, 100000, 132),
])
def test_ring_split_fills_the_card(B, KvE_, window, sms):
    """The ring kernel's window split: a positive multiple of 128 slots,
    no empty split, and at least 2 blocks per SM where the window holds
    that many 128-slot pieces."""
    from repro_torch.kernels.decode_attention import _ring_split
    split = _ring_split(B, KvE_, window, sms)
    n = -(-window // split)
    assert split > 0 and split % 128 == 0
    assert (n - 1) * split < window <= n * split
    assert B * KvE_ * n >= min(2 * sms, B * KvE_ * -(-window // 128))
    if (B, KvE_, window) == (4, 8, 4096):
        assert (split, n, B * KvE_ * n) == (256, 16, 512)


def test_ring_kernel_input_check_wants_16_byte_pieces():
    """The ring kernel stages K/V with 16-byte copies: a model ring's
    transposed view passes; an odd position stride or a shifted base
    does not."""
    from repro_torch.kernels.build import aligned16
    ring = torch.zeros((2, W, KvE, DH), dtype=torch.bfloat16)
    assert aligned16(ring.transpose(1, 2))
    wide = torch.zeros((2, W, KvE, DH + 1), dtype=torch.bfloat16)
    assert not aligned16(wide[..., :DH].transpose(1, 2))
    flat = torch.zeros(2 * W * KvE * DH + 1, dtype=torch.bfloat16)[1:]
    assert not aligned16(flat.view(2, W, KvE, DH).transpose(1, 2))


# ------------------------------------------------------- windowed attention
@pytest.mark.parametrize("window", [0, 37])
def test_chunked_attention_matches_reference(window):
    """Flash-style chunked attention, causal and sliding-window, GQA, with
    unequal query and KV extents (queries at the KV tail)."""
    rng = np.random.default_rng(window)
    S, T = 24, 128
    q = rng.standard_normal((2, S, H, DH)).astype(np.float32)
    k = rng.standard_normal((2, T, KvE, DH)).astype(np.float32)
    v = rng.standard_normal((2, T, KvE, DH)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(T - S, T, dtype=np.int32), (2, S))
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    want = np.asarray(jlayers.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v, qpos, kpos)), NULL,
        window=window, chunk=32))
    got = layers.chunked_attention(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (q, k, v, qpos, kpos)), window=window, chunk=32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and the plain attention under the same (windowed) causal mask
    mask = layers.causal_mask(torch.from_numpy(qpos.copy()),
                              torch.from_numpy(kpos.copy()), window)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jlayers.causal_mask(
            jnp.asarray(qpos), jnp.asarray(kpos), window)))
    plain = layers.attention_scores(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mask)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


# ------------------------------------------ lock-step decode over a ring
def _compiled(model):
    """The reference's lock-step prefill and decode, compiled once (state
    donated, as the reference engine does)."""
    return (jax.jit(model.prefill, donate_argnums=(1,)),
            jax.jit(model.decode_step, donate_argnums=(1,)))


@pytest.fixture(scope="module")
def pair():
    cfg_j = reduced_config("mixtral-8x7b", n_kv_heads=2)
    cfg_t = get_config(cfg_j.name).with_overrides(
        **dataclasses.asdict(cfg_j))
    params_j = jax_build_model(cfg_j).init(jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


@pytest.mark.parametrize("prompt_len", [5, 13], ids=["short", "long"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_lockstep_decode_past_the_window_matches_reference(
        pair, use_kernel, prompt_len):
    """``prefill`` (a prompt shorter than the window, which pads the ring
    with empty slots, or longer, which folds its tail) then 14 decode
    steps past the window (8): per-step logits, the ring's slot positions
    and K/V, and the router-load EWMA match the reference."""
    cfg_j, cfg_t, params_j, params_t = pair
    assert cfg_j.sliding_window == 8
    mj = jax_build_model(cfg_j, use_kernel=use_kernel)
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    rng = np.random.default_rng(prompt_len)
    Bm, T_max = 2, 64
    prompts = rng.integers(0, cfg_j.vocab_size, (Bm, prompt_len))
    sj = mj.init_decode_state(params_j, Bm, T_max)
    st = mt.init_decode_state(params_t, Bm, T_max)
    assert st["cache"]["pos"].shape == (cfg_j.n_layers, 8)
    prefill, decode = _compiled(mj)
    lj, sj = prefill(params_j, sj, jnp.asarray(prompts))
    lt, st = mt.prefill(params_t, st, torch.from_numpy(prompts))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL_LOGITS)
    for _ in range(14):
        toks = rng.integers(0, cfg_j.vocab_size, Bm).astype(np.int32)
        lj, sj = decode(params_j, sj, jnp.asarray(toks))
        lt, st = mt.decode_step(params_t, st, torch.from_numpy(toks))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL_LOGITS)
        np.testing.assert_array_equal(st["cache"]["pos"].numpy(),
                                      np.asarray(sj["cache"]["pos"]))
        np.testing.assert_array_equal(st["expert_load"].numpy(),
                                      np.asarray(sj["expert_load"]))
    assert st["pos"] == int(sj["pos"]) == prompt_len + 14
    for name in ("k", "v"):
        np.testing.assert_allclose(st["cache"][name].numpy(),
                                   np.asarray(sj["cache"][name]), **TOL)
