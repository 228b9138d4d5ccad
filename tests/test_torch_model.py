"""The port's dense model against the JAX package's on the same weights.

Config: ``reduced_config("llama3-8b", n_layers=3, n_kv_heads=2)`` (GQA,
G = 2, float32).  Weights come from the reference's ``init`` and reach the
port through ``weights.params_from_jax``; every other input is made with
numpy from a seed.  Tolerance on logits: ``atol=rtol=1e-4`` (float32; the
two frameworks sum matmuls and softmaxes in different orders).  The head
permutations move data only, so they must match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import placement_bridge as jbridge
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import placement_bridge as bridge
from repro_torch.models.api import build_model
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
# int8 caches: the two frameworks' float32 K/V differ by ~1e-7, which moves
# ``round(x / scale)`` by one step for the rare value within that of a
# half-integer.  One step is one element's scale (amax / 127, ~2 % of it)
# and moves the logits by up to a few 1e-4; the caches are checked to
# differ by at most one step in at most 0.1 % of their values.
TOL_INT8 = dict(atol=2e-3, rtol=1e-3)
T_MAX = 32


def _assert_int8_caches_close(got, want):
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and diff.mean() < 1e-3, (diff.max(), diff.mean())


@pytest.fixture(scope="module")
def pair():
    cfg_j = reduced_config("llama3-8b", n_layers=3, n_kv_heads=2)
    cfg_t = get_config("llama3-8b").with_overrides(
        **dataclasses.asdict(cfg_j))
    params_j = jax_build_model(cfg_j).init(jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _compiled(model, paged=False):
    """The reference's prefill (bucketed, or one paged chunk) and decode,
    compiled once (state donated, as the reference engine does)."""
    prefill = model.prefill_paged if paged else model.prefill_bucketed
    return (jax.jit(prefill, donate_argnums=(1,)),
            jax.jit(model.decode_step, donate_argnums=(1,)))


def _row_maps(n_layers, H, seed):
    """Per-layer kernel gather maps (a permutation of the head rows) and
    their inverses, the same in both packages."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.permutation(H) for _ in range(n_layers)])
    return rows.astype(np.int32), np.argsort(rows, axis=1).astype(np.int32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_staggered_slot_decode_matches_reference(pair, use_kernel):
    """prefill_bucketed -> insert_slot -> 6 decode_steps with prompts
    admitted at different steps, so slots decode at unequal depths."""
    cfg_j, cfg_t, params_j, params_t = pair
    mj = jax_build_model(cfg_j, use_kernel=use_kernel)
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    prefill_j, decode_j = _compiled(mj)
    B = 3
    sj = mj.init_decode_state(params_j, B, T_MAX, per_slot=True)
    st = mt.init_decode_state(params_t, B, T_MAX, per_slot=True)
    if use_kernel:
        rows, inv = _row_maps(cfg_j.n_layers, cfg_j.n_heads, 5)
        sj = dict(sj, head_rows=jnp.asarray(rows), head_inv=jnp.asarray(inv))
        st.update(head_rows=torch.from_numpy(rows),
                  head_inv=torch.from_numpy(inv))
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
        np.testing.assert_array_equal(st["pos"].numpy(),
                                      np.asarray(sj["pos"]))
        nxt = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)


def test_retired_slot_writes_drop_at_the_cache_edge(pair):
    """A slot clamped at T keeps decoding: its write is dropped, its
    kernel length reads min(T + 1, T) positions, and both paths still
    match the reference."""
    cfg_j, cfg_t, params_j, params_t = pair
    T = 8
    mj = jax_build_model(cfg_j)
    sj = mj.init_decode_state(params_j, 2, T, per_slot=True)
    sj = dict(sj, pos=jnp.asarray([T, 3], jnp.int32))
    toks = np.asarray([4, 9], np.int32)
    lj, sj2 = mj.decode_step(params_j, sj, jnp.asarray(toks))
    for use_kernel in (False, True):
        mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
        st = mt.init_decode_state(params_t, 2, T, per_slot=True)
        st["pos"] = torch.tensor([T, 3], dtype=torch.int32)
        lt, st = mt.decode_step(params_t, st, torch.from_numpy(toks))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_array_equal(st["pos"].numpy(), [T, 4])
        np.testing.assert_allclose(st["cache"]["k"].numpy(),
                                   np.asarray(sj2["cache"]["k"]), **TOL)


def test_forward_matches_reference(pair):
    """The no-cache prefill branch, through the full-sequence forward."""
    cfg_j, cfg_t, params_j, params_t = pair
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (2, 9))
    lj, _ = jax_build_model(cfg_j).forward(params_j, jnp.asarray(toks))
    lt = build_model(cfg_t, device="cpu").forward(params_t,
                                                  torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def _group_perms(n_layers, H, G, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_layers):
        groups = rng.permutation(H // G)
        out.append(np.concatenate([g * G + np.arange(G) for g in groups]))
    return np.stack(out)


def test_head_permutations_match_reference(pair):
    """apply_layer_head_perms and permute_model_heads_layers move exactly
    the rows the reference moves, on random group-consistent perms."""
    cfg_j, cfg_t, params_j, params_t = pair
    G = cfg_j.n_heads // cfg_j.n_kv_heads
    perms = _group_perms(cfg_j.n_layers, cfg_j.n_heads, G, 3)
    rng = np.random.default_rng(4)
    ck = rng.standard_normal((cfg_j.n_layers, 2, 6, cfg_j.n_kv_heads,
                              cfg_j.d_head)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    wk, wv = jbridge.apply_layer_head_perms(
        jnp.asarray(ck), jnp.asarray(cv), perms, layer_axis=0, head_axis=-2,
        group_size=G)
    tk, tv = bridge.apply_layer_head_perms(
        torch.from_numpy(ck), torch.from_numpy(cv), perms, head_axis=-2,
        group_size=G)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    # replicated KV rows (rep = 2) move with their KV head
    ck2 = np.repeat(ck, 2, axis=-2)
    wk2, _ = jbridge.apply_layer_head_perms(
        jnp.asarray(ck2), jnp.asarray(ck2), perms, layer_axis=0,
        head_axis=-2, group_size=G, rep=2)
    tk2, _ = bridge.apply_layer_head_perms(
        torch.from_numpy(ck2), torch.from_numpy(ck2), perms, head_axis=-2,
        group_size=G, rep=2)
    np.testing.assert_array_equal(tk2.numpy(), np.asarray(wk2))
    pj = jbridge.permute_model_heads_layers(params_j, perms, group_size=G)
    pt = bridge.permute_model_heads_layers(params_t, perms, group_size=G)
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(
            pt["layers"]["attn"][name].numpy(),
            np.asarray(pj["layers"]["attn"][name]))
    assert pt["layers"]["mlp"]["w_up"] is params_t["layers"]["mlp"]["w_up"]


def test_numpy_bridge_matches_reference():
    """The numpy half of the bridge is a copy: same perms, row maps and
    migration pairs on a seeded random placement."""
    from repro.core.blocks import make_blocks as jmake_blocks
    from repro_torch.core.blocks import make_blocks
    H, n_layers, n_slots, G = 8, 3, 4, 2
    place = np.random.default_rng(6).integers(
        0, n_slots, len(make_blocks(H, n_layers)))
    bj, bt = jmake_blocks(H, n_layers), make_blocks(H, n_layers)
    pj = jbridge.placement_to_perms(place, bj, n_slots, H // n_slots, G)
    pt = bridge.placement_to_perms(place, bt, n_slots, H // n_slots, G)
    np.testing.assert_array_equal(pt, pj)
    for a, b in zip(bridge.head_row_maps(place, bt, n_slots, H, perms=pt),
                    jbridge.head_row_maps(place, bj, n_slots, H, perms=pj)):
        np.testing.assert_array_equal(a, b)
    ident = np.tile(np.arange(H), (n_layers, 1))
    assert bridge.migration_pairs_layers(ident, pt, H // n_slots) == \
        jbridge.migration_pairs_layers(ident, pj, H // n_slots)
    np.testing.assert_array_equal(bridge.relative_perms(ident, pt),
                                  jbridge.relative_perms(ident, pj))


def _pair_for(pair, **over):
    cfg_j, cfg_t, params_j, params_t = pair
    return (cfg_j.with_overrides(**over), cfg_t.with_overrides(**over),
            params_j, params_t)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_int8_staggered_slot_decode_matches_reference(pair, use_kernel):
    """``kv_quant``: the int8 cache with its scales, spliced per slot by
    insert_slot, written per slot at decode, read dequantized (or by the
    int8 kernel) — per-step logits match the reference's."""
    cfg_j, cfg_t, params_j, params_t = _pair_for(pair, kv_quant=True)
    mj = jax_build_model(cfg_j, use_kernel=use_kernel)
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    prefill_j, decode_j = _compiled(mj)
    B = 3
    sj = mj.init_decode_state(params_j, B, T_MAX, per_slot=True)
    st = mt.init_decode_state(params_t, B, T_MAX, per_slot=True)
    assert st["cache"]["k"].dtype == torch.int8
    assert st["cache"]["k_sc"].shape == tuple(sj["cache"]["k_sc"].shape)
    if use_kernel:
        rows, inv = _row_maps(cfg_j.n_layers, cfg_j.n_heads, 5)
        sj = dict(sj, head_rows=jnp.asarray(rows), head_inv=jnp.asarray(inv))
        st.update(head_rows=torch.from_numpy(rows),
                  head_inv=torch.from_numpy(inv))
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
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL_INT8)
            sj = mj.insert_slot(sj, subj, slot)
            st = mt.insert_slot(st, subt, slot)
            nxt[slot] = int(np.argmax(np.asarray(lj)[0]))
        lj, sj = decode_j(params_j, sj, jnp.asarray(nxt))
        lt, st = mt.decode_step(params_t, st, torch.from_numpy(nxt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL_INT8)
        nxt = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)
    np.testing.assert_allclose(st["cache"]["k_sc"].numpy(),
                               np.asarray(sj["cache"]["k_sc"]), **TOL)
    _assert_int8_caches_close(st["cache"]["k"], sj["cache"]["k"])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
def test_paged_decode_matches_reference(pair, kv_quant, use_kernel):
    """The paged decode-state API — init_paged_state, mount_slot_pages,
    chunked prefill_paged with dropped tail writes, decode_step through
    the page map (and the paged kernels) — matches the reference's
    per-step logits and positions.  Pages come from one allocator in
    LIFO order, so physical ids are scrambled against logical order."""
    from repro_torch.serving.paging import PagedKVAllocator
    cfg_j, cfg_t, params_j, params_t = _pair_for(pair, kv_quant=kv_quant)
    mj = jax_build_model(cfg_j, use_kernel=use_kernel)
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    prefill_j, decode_j = _compiled(mj, paged=True)
    B, P, n_pages, per_slot = 3, 4, 20, T_MAX // 4
    alloc = PagedKVAllocator(n_pages, P, B, per_slot)
    sj = mj.init_paged_state(params_j, B, n_pages, P, per_slot)
    st = mt.init_paged_state(params_t, B, n_pages, P, per_slot)
    if use_kernel:
        rows, inv = _row_maps(cfg_j.n_layers, cfg_j.n_heads, 7)
        sj = dict(sj, head_rows=jnp.asarray(rows), head_inv=jnp.asarray(inv))
        st.update(head_rows=torch.from_numpy(rows),
                  head_inv=torch.from_numpy(inv))

    def mount(row, pos):
        nonlocal sj, st
        pages = alloc.page_map_row(row)
        sj = mj.mount_slot_pages(sj, jnp.int32(row), jnp.asarray(pages),
                                 jnp.int32(pos))
        st = mt.mount_slot_pages(st, row, pages, pos)

    tol = TOL_INT8 if kv_quant else TOL
    rng = np.random.default_rng(3)
    prompts = {0: rng.integers(0, cfg_j.vocab_size, 5),
               1: rng.integers(0, cfg_j.vocab_size, 11),
               2: rng.integers(0, cfg_j.vocab_size, 3)}
    admit_at = {0: 0, 1: 0, 2: 3}
    depth = {}
    nxt = np.zeros(B, np.int32)
    for step in range(7):
        for row, at in admit_at.items():
            if at != step:
                continue
            p = prompts[row]
            alloc.admit(row, len(p), len(p) + 10)
            mount(row, 0)
            for c0 in range(0, len(p), 8):
                n = min(8, len(p) - c0)
                toks = np.zeros((1, 8), np.int32)
                toks[0, :n] = p[c0:c0 + n]
                lj, sj = prefill_j(params_j, sj, jnp.asarray(toks),
                                   jnp.int32(row), jnp.int32(c0),
                                   jnp.int32(n))
                lt, st = mt.prefill_paged(params_t, st,
                                          torch.from_numpy(toks), row, c0, n)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
            depth[row] = len(p)
            nxt[row] = int(np.argmax(np.asarray(lj)[0]))
        for row, d in depth.items():      # lazy page growth, as the engine
            if d >= alloc.pages_for(row) * P:
                alloc.extend(row, d + 1)
                mount(row, d)
        lj, sj = decode_j(params_j, sj, jnp.asarray(nxt))
        lt, st = mt.decode_step(params_t, st, torch.from_numpy(nxt))
        live = sorted(depth)
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live],
                                   **tol)
        np.testing.assert_array_equal(st["pos"].numpy(),
                                      np.asarray(sj["pos"]))
        nxt = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)
        depth = {r: d + 1 for r, d in depth.items()}
    # the pool the reference holds is the port's store without its sink
    got, want = st["cache"]["k"][:, :n_pages], sj["cache"]["k"]
    if kv_quant:
        _assert_int8_caches_close(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
