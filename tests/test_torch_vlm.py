"""llama-3.2-vision-11b in the port against the JAX package, on the same
weights.

Config: ``reduced_config("llama-3.2-vision-11b")`` — d_model 64, 4 heads of
16 (4 KV heads; the block tests also run 2, GQA), float32, 5 layers (one
supergroup of [3 self, 1 gated cross, 1 self]) or 10 (two).  Weights come
from the reference's ``init``, whose cross-attention ``gate`` and
``gate_ffn`` start at zero: a cross layer would then add nothing, and a
wrong cross-attention would pass every test.  So both packages get the
gates the reference's own VLM test sets, 0.7 and 0.5.  Every other input
is made with numpy from a seed.  Tolerances: the cross-attention block
``atol=rtol=3e-5`` (the reference's kernel-parity bound), logits
``atol=rtol=1e-4`` (float32; the frameworks sum in different orders).
The reference's decode kernel runs as its Pallas kernel in interpret mode.

The engine checks cover streams, migration logs ("graph" plans not
applied, "columns" plans applied), ``pipeline_k=2``, fail/rejoin replay
and int8 caches, each against the reference engine.  The reference
engine is the oracle for streams: its own VLM test fails
only on "the image changes prompt 0's greedy stream", which at d_model 64
and seed 0 it does not; its per-request streams hold.  Here the image is
shown to matter on logits.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.network import DeviceNetwork as JaxNetwork
from repro.models import layers as JL
from repro.models.api import batch_extras as jax_batch_extras
from repro.models.api import build_model as jax_build_model
from repro.models.partitioning import NULL
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.network import DeviceNetwork
from repro_torch.core.placement_bridge import (apply_layer_head_perms,
                                               permute_model_heads,
                                               permute_model_heads_layers)
from repro_torch.models import layers as L
from repro_torch.models.api import batch_extras, build_model
from repro_torch.serving.engine import (ServingEngine, UnsupportedArchError,
                                        make_engine)
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

MODEL = "llama-3.2-vision-11b"
BLOCK_TOL = dict(atol=3e-5, rtol=3e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
GATE, GATE_FFN = 0.7, 0.5
T_MAX = 32
I_IMG = 8
# an image moves its request's first logits by far more than this (the
# reduced model reads 0.35 and 0.61; a cross layer that ignores K/V, 0)
IMAGE_FLOOR = 1e-2


def _cfgs(**over):
    cfg_j = reduced_config(MODEL, **over)
    cfg_t = get_config(MODEL).with_overrides(**dataclasses.asdict(cfg_j))
    return cfg_j, cfg_t


def _gated(params):
    """The numpy params with every cross layer's gates set nonzero."""
    cross = dict(params["cross_layers"])
    cross["attn"] = dict(cross["attn"],
                         gate=np.full_like(cross["attn"]["gate"], GATE))
    cross["gate_ffn"] = np.full_like(cross["gate_ffn"], GATE_FFN)
    return dict(params, cross_layers=cross)


def _reference_params(cfg_j, seed=0):
    """The reference's init, as numpy leaves."""
    return jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(seed)))


def _compiled(model):
    """The reference's prefill, bucketed prefill and decode step, compiled
    once each (the state donated, as the reference engine does)."""
    return tuple(jax.jit(f, donate_argnums=(1,)) for f in (
        model.prefill, model.prefill_bucketed, model.decode_step))


@functools.lru_cache(maxsize=None)
def _setup(n_layers=5):
    cfg_j, cfg_t = _cfgs(n_layers=n_layers)
    return cfg_j, cfg_t, _gated(_reference_params(cfg_j))


def _images(B, seed=0, rows=(5, I_IMG, 0)):
    """(B, I_IMG, D) embeddings and a right-padded mask: row b holds
    ``rows[b % len(rows)]`` valid positions (0: a fully masked row)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, I_IMG, 64)).astype(np.float32)
    mask = np.zeros((B, I_IMG), bool)
    for b in range(B):
        mask[b, :rows[b % len(rows)]] = True
    return img, mask


# ------------------------------------------------------------ the block
def _block_params(cfg_j, seed=3):
    hd = JL.head_dims(cfg_j, 1)
    p = JL.init_attention(jax.random.PRNGKey(seed), cfg_j, hd, cross=True)
    p["gate"] = jnp.asarray(GATE)
    return hd, p


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("S,source,use_kernel,masked", [
    (3, "embeds", False, True),     # prefill: the plain masked path
    (1, "embeds", False, True),
    (1, "cache", False, True),
    (1, "cache", True, True),       # decode through the kernel
    (1, "embeds", True, True),
    (1, "cache", True, False),      # no mask: every image row valid
])
def test_cross_attention_block_matches_reference(kv_heads, S, source,
                                                 use_kernel, masked):
    """Rows of 5 (a prefix), 8 (full) and 0 valid image positions; the
    fully masked row is the mean of V on every path (the kernel's zeros
    patched), and K/V projected from ``kv_embeds`` or read from a cache."""
    cfg_j, cfg_t = _cfgs(n_kv_heads=kv_heads)
    hd_j, p_j = _block_params(cfg_j)
    hd = L.head_dims(cfg_t)
    p = params_from_jax(jax.tree.map(np.asarray, p_j), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, S, 64)).astype(np.float32)
    img, mask = _images(3)
    mask_j = jnp.asarray(mask) if masked else None
    mask_t = torch.from_numpy(mask) if masked else None
    _, cache_j = JL.cross_attention_block(cfg_j, p_j, hd_j, jnp.asarray(x),
                                          NULL, kv_embeds=jnp.asarray(img))
    kw_j = dict(kv_embeds=jnp.asarray(img)) if source == "embeds" \
        else dict(kv_cache=cache_j)
    want, want_cache = JL.cross_attention_block(
        cfg_j, p_j, hd_j, jnp.asarray(x), NULL, kv_mask=mask_j,
        use_kernel=use_kernel, **kw_j)
    kw = dict(kv_embeds=torch.from_numpy(img)) if source == "embeds" \
        else dict(kv_cache={n: torch.from_numpy(np.array(t))
                            for n, t in cache_j.items()})
    got, got_cache = L.cross_attention_block(
        cfg_t, p, hd, torch.from_numpy(x), kv_mask=mask_t,
        use_kernel=use_kernel, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(got_cache[n].numpy(),
                                   np.asarray(want_cache[n]), atol=1e-6,
                                   rtol=1e-6)
    if masked:
        # the gate scales the whole output: a zero gate would hide it all
        assert np.abs(got.numpy()[2]).max() > 1e-3


def test_scattered_mask_is_refused_where_it_enters():
    """The kernel reads validity as per-row lengths: a scattered mask
    raises ``ValueError`` ("prefix") in the block, at a decode state's
    creation and at ``forward`` when the kernels run; the plain path takes
    it and matches the reference's plain path."""
    cfg_j, cfg_t = _cfgs()
    hd_j, p_j = _block_params(cfg_j)
    p = params_from_jax(jax.tree.map(np.asarray, p_j), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    img, _ = _images(2)
    mask = np.zeros((2, I_IMG), bool)
    mask[0, ::2] = True                          # scattered, not a prefix
    mask[1] = True
    with pytest.raises(ValueError, match="prefix"):
        JL.cross_attention_block(cfg_j, p_j, hd_j, jnp.asarray(x), NULL,
                                 kv_embeds=jnp.asarray(img),
                                 kv_mask=jnp.asarray(mask), use_kernel=True)
    with pytest.raises(ValueError, match="prefix"):
        L.cross_attention_block(cfg_t, p, L.head_dims(cfg_t),
                                torch.from_numpy(x),
                                kv_embeds=torch.from_numpy(img),
                                kv_mask=torch.from_numpy(mask),
                                use_kernel=True)
    want, _ = JL.cross_attention_block(cfg_j, p_j, hd_j, jnp.asarray(x),
                                       NULL, kv_embeds=jnp.asarray(img),
                                       kv_mask=jnp.asarray(mask))
    got, _ = L.cross_attention_block(cfg_t, p, L.head_dims(cfg_t),
                                     torch.from_numpy(x),
                                     kv_embeds=torch.from_numpy(img),
                                     kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    _, cfg_t, params = _setup()
    model = build_model(cfg_t, use_kernel=True, device="cpu")
    pt = params_from_jax(params, "cpu")
    with pytest.raises(ValueError, match="prefix"):
        model.init_decode_state(pt, 2, T_MAX, img_embeds=torch.from_numpy(img),
                                img_mask=torch.from_numpy(mask))
    with pytest.raises(ValueError, match="prefix"):
        model.forward(pt, torch.zeros((2, 3), dtype=torch.int32),
                      img_embeds=torch.from_numpy(img),
                      img_mask=torch.from_numpy(mask))


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n_layers,image", [(5, True), (10, True),
                                            (5, False), (10, False)])
def test_forward_matches_reference(n_layers, image, use_kernel):
    """Cacheless forward logits, with images (rows of 5, 8 and 0 valid
    positions) and without (zero embeddings, every row masked)."""
    cfg_j, cfg_t, params = _setup(n_layers)
    mj = jax_build_model(cfg_j, use_kernel=use_kernel)
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg_j.vocab_size, (3, 7)).astype(np.int32)
    img, mask = _images(3) if image else (
        np.zeros((3, I_IMG, 64), np.float32), np.zeros((3, I_IMG), bool))
    want, _ = jax.jit(mj.forward)(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(toks),
                                  img_embeds=jnp.asarray(img),
                                  img_mask=jnp.asarray(mask))
    got, _ = mt.forward(params_from_jax(params, "cpu"),
                        torch.from_numpy(toks),
                        img_embeds=torch.from_numpy(img),
                        img_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n_layers", [5, 10])
def test_lockstep_decode_matches_reference(n_layers, use_kernel):
    """``init_decode_state`` (image K/V projected into the state) ->
    ``prefill`` -> 4 ``decode_step``s at one shared position."""
    cfg_j, cfg_t, params = _setup(n_layers)
    mj = jax_build_model(cfg_j, use_kernel=use_kernel)
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    pj = jax.tree.map(jnp.asarray, params)
    pt = params_from_jax(params, "cpu")
    img, mask = _images(3, seed=4)
    toks = np.random.default_rng(3).integers(
        0, cfg_j.vocab_size, (3, 6)).astype(np.int32)
    sj = mj.init_decode_state(pj, 3, T_MAX, img_embeds=jnp.asarray(img),
                              img_mask=jnp.asarray(mask))
    st = mt.init_decode_state(pt, 3, T_MAX, img_embeds=torch.from_numpy(img),
                              img_mask=torch.from_numpy(mask))
    assert st["cache"]["k"].shape == sj["cache"]["k"].shape == \
        (n_layers // 5, 4, 3, T_MAX, 4, 16)
    for n in ("k", "v"):
        np.testing.assert_allclose(st["img_kv"][n].numpy(),
                                   np.asarray(sj["img_kv"][n]), atol=1e-6,
                                   rtol=1e-6)
    prefill_j, _, step = _compiled(mj)
    lj, sj = prefill_j(pj, sj, jnp.asarray(toks))
    lt, st = mt.prefill(pt, st, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for _ in range(4):
        nxt = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)
        lj, sj = step(pj, sj, jnp.asarray(nxt))
        lt, st = mt.decode_step(pt, st, torch.from_numpy(nxt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n_layers", [5, 10])
def test_per_slot_decode_matches_reference(n_layers, use_kernel):
    """``prefill_bucketed`` at batch 1 with each request's image ->
    ``insert_slot`` (the cache at its (G, 4) lead, the image K/V and mask
    rows) into a per-slot state of empty images, slots admitted at
    different steps (one imageless) -> 5 ``decode_step``s."""
    cfg_j, cfg_t, params = _setup(n_layers)
    mj = jax_build_model(cfg_j, use_kernel=use_kernel)
    mt = build_model(cfg_t, use_kernel=use_kernel, device="cpu")
    pj = jax.tree.map(jnp.asarray, params)
    pt = params_from_jax(params, "cpu")
    _, prefill_j, decode_j = _compiled(mj)
    B = 3
    empty = (np.zeros((B, I_IMG, 64), np.float32), np.zeros((B, I_IMG), bool))
    sj = mj.init_decode_state(pj, B, T_MAX, per_slot=True,
                              img_embeds=jnp.asarray(empty[0]),
                              img_mask=jnp.asarray(empty[1]))
    st = mt.init_decode_state(pt, B, T_MAX, per_slot=True,
                              img_embeds=torch.from_numpy(empty[0]),
                              img_mask=torch.from_numpy(empty[1]))
    img, mask = _images(B, seed=5, rows=(5, 0, I_IMG))
    rng = np.random.default_rng(0)
    prompts = {0: rng.integers(0, cfg_j.vocab_size, 5),
               1: rng.integers(0, cfg_j.vocab_size, 11),
               2: rng.integers(0, cfg_j.vocab_size, 3)}
    admit_at = {0: 0, 1: 0, 2: 2}
    nxt = np.zeros(B, np.int32)
    for step in range(5):
        for slot, at in admit_at.items():
            if at != step:
                continue
            p = prompts[slot]
            Lb = 8 if len(p) <= 8 else 16
            toks = np.zeros((1, Lb), np.int32)
            toks[0, :len(p)] = p
            im, mk = img[slot:slot + 1], mask[slot:slot + 1]
            lj, subj = prefill_j(
                pj, mj.init_decode_state(pj, 1, Lb, per_slot=True,
                                         img_embeds=jnp.asarray(im),
                                         img_mask=jnp.asarray(mk)),
                jnp.asarray(toks), jnp.asarray([len(p)], jnp.int32))
            lt, subt = mt.prefill_bucketed(
                pt, mt.init_decode_state(pt, 1, Lb, per_slot=True,
                                         img_embeds=torch.from_numpy(im),
                                         img_mask=torch.from_numpy(mk)),
                torch.from_numpy(toks), torch.tensor([len(p)]))
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
            sj = mj.insert_slot(sj, subj, slot)
            st = mt.insert_slot(st, subt, slot)
            nxt[slot] = int(np.argmax(np.asarray(lj)[0]))
        np.testing.assert_array_equal(st["img_mask"].numpy(),
                                      np.asarray(sj["img_mask"]))
        for n in ("k", "v"):
            np.testing.assert_allclose(st["img_kv"][n].numpy(),
                                       np.asarray(sj["img_kv"][n]),
                                       atol=1e-6, rtol=1e-6)
        lj, sj = decode_j(pj, sj, jnp.asarray(nxt))
        lt, st = mt.decode_step(pt, st, torch.from_numpy(nxt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_array_equal(st["pos"].numpy(), np.asarray(sj["pos"]))
        nxt = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)


@pytest.mark.parametrize("n_layers", [5, 10])
def test_init_draws_the_reference_tree(n_layers):
    """``build_model`` takes the VLM; ``init`` draws the reference's tree
    (the (G, 4, ...) self stack, the (G, ...) cross stack with zero gates)
    in its shapes and dtypes, and ``params_from_jax`` carries both stacks
    across unchanged."""
    cfg_j, cfg_t, params = _setup(n_layers)
    model = build_model(cfg_t, device="cpu")
    assert model.is_vlm and model.n_groups == n_layers // 5
    got = model.init(torch.Generator().manual_seed(0))

    def tree(t, pre=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(tree(v, pre + k + "/"))
            else:
                out[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
        return out

    want = jax.eval_shape(jax_build_model(cfg_j).init, jax.random.PRNGKey(0))
    assert tree(got) == tree(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), want))
    assert not got["cross_layers"]["attn"]["gate"].any()
    assert not got["cross_layers"]["gate_ffn"].any()
    conv = params_from_jax(params, "cpu")
    for name in ("layers", "cross_layers"):
        for k, v in tree(params[name]).items():
            node = conv[name]
            for part in k.split("/"):
                node = node[part]
            assert (tuple(node.shape), str(node.dtype).split(".")[-1]) == v
    np.testing.assert_array_equal(
        conv["layers"]["attn"]["wq"].numpy(), params["layers"]["attn"]["wq"])
    np.testing.assert_array_equal(
        conv["cross_layers"]["attn"]["gate"].numpy(),
        params["cross_layers"]["attn"]["gate"])


def test_batch_extras_equal_reference():
    cfg = get_config(MODEL)
    got = batch_extras(cfg, 2, torch.bfloat16)
    want = jax_batch_extras(jax_get_config(MODEL), 2, jnp.bfloat16)
    assert set(got) == set(want) == {"img_embeds", "img_mask"}
    assert got["img_embeds"].shape == want["img_embeds"].shape == \
        (2, 1601, 4096)
    assert got["img_embeds"].dtype == torch.bfloat16
    assert not got["img_embeds"].any()
    assert got["img_mask"].dtype == torch.bool
    np.testing.assert_array_equal(got["img_mask"].numpy(),
                                  np.asarray(want["img_mask"]))


def test_bridge_reaches_cross_layers_and_supergroup_perms():
    """``permute_model_heads`` moves every self and cross layer's heads by
    one permutation, ``permute_model_heads_layers`` and
    ``apply_layer_head_perms`` take (G, 4, H) permutations of the
    supergroup stacks — each as the reference's (GQA, group size 2)."""
    from repro.core import placement_bridge as JB
    cfg_j, cfg_t = _cfgs(n_layers=10, n_kv_heads=2)
    params = _reference_params(cfg_j, seed=1)
    pt = params_from_jax(params, "cpu")
    perm = np.array([2, 3, 0, 1])
    want = JB.permute_model_heads(jax.tree.map(jnp.asarray, params), perm,
                                  group_size=2)
    got = permute_model_heads(pt, perm, group_size=2)
    for name in ("layers", "cross_layers"):
        for w in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(got[name]["attn"][w].numpy(),
                                          np.asarray(want[name]["attn"][w]))
    rng = np.random.default_rng(0)
    perms = np.stack([[perm if rng.random() < 0.5 else np.arange(4)
                       for _ in range(4)] for _ in range(2)])   # (2, 4, 4)
    layers = {"attn": params["layers"]["attn"]}
    want = JB.permute_model_heads_layers(jax.tree.map(jnp.asarray, layers),
                                         perms, group_size=2)
    got = permute_model_heads_layers({"attn": pt["layers"]["attn"]}, perms,
                                     group_size=2)
    for w in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(got["attn"][w].numpy(),
                                      np.asarray(want["attn"][w]))
    cache = rng.standard_normal((2, 4, 3, 5, 2, 16)).astype(np.float32)
    want = JB.apply_layer_head_perms(jnp.asarray(cache), jnp.asarray(cache),
                                     perms, head_axis=-2, group_size=2)
    got = apply_layer_head_perms(torch.from_numpy(cache),
                                 torch.from_numpy(cache), perms,
                                 head_axis=-2, group_size=2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


# ----------------------------------------------------------- the engine
PROMPT_LENS = (4, 7, 9)


def _requests(cfg, n=3):
    """The three requests of the reference's VLM engine test (an image of
    5 rows, none, 8 rows), then, for ``n`` > 3, more of the same mix."""
    rng = np.random.default_rng(0)
    lens = (PROMPT_LENS * 2)[:n]
    prompts = [rng.integers(0, cfg.vocab_size, size=k).astype(np.int32)
               for k in lens]
    rows = [5, None, I_IMG]
    imgs = [None if rows[i % 3] is None else
            rng.standard_normal((rows[i % 3], cfg.d_model)).astype(np.float32)
            for i in range(n)]
    return prompts, imgs


def _drive(eng, prompts, imgs, new_tokens=5, straggle_at=None, fail=None):
    """Submit, then step to the end: a 500x straggler on the busiest
    device at ``straggle_at``; ``fail`` (device, fail step, rejoin step)
    fails a device mid-decode and brings it back."""
    for p, im in zip(prompts, imgs):
        eng.submit(p, max_new_tokens=new_tokens, img_embeds=im)
    while True:
        if eng.decode_steps == straggle_at:
            dev = int(eng.controller.head_counts().argmax())
            eng.net.inject_straggler(dev, slowdown=500.0)
        if fail and eng.decode_steps == fail[1] and not eng.recovery_log:
            eng.fail_device(fail[0])
        if fail and eng.decode_steps == fail[2] \
                and len(eng.recovery_log) == 1:
            eng.rejoin_device(fail[0])
        if not eng.step():
            break
    return {r.rid: r.out_tokens for r in eng.finished}


def _pair(n_requests=3, new_tokens=5, straggle_at=None, fail=None,
          n_devices=4, **kw):
    """The reference engine (gated weights installed after construction)
    and the port's on the same weights and requests: (streams, engine)
    each."""
    cfg_j, cfg_t, params = _setup()
    prompts, imgs = _requests(cfg_j, n_requests)
    kw = dict(n_slots=2, max_seq=48, seed=0, img_tokens=I_IMG, **kw)
    ref = JaxEngine(cfg_j, net=JaxNetwork.sample(n_devices, seed=1), **kw)
    ref.params = jax.tree.map(jnp.asarray, params)
    eng = ServingEngine(cfg_t, net=DeviceNetwork.sample(n_devices, seed=1),
                        device="cpu", params=params_from_jax(params, "cpu"),
                        **kw)
    run = dict(new_tokens=new_tokens, straggle_at=straggle_at, fail=fail)
    return ((_drive(ref, prompts, imgs, **run), ref),
            (_drive(eng, prompts, imgs, **run), eng))


def _per_request(eng, prompt, img, new_tokens=5):
    """Greedy tokens of one request through the port's model alone:
    ``init_decode_state`` with its padded image, ``prefill``, decode."""
    pad = np.zeros((1, eng.img_tokens, eng.cfg.d_model), np.float32)
    mask = np.zeros((1, eng.img_tokens), bool)
    if img is not None:
        pad[0, :len(img)] = img
        mask[0, :len(img)] = True
    st = eng.model.init_decode_state(eng.params, 1, eng.max_seq,
                                     img_embeds=torch.from_numpy(pad),
                                     img_mask=torch.from_numpy(mask))
    logits, st = eng.model.prefill(eng.params, st,
                                   torch.from_numpy(prompt[None]))
    first = logits
    toks = [int(logits[0].argmax())]
    for _ in range(new_tokens - 1):
        logits, st = eng.model.decode_step(eng.params, st,
                                           torch.tensor([toks[-1]]))
        toks.append(int(logits[0].argmax()))
    return toks, first


@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_streams_equal_reference_engine(use_kernel):
    """The reference's VLM engine scenario (2 slots, 3 requests, the
    second imageless, image buffer of 8, no migrations): streams equal the
    reference engine's and the port's own per-request path; the image
    moves its request's logits by more than ``IMAGE_FLOOR``."""
    (want, _), (got, eng) = _pair(lam=10 ** 9, use_kernel=use_kernel)
    assert len(got) == 3 and got == want
    assert "head_rows" not in eng.state       # identity rows for a VLM
    prompts, imgs = _requests(eng.cfg)
    for rid, (p, im) in enumerate(zip(prompts, imgs)):
        toks, first = _per_request(eng, p, im)
        assert got[rid] == toks, rid
        if im is not None:
            _, blind = _per_request(eng, p, None)
            assert (first - blind).abs().max().item() > IMAGE_FLOOR


def test_make_engine_picks_the_continuous_engine():
    _, cfg_t, _ = _setup()
    assert isinstance(make_engine(cfg_t, n_slots=2, max_seq=32, seed=0,
                                  device="cpu"), ServingEngine)


def test_submit_errors_match_reference():
    _, cfg_t, _ = _setup()
    eng = ServingEngine(cfg_t, n_slots=2, max_seq=48, seed=0, img_tokens=4,
                        device="cpu")
    for bad in (np.zeros((5, 64), np.float32),       # more than img_tokens
                np.zeros((3, 32), np.float32),       # wrong width
                np.zeros((3, 64, 1), np.float32)):   # not (I, D)
        with pytest.raises(ValueError, match="img_embeds must be"):
            eng.submit(np.arange(3), 4, img_embeds=bad)
    dense = ServingEngine(reduced_config("llama3-8b"), n_slots=2,
                          max_seq=48, seed=0, device="cpu")
    with pytest.raises(ValueError, match="not a VLM"):
        dense.submit(np.arange(3), 4, img_embeds=np.zeros((2, 64)))


def test_paged_vlm_is_refused():
    _, cfg_t, _ = _setup()
    with pytest.raises(UnsupportedArchError, match="paged"):
        ServingEngine(cfg_t, n_slots=2, max_seq=64, seed=0, paged=True,
                      page_size=8, device="cpu")
    with pytest.raises(NotImplementedError, match="VLM image"):
        build_model(cfg_t, device="cpu").init_paged_cache(4, 8)


LOG_KEYS = ("step", "n_migrations", "mig_bytes", "applied", "reason")


def _log(eng):
    return [tuple(e[k] for k in LOG_KEYS) for e in eng.migration_log]


@functools.lru_cache(maxsize=None)
def _still_run():
    """The engine scenario without intervals: the streams every churn and
    migration run must reproduce."""
    _, (streams, _) = _pair(n_requests=5, new_tokens=10, lam=10 ** 9,
                            use_kernel=True)
    return streams


@pytest.mark.parametrize("layer_mode", ["graph", "columns"])
def test_migration_logs_equal_reference(layer_mode):
    """4 devices, λ = 3, a 500x straggler at step 4, 5 requests: per-layer
    ("graph") plans cannot address the (G, 4, ...) stacks and are logged
    not applied with the reference's reason; "columns" plans are one
    layout for every layer and apply to the weights, the cache and the
    image K/V.  Streams and logs equal the reference's, and the streams
    equal the migration-free run's."""
    (want, ref), (got, eng) = _pair(n_requests=5, new_tokens=10, lam=3,
                                    straggle_at=4, use_kernel=True,
                                    layer_mode=layer_mode)
    assert len(got) == 5 and got == want == _still_run()
    assert _log(eng) == _log(ref)
    moved = [e for e in eng.migration_log if e["n_migrations"]]
    assert moved
    if layer_mode == "graph":
        assert all(not e["applied"] and e["reason"] ==
                   "per-layer plan on a cache without a leading layer axis"
                   for e in moved)
    else:
        assert all(e["applied"] and e["reason"] is None for e in moved)


def test_pipelined_streams_equal_reference():
    """``pipeline_k=2`` (one slot a group, intervals every λ·K = 6 steps,
    a straggler after the first): streams and logs equal the reference's
    K = 2 engine, and the streams the sequential run's."""
    (want, ref), (got, eng) = _pair(n_requests=5, new_tokens=10, lam=3,
                                    straggle_at=8, use_kernel=True,
                                    pipeline_k=2, layer_mode="columns")
    assert len(eng.states) == 2 and "img_kv" in eng.states[1]
    assert len(got) == 5 and got == want == _still_run()
    assert _log(eng) == _log(ref)


@pytest.mark.parametrize("layer_mode", ["graph", "columns"])
def test_fail_and_rejoin_replay_equal_reference(layer_mode):
    """Device 1 fails at step 6 (evacuation, then teacher-forced replay
    whose prefills carry each request's image) and rejoins at step 14:
    ``recovery_log``, migration logs and streams equal the reference's,
    and the streams the churn-free run's."""
    (want, ref), (got, eng) = _pair(n_requests=5, new_tokens=10, lam=3,
                                    fail=(1, 6, 14), use_kernel=True,
                                    layer_mode=layer_mode)
    assert [e["event"] for e in eng.recovery_log] == ["fail", "rejoin"]
    assert eng.recovery_log[0]["replay_prefills"] > 0
    assert eng.recovery_log == ref.recovery_log
    assert _log(eng) == _log(ref)
    assert len(got) == 5 and got == want == _still_run()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_int8_kv_streams_equal_reference(use_kernel):
    """``kv_quant``: the self layers' (G, 4, ...) cache in int8 with
    per-(token, head) scales (the image K/V stays in the working dtype),
    a columns migration applied to values and scales: streams and logs
    equal the reference's int8 engine."""
    cfg_j, _, params = _setup()
    cfg_j = cfg_j.with_overrides(kv_quant=True)
    cfg_t = get_config(MODEL).with_overrides(**dataclasses.asdict(cfg_j))
    prompts, imgs = _requests(cfg_j, 5)
    kw = dict(n_slots=2, max_seq=48, seed=0, img_tokens=I_IMG, lam=3,
              use_kernel=use_kernel, layer_mode="columns")
    ref = JaxEngine(cfg_j, net=JaxNetwork.sample(4, seed=1), **kw)
    ref.params = jax.tree.map(jnp.asarray, params)
    eng = ServingEngine(cfg_t, net=DeviceNetwork.sample(4, seed=1),
                        device="cpu", params=params_from_jax(params, "cpu"),
                        **kw)
    assert eng.state["cache"]["k"].dtype == torch.int8
    run = dict(new_tokens=10, straggle_at=4)
    want = _drive(ref, prompts, imgs, **run)
    got = _drive(eng, prompts, imgs, **run)
    assert len(got) == 5 and got == want
    assert _log(eng) == _log(ref)
    assert any(e["applied"] and e["n_migrations"]
               for e in eng.migration_log)
