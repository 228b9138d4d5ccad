"""GShard capacity dispatch and expert replication in the port, against
the JAX package on the same weights.

Config: ``reduced_config("mixtral-8x7b")`` (d_model 64, d_ff 128, 4
experts, top-2, window 8, float32).  Weights come from the reference's
``init`` through ``weights.params_from_jax``; inputs are made with numpy
from a seed.  Tolerances: the MoE block's output, aux loss and router
frequencies ``atol=rtol=1e-5`` (float32; the frameworks sum in different
orders), model logits ``1e-4``; routing (which (token, row) pairs a
bucket keeps and drops) and the replicated layout (owner, share, weight
rows) exactly.  The reference's claim that a replica leaves ``moe_block``
bit-identical fails in the reference on this tree (ROADMAP Queue 3); in
the port it holds for the dense block and is tested there, not for the
capacity block, which is held to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.api import build_model as jax_build_model
from repro.models.partitioning import NULL
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.api import build_model
from repro_torch.models.transformer import TransformerLM
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_LOGITS = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 16


@pytest.fixture(scope="module")
def layer():
    """One layer's MoE params in both packages and an input batch."""
    cfg_j = reduced_config("mixtral-8x7b")
    cfg_t = get_config(cfg_j.name).with_overrides(
        **dataclasses.asdict(cfg_j))
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), cfg_j))
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, p, x


def _layout(p, kind):
    """The numpy moe dict in a physical layout: logical (no owner), the
    identity maps, a permutation of the experts, or expert 1 replicated
    (the reference's ``replicate_expert``)."""
    E = p["w_gate"].shape[0]
    if kind == "logical":
        return p
    if kind == "replicated":
        return jax.tree.map(np.asarray, jmoe.replicate_expert(
            jax.tree.map(jnp.asarray, p), 1))
    perm = np.arange(E) if kind == "identity" else np.array([2, 0, 3, 1])
    out = {k: (v[perm] if k.startswith("w_") else v) for k, v in p.items()}
    out["owner"] = perm.astype(np.int32)
    out["share"] = np.ones(E, np.float32)
    return out


def _reference_drops(cfg_j, p, x, cf, group):
    """The (token, physical row) pairs the reference's capacity dispatch
    routes but drops, counted from its own router gates."""
    gates, _ = jmoe.router_probs(cfg_j, jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x))
    gates = np.asarray(gates)
    if "owner" in p:
        gates = gates[..., p["owner"]] * p["share"]
    n = min(group, S)
    cap = max(int(cf * cfg_j.experts_per_token * n / cfg_j.n_experts), 1)
    sel = gates.reshape(-1, n, gates.shape[-1]) > 0
    pos = np.cumsum(sel, axis=1) - 1
    return int((sel & (pos >= cap)).sum())


@pytest.mark.parametrize("kind", ["logical", "identity", "permuted",
                                  "replicated"])
@pytest.mark.parametrize("group", [4, 8, 16, 1024])
@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
def test_capacity_block_matches_reference(layer, kind, group, cf):
    """Output, aux and freq within 1e-5 of the reference's, and the same
    drops: cf 0.5 drops in every layout (cap 1 at group 4), cf E/k = 2
    never does (cap == n)."""
    cfg_j, cfg_t, p, x = layer
    p = _layout(p, kind)
    yj, aj, fj = jmoe.moe_block_capacity(
        cfg_j, jax.tree.map(jnp.asarray, p), jnp.asarray(x), NULL,
        capacity_factor=cf, group=group)
    pt, xt = params_from_jax(p, "cpu"), torch.from_numpy(x)
    yt, at, ft = moe.moe_block_capacity(cfg_t, pt, xt, capacity_factor=cf,
                                        group=group)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(at.item(), float(aj), **TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)
    drops = int(moe.capacity_drops(cfg_t, pt, xt, cf, group))
    assert drops == _reference_drops(cfg_j, p, x, cf, group)
    if cf == 0.5:
        assert drops > 0
    if cf == cfg_j.n_experts / cfg_j.experts_per_token:
        assert drops == 0


@pytest.mark.parametrize("kind", ["logical", "permuted", "replicated"])
def test_capacity_without_drops_equals_dense_dispatch(layer, kind):
    """At cf = E / k every bucket holds its whole group: the capacity
    block computes the dense block's function."""
    cfg_j, cfg_t, p, x = layer
    pt = params_from_jax(_layout(p, kind), "cpu")
    xt = torch.from_numpy(x)
    cf = cfg_t.n_experts / cfg_t.experts_per_token
    yc, ac, fc = moe.moe_block_capacity(cfg_t, pt, xt, capacity_factor=cf,
                                        group=8)
    yd, ad, fd = moe.moe_block(cfg_t, pt, xt)
    torch.testing.assert_close(yc, yd, **TOL)
    assert torch.equal(fc, fd) and torch.equal(ac, ad)


def test_capacity_refuses_a_sequence_its_groups_do_not_split(layer):
    _, cfg_t, p, x = layer
    with pytest.raises(ValueError, match="split"):
        moe.moe_block_capacity(cfg_t, params_from_jax(p, "cpu"),
                               torch.from_numpy(x[:, :12]), group=8)


# --------------------------------------------------------- replication
@pytest.mark.parametrize("stacked", [False, True], ids=["layer", "stacked"])
def test_replicate_expert_builds_the_reference_layout(layer, stacked):
    """Twice replicated (expert 1, then 1 again from its first row): the
    weight rows, owner and share equal the reference's bit for bit, per
    layer and for the (L, E, ...) stacks (layers whose expert 1 sits on
    different physical rows)."""
    cfg_j, _, p, _ = layer
    if stacked:
        E = p["w_gate"].shape[0]
        perms = [np.arange(E), np.array([3, 1, 0, 2]), np.array([1, 2, 3, 0])]
        p = {k: np.stack([v[pm] if k.startswith("w_") else v
                          for pm in perms]) for k, v in p.items()}
        p["owner"] = np.stack(perms).astype(np.int32)
        p["share"] = np.ones((3, E), np.float32)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, "cpu")
    for _ in range(2):
        pj = jmoe.replicate_expert(pj, 1)
        pt = moe.replicate_expert(pt, 1)
        for k in pj:
            np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]),
                                          err_msg=k)
            assert pt[k].dtype == params_from_jax(np.asarray(pj[k]),
                                                  "cpu").dtype
    ax = 1 if stacked else 0
    assert pt["w_gate"].shape[ax] == cfg_j.n_experts + 2
    own, sh = pt["owner"].reshape(-1, pt["owner"].shape[-1]), \
        pt["share"].reshape(-1, pt["share"].shape[-1])
    for o, s in zip(own, sh):
        assert o[-2:].tolist() == [1, 1]
        torch.testing.assert_close(s[o == 1], torch.full((3,), 1 / 3),
                                   rtol=0, atol=0)
        assert (s[o != 1] == 1).all()


def test_replicate_expert_leaves_its_input_unchanged(layer):
    _, _, p, _ = layer
    pt = params_from_jax(p, "cpu")
    before = {k: v.clone() for k, v in pt.items()}
    moe.replicate_expert(pt, 2)
    assert set(pt) == set(before)
    assert all(torch.equal(pt[k], before[k]) for k in before)


@pytest.mark.parametrize("block", ["dense", "capacity"])
def test_replicated_block_matches_reference_and_the_unreplicated_one(layer,
                                                                     block):
    """The replicated layout's output is within 1e-5 of the reference's
    on the same layout, and of the unreplicated block's.  In the port the
    dense block's equals the unreplicated one's bit for bit (its combine
    adds the two halves of one expert's output to each other first); the
    capacity block's does not (its combine sums every (row, slot) term of
    a token in one contraction, so the halves meet other experts' terms
    in between)."""
    cfg_j, cfg_t, p, x = layer
    rep = _layout(p, "replicated")
    xt = torch.from_numpy(x)
    if block == "dense":
        yj, _, _ = jmoe.moe_block(cfg_j, jax.tree.map(jnp.asarray, rep),
                                  jnp.asarray(x), NULL)
        run = lambda pp: moe.moe_block(cfg_t, pp, xt)[0]
    else:
        yj, _, _ = jmoe.moe_block_capacity(
            cfg_j, jax.tree.map(jnp.asarray, rep), jnp.asarray(x), NULL,
            capacity_factor=2.0, group=8)
        run = lambda pp: moe.moe_block_capacity(cfg_t, pp, xt,
                                                capacity_factor=2.0,
                                                group=8)[0]
    got = run(params_from_jax(rep, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(yj), **TOL)
    plain = run(params_from_jax(_layout(p, "identity"), "cpu"))
    torch.testing.assert_close(got, plain, **TOL)
    if block == "dense":
        assert torch.equal(got, plain)


# ------------------------------------------------------------ the model
def _compiled(model):
    """The reference's forward, prefill and decode step, compiled once
    each (prefill's and decode's state donated, as its engine does)."""
    return (jax.jit(model.forward),) + tuple(
        jax.jit(f, donate_argnums=(1,))
        for f in (model.prefill, model.decode_step))


@pytest.fixture(scope="module")
def model_pair():
    cfg_j = reduced_config("mixtral-8x7b")
    cfg_t = get_config(cfg_j.name).with_overrides(
        **dataclasses.asdict(cfg_j))
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0)))
    return cfg_j, cfg_t, params


def test_build_model_passes_the_capacity_options():
    cfg = get_config("mixtral-8x7b")
    m = build_model(cfg, device="cpu", capacity_moe=True,
                    capacity_factor=2.5)
    assert isinstance(m, TransformerLM)
    assert (m.capacity_moe, m.capacity_factor) == (True, 2.5)
    m = build_model(cfg, device="cpu")
    assert (m.capacity_moe, m.capacity_factor) == (False, 1.25)


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_capacity_model_matches_reference(model_pair, cf, use_kernel):
    """``capacity_moe=True``: forward logits, then a lock-step prefill of
    12 tokens (past the window: the ring) and 4 greedy decode steps."""
    cfg_j, cfg_t, params = model_pair
    mj = jax_build_model(cfg_j, capacity_moe=True, capacity_factor=cf,
                         use_kernel=use_kernel)
    mt = build_model(cfg_t, capacity_moe=True, capacity_factor=cf,
                     use_kernel=use_kernel, device="cpu")
    pj = jax.tree.map(jnp.asarray, params)
    pt = params_from_jax(params, "cpu")
    toks = np.random.default_rng(2).integers(
        0, cfg_j.vocab_size, (2, 12)).astype(np.int32)
    forward, prefill, step = _compiled(mj)
    want, _ = forward(pj, jnp.asarray(toks))
    got, _ = mt.forward(pt, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_LOGITS)
    sj = mj.init_decode_state(pj, 2, 24)
    st = mt.init_decode_state(pt, 2, 24)
    lj, sj = prefill(pj, sj, jnp.asarray(toks))
    lt, st = mt.prefill(pt, st, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL_LOGITS)
    for _ in range(4):
        nxt = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)
        lj, sj = step(pj, sj, jnp.asarray(nxt))
        lt, st = mt.decode_step(pt, st, torch.from_numpy(nxt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL_LOGITS)
        np.testing.assert_allclose(st["expert_load"].numpy(),
                                   np.asarray(sj["expert_load"]), **TOL)
