"""The port's training path against the JAX package's on the same weights.

Every family's loss and gradients against ``jax.value_and_grad(
model.loss)`` (the reference's ``ALL``: every assigned arch and
paper-gpt, at ``reduced_config``'s float32 widths), MoE under dense and
capacity dispatch, one ``AdamW.update`` and ``cosine_schedule`` against
the reference's, ``SyntheticLM`` bit for bit, the remat policies bit-equal
to none inside the port, and the kernels' refusal to be differentiated.

Weights come from the reference's ``init`` with every constant leaf
(zero biases, gates, adapters, ``u``, SSM parameters; unit norms and
``D``; mixes at 0.5; ``w0`` at -6) moved by seeded 0.3 N(0, 1): a zero
leaf would hide a wrong or missing term.  Tolerances: loss within 1e-5,
gradients within 1e-4 of each leaf's largest magnitude (float32; the two
frameworks sum in different orders).  Measured: loss gaps <= 4.8e-7,
gradient gaps <= 2.8e-5 (zamba2-2.7b, the widest).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.data.pipeline import (ShardedPrefetcher, SyntheticLM,
                                       make_train_pipeline)
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models.api import batch_extras, build_model
from repro_torch.optim.adamw import (AdamW, AdamWState, cosine_schedule,
                                     tree_leaves, tree_map)
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.test_torch_gpu import AUTOGRAD_ENTRY_POINTS, autograd_case
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

ALL = list(ASSIGNED_ARCHS) + ["paper-gpt"]
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4


def _cfgs(arch, **over):
    cfg_j = reduced_config(arch, **over)
    return cfg_j, get_config(arch).with_overrides(**dataclasses.asdict(cfg_j))


def perturbed(tree, rng):
    """The numpy params with every constant floating leaf moved by seeded
    0.3 N(0, 1)."""
    if isinstance(tree, dict):
        return {k: perturbed(v, rng) for k, v in sorted(tree.items())}
    a = np.asarray(tree)
    if a.dtype.kind == "f" and a.size and np.all(a == a.flat[0]):
        a = (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


@functools.lru_cache(maxsize=None)
def _cached_setup(arch, seed, over):
    cfg_j, cfg_t = _cfgs(arch, **dict(over))
    params = perturbed(jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(seed))),
        np.random.default_rng(seed))
    return cfg_j, cfg_t, params


def _setup(arch, seed=0, **over):
    """(reference config, port config, perturbed numpy params), built once
    a module per argument set (callers copy the leaves into tensors)."""
    return _cached_setup(arch, seed, tuple(sorted(over.items())))


def _batch(cfg_t, B=2, S=16, seed=1):
    """Tokens and labels from a seed; the VLM adds ``batch_extras``'
    image inputs (1601 rows, all valid) filled with seeded 0.5 N(0, 1)
    embeddings (the stub's zeros would leave wk/wv without gradient)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg_t.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for k, v in batch_extras(cfg_t, B, torch.float32).items():
        batch[k] = v.numpy()
        if k == "img_embeds":
            batch[k] = (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
    return batch


def _reference_value_and_grad(cfg_j, params, batch, **kw):
    fn = jax.jit(jax.value_and_grad(jax_build_model(cfg_j, **kw).loss))
    loss, grads = fn(jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, batch))
    return float(loss), jax.tree.map(np.asarray, grads)


def _assert_grads_close(got, want, rel=GRAD_REL):
    """Leaf by leaf, within ``rel`` of the leaf's largest magnitude."""
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_grads_close(got[k], want[k], rel)
            continue
        w = np.asarray(want[k])
        g = got[k].detach().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= rel * scale, (k, np.abs(g - w).max(),
                                                    scale)


def _port_value_and_grad(cfg_t, params, batch, **kw):
    model = build_model(cfg_t, device="cpu", **kw)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = value_and_grad(model.loss, params_from_jax(params, "cpu"),
                                 tb)
    return loss.item(), grads


# ------------------------------------------------------ loss and grads
@pytest.mark.parametrize("arch", ALL)
def test_loss_and_grads_match_reference(arch):
    """Every family: rwkv6-7b and zamba2-2.7b backpropagate (their forward
    writes no tensor autograd saved), the MoE archs' loss carries 0.01
    times the aux loss, the VLM's images reach both K/V projections."""
    cfg_j, cfg_t, params = _setup(arch)
    batch = _batch(cfg_t)
    want_loss, want = _reference_value_and_grad(cfg_j, params, batch)
    loss, grads = _port_value_and_grad(cfg_t, params, batch)
    assert abs(loss - want_loss) <= LOSS_ATOL, (loss, want_loss)
    _assert_grads_close(grads, want)
    assert all(g.abs().max() > 0 for g in tree_leaves(grads)
               if g.numel() > 1), "a leaf without gradient"


def test_capacity_moe_loss_and_grads_match_reference():
    """GShard capacity dispatch at cf 1.25, which drops assignments: the
    dropped (token, expert) pairs take no gradient in either package."""
    kw = dict(capacity_moe=True, capacity_factor=1.25)
    cfg_j, cfg_t, params = _setup("mixtral-8x7b")
    batch = _batch(cfg_t, S=24)
    want_loss, want = _reference_value_and_grad(cfg_j, params, batch, **kw)
    loss, grads = _port_value_and_grad(cfg_t, params, batch, **kw)
    assert abs(loss - want_loss) <= LOSS_ATOL
    _assert_grads_close(grads, want)


def test_forward_returns_the_aux_loss_summed_over_layers():
    """``forward`` returns (logits, aux) as the reference's does; aux is
    the layers' load-balancing terms summed in order (zero without
    MoE)."""
    cfg_j, cfg_t, params = _setup("mixtral-8x7b")
    toks = _batch(cfg_t)["tokens"]
    lj, aj = jax.jit(jax_build_model(cfg_j).forward)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(toks))
    lt, at = build_model(cfg_t, device="cpu").forward(
        params_from_jax(params, "cpu"), torch.from_numpy(toks))
    assert at.dtype == torch.float32 and at.shape == ()
    assert abs(at.item() - float(aj)) <= 1e-6 * abs(float(aj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=1e-4)
    cfg_d, cfg_dt, pd = _setup("llama3-8b")
    _, aux = build_model(cfg_dt, device="cpu").forward(
        params_from_jax(pd, "cpu"), torch.from_numpy(toks))
    assert aux.item() == 0.0


def test_train_step_matches_the_reference_step():
    """``make_train_step`` (loss, grads, AdamW with its default clip and
    decay) against the reference's jitted step from the same weights.
    Adam's first step is mhat / (sqrt(nhat) + eps), about sign(g) where
    |g| >> eps: a gradient element within rounding of zero may step
    either way, so this step takes eps 1e-3, where the update is smooth
    in g at the gradients' rounding."""
    cfg_j, cfg_t, params = _setup("llama3-8b")
    batch = _batch(cfg_t)
    ref_model = jax_build_model(cfg_j)
    ref_opt = jadamw.AdamW(lr=1e-3, eps=1e-3)

    @jax.jit
    def ref_step(p, o, b):
        loss, grads = jax.value_and_grad(ref_model.loss)(p, b)
        new_p, new_o = ref_opt.update(grads, o, p)
        return new_p, new_o, loss

    pj = jax.tree.map(jnp.asarray, params)
    want_p, want_o, want_loss = ref_step(pj, ref_opt.init(pj),
                                         jax.tree.map(jnp.asarray, batch))
    opt = AdamW(lr=1e-3, eps=1e-3)
    pt = params_from_jax(params, "cpu")
    step = make_train_step(build_model(cfg_t, device="cpu"), opt)
    got_p, got_o, loss = step(pt, opt.init(pt),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert abs(loss.item() - float(want_loss)) <= LOSS_ATOL
    assert int(got_o.step) == int(want_o.step) == 1
    assert all(not t.requires_grad for t in tree_leaves(got_p))
    _assert_grads_close(got_p, jax.tree.map(np.asarray, want_p), rel=1e-6)
    _assert_grads_close(got_o.mu, jax.tree.map(np.asarray, want_o.mu))


# ----------------------------------------------------------- optimizer
def _tree(rng, dtype):
    return {"a": rng.standard_normal((5, 7)).astype(dtype),
            "b": {"c": rng.standard_normal((11,)).astype(dtype)}}


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(grad_clip, dtype):
    """One update at step 5 from nonzero moments, with and without the
    global-norm clip, on float32 and bfloat16 params (float32 moments):
    params and moments within 1e-6."""
    rng = np.random.default_rng(0)
    params, grads = _tree(rng, np.float32), _tree(rng, np.float32)
    grads = tree_map(lambda g: 3.0 * g, grads)
    mu, nu = _tree(rng, np.float32), tree_map(np.abs, _tree(rng, np.float32))
    sched = dict(peak_lr=1e-2, warmup=3, total=20)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    jgrads = jax.tree.map(lambda a: jnp.asarray(a, dtype), grads)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(**sched),
                        grad_clip=grad_clip)
    jstate = jadamw.AdamWState(jnp.asarray(5, jnp.int32),
                               jax.tree.map(jnp.asarray, mu),
                               jax.tree.map(jnp.asarray, nu))
    want_p, want_s = jax.jit(jopt.update)(jgrads, jstate, jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tgrads = params_from_jax(jax.tree.map(np.asarray, jgrads), "cpu")
    opt = AdamW(lr=cosine_schedule(**sched), grad_clip=grad_clip)
    state = AdamWState(torch.tensor(5, dtype=torch.int32),
                       params_from_jax(mu, "cpu"), params_from_jax(nu, "cpu"))
    got_p, got_s = opt.update(tgrads, state, tparams)
    assert int(got_s.step) == 6
    wants = [params_from_jax(jax.tree.map(np.asarray, t), "cpu")
             for t in (want_p, want_s.mu, want_s.nu)]
    for got, want in zip((got_p, got_s.mu, got_s.nu), wants):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert g.dtype == w.dtype
            torch.testing.assert_close(g.float(), w.float(), atol=1e-6,
                                       rtol=1e-6)


def test_cosine_schedule_matches_reference():
    steps = np.arange(0, 121, dtype=np.int32)
    want = jax.jit(jax.vmap(jadamw.cosine_schedule(3e-4, 20, 120)))(
        jnp.asarray(steps))
    got = cosine_schedule(3e-4, 20, 120)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9,
                               rtol=1e-6)


def test_adamw_descends_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert params["w"].abs().max() < 1e-2


def test_adamw_grad_clip_and_schedule():
    sched = cosine_schedule(1.0, warmup=10, total=100)
    assert sched(torch.tensor(0)) < sched(torch.tensor(10))
    assert sched(torch.tensor(100)) < sched(torch.tensor(10))
    opt = AdamW(lr=1e-2, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    p1, _ = opt.update({"w": torch.full((3,), 1e9)}, opt.init(params),
                       params)
    assert p1["w"].abs().max() < 1.0


# ---------------------------------------------------------------- data
def test_synthetic_lm_equals_reference_bit_for_bit():
    """Batches over several steps, and the cursor: a stream restored from
    the reference's ``state_dict`` continues with the reference's
    batches."""
    ref = JaxSyntheticLM(50257, 33, 3, seed=7)
    mine = SyntheticLM(50257, 33, 3, seed=7)
    ref_it, my_it = iter(ref), iter(mine)
    for _ in range(3):
        a, b = next(ref_it), next(my_it)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state_dict() == ref.state_dict() == {"step": 3, "seed": 7}
    resumed = SyntheticLM(50257, 33, 3, seed=0)
    resumed.load_state_dict(ref.state_dict())
    np.testing.assert_array_equal(next(iter(resumed))["tokens"],
                                  next(ref_it)["tokens"])


def test_pipeline_determinism_and_labels():
    src = SyntheticLM(97, 8, 2, seed=1)
    a = next(iter(src))
    b = next(iter(SyntheticLM(97, 8, 2, seed=1)))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    full = np.concatenate([a["tokens"], a["labels"][:, -1:]], axis=1)
    np.testing.assert_array_equal(full[:, 1:], a["labels"])
    assert a["tokens"].max() < 97 and a["tokens"].min() >= 0


def test_prefetcher_yields_batches_and_refuses_shardings():
    """Batches reach the device the caller names (``device="cpu"``: the
    default is the GPU); a sharding that is not a
    ``partitioning.Sharding`` is refused (placing on a mesh:
    ``tests/test_torch_distributed.py``)."""
    cfg = get_config("llama3-8b").with_overrides(vocab_size=97)
    shape = type("S", (), {"seq_len": 8, "global_batch": 2})()
    src, it = make_train_pipeline(cfg, shape, None, device="cpu")
    b = next(it)
    assert b["tokens"].shape == (2, 8) and b["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(
        b["tokens"].numpy(), next(iter(SyntheticLM(97, 8, 2)))["tokens"])
    it.close()
    with pytest.raises(ValueError, match="Sharding"):
        ShardedPrefetcher(iter(src), shardings={"tokens": None})


# --------------------------------------------------------------- remat
@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch"])
@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b", "rwkv6-7b",
                                  "zamba2-2.7b", "llama-3.2-vision-11b"])
def test_remat_grads_equal_none_bit_for_bit(arch, remat):
    """Activation checkpointing recomputes the same ops on the same
    inputs: loss and every gradient keep their bits."""
    _, cfg_t, params = _setup(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg_t).items()}
    out = []
    for policy in ("none", remat):
        model = build_model(cfg_t, device="cpu", remat=policy)
        out.append(value_and_grad(model.loss,
                                  params_from_jax(params, "cpu"), batch))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert torch.equal(a, b)


def test_unknown_remat_policy_raises():
    cfg = get_config("llama3-8b").with_overrides(n_layers=1, d_model=32,
                                                 vocab_size=50)
    with pytest.raises(ValueError, match="remat"):
        build_model(cfg, device="cpu", remat="offload")


# ------------------------------------------------ the kernels' autograd
@pytest.mark.parametrize("entry", AUTOGRAD_ENTRY_POINTS)
def test_kernel_entry_points_refuse_autograd(entry):
    """Each entry point refuses a differentiated call on every device (on
    the CPU its plain version stands in for the kernel), and runs under
    ``no_grad``."""
    fn, args, kw = autograd_case(entry, "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args, **kw)
    with torch.no_grad():
        fn(*args, **kw)
    fn(*(a.detach() if isinstance(a, torch.Tensor) else a for a in args),
       **kw)


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b", "zamba2-2.7b"])
def test_a_kernel_model_refuses_to_train(arch):
    """A model built with ``use_kernel=True`` raises in a train step
    instead of training with dropped gradients."""
    _, cfg_t, params = _setup(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg_t).items()}
    model = build_model(cfg_t, device="cpu", use_kernel=True)
    with pytest.raises(RuntimeError, match="no backward"):
        value_and_grad(model.loss, params_from_jax(params, "cpu"), batch)
