"""The port's checkpoints, restart policy and training launcher.

The reference's four checkpoint tests (``tests/test_system.py``: round
trip, atomicity and GC, corruption detected, restart bit-identical)
redone in the port; a checkpoint written by the reference's
``Checkpointer`` (float32 and bfloat16) restoring in the port's; the
port's manifest and files equal to the reference's for the same tree;
``RestartPolicy`` resuming after a fault; and ``launch.train.main``
resumed after a fault equal to a straight run, bit for bit.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamW, AdamWState, tree_leaves
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, RestartPolicy
from repro_torch.tree import map_with_path
from repro_torch.weights import params_from_jax
from tests.conftest import reduced_config
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def _port(arch, **over):
    cfg = get_config(arch).with_overrides(
        **dataclasses.asdict(reduced_config(arch, **over)))
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------------ checkpoint
def test_checkpoint_roundtrip(tmp_path):
    _, _, params = _port("llama3-8b")
    ck = Checkpointer(tmp_path, keep=2)
    ck.save(3, params)
    ck.save(7, params)
    assert ck.all_steps() == [3, 7]
    _assert_trees_equal(ck.restore(7, params), params)
    _assert_trees_equal(ck.restore(3, params, device="cpu"), params)


def test_checkpoint_atomicity_and_gc(tmp_path):
    _, _, params = _port("musicgen-large")
    ck = Checkpointer(tmp_path, keep=1)
    for s in (1, 2, 3):
        ck.save(s, params)
    assert ck.all_steps() == [3]          # gc keeps 1
    # a partial (uncommitted) dir must be invisible
    bad = tmp_path / "step_00000099"
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert ck.latest_step() == 3


def test_checkpoint_detects_corruption(tmp_path):
    _, _, params = _port("llama3-8b")
    ck = Checkpointer(tmp_path)
    path = ck.save(1, params)
    victim = next(p for p in path.glob("*.npy"))
    arr = np.load(victim).copy()
    arr.flat[0] += 1
    np.save(victim, arr)
    with pytest.raises(IOError):
        ck.restore(1, params)


def test_training_restart_is_bit_identical(tmp_path):
    """Kill-and-resume: restored run == uninterrupted run (data cursor,
    params and optimizer state all restored)."""
    cfg, model, params = _port("llama3-8b")
    opt = AdamW(lr=1e-3)
    src = SyntheticLM(cfg.vocab_size, 16, 4, seed=5)
    it = iter(src)
    opt_state = opt.init(params)
    step = make_train_step(model, opt)

    def batch(it):
        return {k: torch.from_numpy(v) for k, v in next(it).items()}

    ck = Checkpointer(tmp_path)
    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, batch(it))
    ck.save(2, {"params": params, "opt": opt_state,
                "data": src.state_dict()})
    for _ in range(2):
        params, opt_state, loss_a = step(params, opt_state, batch(it))
    # restart from the checkpoint with a fresh data source
    src2 = SyntheticLM(cfg.vocab_size, 16, 4, seed=0)
    state = ck.restore(2, {"params": params, "opt": opt_state,
                           "data": src.state_dict()})
    src2.load_state_dict(state["data"])
    it2 = iter(src2)
    p2, o2 = state["params"], state["opt"]
    assert isinstance(o2, AdamWState) and int(o2.step) == 2
    for _ in range(2):
        p2, o2, loss_b = step(p2, o2, batch(it2))
    assert loss_a.item() == loss_b.item()
    _assert_trees_equal(params, p2)
    _assert_trees_equal(opt_state.mu, o2.mu)


def test_restore_refuses_shardings(tmp_path):
    """``shardings`` must hold a ``partitioning.Sharding`` per leaf: a
    tree of tensors is refused (restoring onto a mesh:
    ``tests/test_torch_distributed.py``)."""
    _, _, params = _port("llama3-8b")
    ck = Checkpointer(tmp_path)
    ck.save(1, params)
    with pytest.raises(ValueError, match="Sharding"):
        ck.restore(1, params, shardings=params)


def _train_state(params):
    return {"params": params, "opt": AdamW().init(params),
            "data": {"step": 3, "seed": 5}}


def test_restore_refuses_a_leaf_the_shardings_do_not_name(tmp_path):
    """A leaf missing from ``shardings`` (a param that ``param_shardings``
    forgot) raises instead of coming back whole; None must be written."""
    _, _, params = _port("llama3-8b")
    state = _train_state(params)
    ck = Checkpointer(tmp_path)
    ck.save(1, state)
    missing = sorted(params)[-1]
    sh = {"params": {k: None for k in params if k != missing},
          "opt": AdamWState(step=None, mu=None, nu=None), "data": None}
    with pytest.raises(ValueError, match=f"name no Sharding for "
                                         f"params/{missing}"):
        ck.restore(1, state, shardings=sh)
    with pytest.raises(ValueError, match="name no Sharding for data/seed"):
        ck.restore(1, state, shardings={"params": None, "opt": None})


@pytest.mark.parametrize("where", ["leaves", "prefixes"])
def test_restore_keeps_a_leaf_whose_sharding_is_none(tmp_path, where):
    """A None written at a leaf or at a prefix of its path restores the
    leaf as ``like_tree`` has it (a train state's step and data cursor in
    ``runtime.elastic.elastic_restore``)."""
    _, _, params = _port("llama3-8b")
    state = _train_state(params)
    ck = Checkpointer(tmp_path)
    ck.save(1, state)
    sh = (map_with_path(lambda *_: None, state) if where == "leaves" else
          {"params": None, "opt": AdamWState(step=None, mu=None, nu=None),
           "data": None})
    got = ck.restore(1, state, shardings=sh)
    _assert_trees_equal(got["params"], params)
    _assert_trees_equal(got["opt"].mu, state["opt"].mu)
    assert int(got["opt"].step) == 0
    assert {k: int(v) for k, v in got["data"].items()} == state["data"]


# --------------------------------------------- the reference's format
def _reference_tree(dtype):
    """The reference's train-state tree for reduced llama3-8b params in
    ``dtype``: params, an AdamW state with seeded moments at step 3, and
    the data cursor."""
    cfg = reduced_config("llama3-8b", param_dtype=dtype)
    params = jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(0))
    opt = jadamw.AdamW().init(params)
    mu = jax.tree.map(lambda m: m + 0.5, opt.mu)
    return {"params": params,
            "opt": jadamw.AdamWState(jnp.asarray(3, jnp.int32), mu, opt.nu),
            "data": {"step": 3, "seed": 5}}


def _as_port(tree):
    """The same tree as the port holds it."""
    opt = tree["opt"]
    return {"params": params_from_jax(jax.tree.map(np.asarray,
                                                   tree["params"]), "cpu"),
            "opt": AdamWState(torch.tensor(int(opt.step), dtype=torch.int32),
                              params_from_jax(jax.tree.map(np.asarray,
                                                           opt.mu), "cpu"),
                              params_from_jax(jax.tree.map(np.asarray,
                                                           opt.nu), "cpu")),
            "data": dict(tree["data"])}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    ref_tree = _reference_tree(dtype)
    JaxCheckpointer(tmp_path).save(4, ref_tree)
    like = _as_port(ref_tree)
    zeroed = {"params": jax.tree.map(lambda t: torch.zeros_like(t),
                                     like["params"]),
              "opt": like["opt"], "data": {"step": 0, "seed": 0}}
    got = Checkpointer(tmp_path).restore(4, zeroed)
    _assert_trees_equal(got["params"], like["params"])
    assert got["params"]["tok_embed"].dtype == getattr(torch, dtype)
    _assert_trees_equal(got["opt"].mu, like["opt"].mu)
    assert int(got["opt"].step) == 3
    assert {k: int(v) for k, v in got["data"].items()} == {"step": 3,
                                                          "seed": 5}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manifest_and_files_equal_the_reference(tmp_path, dtype):
    """The same tree saved by both packages: the manifest (keys, file
    names, shapes, dtypes, sha1) and every file byte for byte."""
    ref_tree = _reference_tree(dtype)
    a = JaxCheckpointer(tmp_path / "ref").save(4, ref_tree)
    b = Checkpointer(tmp_path / "port").save(4, _as_port(ref_tree))
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    assert ma == mb
    assert list(ma["leaves"]) == list(mb["leaves"])
    assert "opt/mu/layers/attn/wq" in ma["leaves"]
    assert ma["leaves"]["params/tok_embed"]["dtype"] == dtype
    for meta in ma["leaves"].values():
        assert (a / meta["file"]).read_bytes() == \
            (b / meta["file"]).read_bytes()


def test_save_async_writes_a_copy(tmp_path):
    """``save_async`` copies the tree before it returns: later writes to
    the live tensors do not reach the checkpoint."""
    _, _, params = _port("llama3-8b")
    want = {k: v.clone() for k, v in params.items() if k != "layers"}
    ck = Checkpointer(tmp_path)
    ck.save_async(1, params)
    params["tok_embed"].add_(1.0)
    ck.wait()
    got = ck.restore(1, params)
    assert torch.equal(got["tok_embed"], want["tok_embed"])
    assert [r["op"] for r in ck.log] == ["save", "restore"]


# ---------------------------------------------------------------- restart
def test_restart_policy_resumes_after_one_fault(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(4, {"x": torch.zeros(2)})
    monitor = HeartbeatMonitor(1)
    policy = RestartPolicy(ck, backoff_s=0, monitor=monitor)
    resumed = []

    def train_fn(resume):
        resumed.append(resume)
        if len(resumed) == 1:
            raise RuntimeError("worker lost")

    policy.run(train_fn)
    assert resumed == [4, 4] and policy.failures == 1
    ev = policy.events[0]
    assert (ev["kind"], ev["error_type"], ev["error"], ev["resume_step"]) \
        == ("worker_fault", "RuntimeError", "worker lost", 4)
    assert monitor.events[-1]["kind"] == "worker_fault"


def test_restart_policy_gives_up_after_its_retries(tmp_path):
    policy = RestartPolicy(Checkpointer(tmp_path), max_retries=2,
                           backoff_s=0)
    calls = []

    def train_fn(resume):
        calls.append(resume)
        raise ValueError("always")

    with pytest.raises(ValueError):
        policy.run(train_fn)
    assert calls == [None, None, None] and policy.failures == 3


# ---------------------------------------------------------- the launcher
ARGV = ["--device", "cpu", "--reduced", "--d-model", "64", "--steps", "6",
        "--batch", "2", "--seq", "16", "--ckpt-every", "3",
        "--log-every", "1"]


class FaultAtStep(list):
    """A ``record`` whose append raises once, at one step: a worker fault
    after the step's update and before its checkpoint."""

    def __init__(self, step):
        super().__init__()
        self.step = step

    def append(self, item):
        if item.get("step") == self.step:
            self.step = None
            raise RuntimeError(f"fault at step {item['step']}")
        super().append(item)


def test_train_main_resumed_after_a_fault_equals_a_straight_run(tmp_path):
    """``main`` 6 steps straight, and 6 steps with a fault after step 4
    under ``RestartPolicy``: the restart resumes from the step-3
    checkpoint and runs 3 more; final loss and the step-6 checkpoint
    (params, moments, cursor: every leaf's sha1) equal the straight
    run's."""
    straight = train.main(ARGV + ["--ckpt", str(tmp_path / "a")])
    record = FaultAtStep(4)
    ck = Checkpointer(tmp_path / "b")
    losses = []
    policy = RestartPolicy(ck, backoff_s=0)
    policy.run(lambda resume: losses.append(train.main(
        ARGV + ["--ckpt", str(tmp_path / "b"), "--resume"], record=record)))
    assert policy.failures == 1 and policy.events[0]["resume_step"] is None
    assert [r["step"] for r in record if "loss" in r] == [1, 2, 3, 4, 5, 6]
    assert [(r["op"], r["step"]) for r in record if "op" in r] == \
        [("restore", 3), ("save", 6)]
    assert losses == [straight]
    ma, mb = (json.loads((tmp_path / d / "step_00000006" /
                          "manifest.json").read_text()) for d in "ab")
    assert ma == mb


def test_train_main_wants_the_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda trains on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1", "--ckpt", str(tmp_path)])


def test_reduced_for_cpu_matches_the_reference():
    from repro.configs import get_config as jax_get_config
    from repro.launch.train import reduced_for_cpu as jax_reduced
    for arch in ("llama3-8b", "mixtral-8x7b", "zamba2-2.7b",
                 "llama-3.2-vision-11b", "rwkv6-7b"):
        want = dataclasses.asdict(jax_reduced(jax_get_config(arch), 64, 3))
        got = dataclasses.asdict(train.reduced_for_cpu(get_config(arch), 64,
                                                       3))
        assert got == want


def test_quickstart_and_train_100m_run(monkeypatch):
    """The quickstart trains (the loss falls) and generates 12 tokens;
    train_100m hands ``launch.train.main`` the reference example's flags
    plus the device."""
    from repro_torch.launch import quickstart, train_100m
    losses, out = quickstart.main(["--device", "cpu", "--use-kernel"])
    assert losses[-1] < losses[0] and len(out) == 12
    seen = []
    monkeypatch.setattr(train_100m, "train_main", seen.append)
    train_100m.main(["--device", "cpu", "--steps", "7", "--ckpt", "x"])
    assert seen == [["--arch", "llama3-8b", "--reduced", "--d-model", "768",
                     "--n-layers", "12", "--steps", "7", "--batch", "4",
                     "--seq", "256", "--ckpt", "x", "--ckpt-every", "50",
                     "--log-every", "5", "--device", "cpu"]]
