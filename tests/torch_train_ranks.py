"""Training on a DeviceMesh: the four gloo ranks and the parent's
expectations behind ``tests/test_torch_train_shard*.py``, and the fsdp
inference ranks behind ``tests/test_torch_fsdp_serve.py``.

Each test file starts four CPU ranks over gloo in one subprocess (its own
timeout) for its cases.  The parent writes each arch's weights — the JAX
package's init from seed 0 at the reduced float32 widths of
``tests/conftest.reduced_config``, every constant floating leaf (zero
biases, gates, adapters, ``u``, the SSM parameters; unit norms and ``D``;
the mixes at 0.5; ``w0``) moved by seeded 0.3 N(0, 1), as
``tests/test_torch_train.py`` moves them: a zero leaf would hide a
gradient summed on the wrong ranks — and while the ranks run computes
what they are held to: the JAX package's ``value_and_grad(model.loss)``
on the first batch (jitted once an arch and dispatch).

A train case (``CASES``) runs ``launch.steps.train_cell`` — the
reference's train cell: fsdp, sequence parallelism under the tp layout,
remat "full", capacity dispatch for a MoE unless the case says dense —
on its mesh, and every rank reports:
- the loss and every gradient leaf (``full_tensor``) on the first batch
  against the unsharded port's on the same weights and against the JAX
  package's (the largest gap over the leaves, relative to each leaf's
  largest magnitude, and the leaf it is at);
- the losses of ``STEPS`` AdamW steps (``OPT``: clipped at 1.0) and the
  params after them against the unsharded port's steps;
- whether every gradient, moment and updated param is placed as
  ``param_shardings(fsdp=, layout=)`` places it.
The zero3 case feeds its steps through ``ShardedPrefetcher(shardings=
batch_shardings(..., layout="zero3"))``: its batch spans every mesh
dimension.  The extra runs: ``fault`` (RWKV-6 on (2, 2) with Megatron's
"f" given an identity backward, then its "g" an all-reduce backward: the
gradient gaps the tests must see above their bound) and ``resume`` (the
dense cell on (2, 2) takes one step, saves ``{"params", "opt", "data"}``,
restores onto (1, 4) through ``runtime.elastic.elastic_restore`` and
takes two more, against the unsharded port's three).

An inference case (``SERVE``: dense, MoE, RWKV-6, Zamba2; the recurrent
two under the zero3 layout too) places the weights by
``param_shardings(fsdp=True, layout=)`` on (2, 2) and runs a lock-step
prefill and ``DECODE`` greedy decode steps on ``make_partitioner(mesh,
fsdp=True, layout=)``, against the unsharded port's logits, and reports
the local shape and placements of one matmul weight (``FSDP_LEAF``).

The worker imports no JAX.  ``python tests/torch_train_ranks.py <dir>
<case> ...`` runs the ranks by hand once the parent has written
``<dir>``'s weights and ``ref.npz``.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
B, S, STEPS = 4, 16, 3
I_IMG = 8
IMG_ROWS = (8, 5, 8, 3)          # the VLM's valid image rows a batch row
# AdamW of the parity runs: eps 1e-3 keeps the step's derivative in the
# gradient below 1 / eps where a gradient element is near zero (Adam's
# first step is ~lr · sign(g))
OPT = dict(lr=1e-3, eps=1e-3, grad_clip=1.0)
DECODE = 8

MESHES = {"(2, 2)": ((2, 2), ("data", "model")),
          "(1, 4)": ((1, 4), ("data", "model")),
          "(2, 1, 2)": ((2, 1, 2), ("pod", "data", "model"))}
CASES = {
    "llama3 fsdp sp (2, 2)": dict(arch="llama3-8b", mesh="(2, 2)"),
    "llama3 tp 4 (1, 4)": dict(arch="llama3-8b", mesh="(1, 4)",
                               fsdp=False),
    "llama3 zero3 (2, 2)": dict(arch="llama3-8b", mesh="(2, 2)",
                                layout="zero3", prefetch=True),
    "mixtral capacity (2, 1, 2)": dict(arch="mixtral-8x7b",
                                       mesh="(2, 1, 2)"),
    "mixtral dense (2, 1, 2)": dict(arch="mixtral-8x7b", mesh="(2, 1, 2)",
                                    capacity=False),
    "rwkv6 fsdp sp (2, 2)": dict(arch="rwkv6-7b", mesh="(2, 2)"),
    "rwkv6 zero3 (2, 2)": dict(arch="rwkv6-7b", mesh="(2, 2)",
                               layout="zero3"),
    "zamba2 fsdp sp (2, 2)": dict(arch="zamba2-2.7b", mesh="(2, 2)"),
    "zamba2 zero3 (2, 2)": dict(arch="zamba2-2.7b", mesh="(2, 2)",
                                layout="zero3"),
    "musicgen fsdp sp (2, 2)": dict(arch="musicgen-large", mesh="(2, 2)"),
    "vlm fsdp sp (2, 2)": dict(arch="llama-3.2-vision-11b", mesh="(2, 2)"),
    "vlm zero3 (2, 2)": dict(arch="llama-3.2-vision-11b", mesh="(2, 2)",
                             layout="zero3"),
    "mixtral zero3 (2, 1, 2)": dict(arch="mixtral-8x7b", mesh="(2, 1, 2)",
                                    layout="zero3"),
}
SERVE = {"llama3 fsdp (2, 2)": dict(arch="llama3-8b"),
         "mixtral fsdp (2, 2)": dict(arch="mixtral-8x7b"),
         "rwkv6 fsdp (2, 2)": dict(arch="rwkv6-7b"),
         "zamba2 fsdp (2, 2)": dict(arch="zamba2-2.7b"),
         "rwkv6 zero3 decode (2, 2)": dict(arch="rwkv6-7b",
                                           layout="zero3"),
         "zamba2 zero3 decode (2, 2)": dict(arch="zamba2-2.7b",
                                            layout="zero3")}
# a matmul weight of each family, stored over "data" (its D rows) and
# "model" under fsdp: the serve cases report its local shape
FSDP_LEAF = {"dense": ("mlp", "w_up"), "moe": ("moe", "w_up"),
             "ssm": ("wr",), "hybrid": ("w_in",)}
FAULTS = ("identity at f", "all-reduce at g")
# every arch registered in both packages
REDUCED_ARCHS = ("llama3-8b", "glm4-9b", "qwen1.5-32b", "qwen1.5-110b",
                 "paper-gpt", "mixtral-8x7b", "mixtral-8x22b", "rwkv6-7b",
                 "musicgen-large", "llama-3.2-vision-11b", "zamba2-2.7b")


def port_cfg(arch):
    """``arch`` at the reduced widths of ``tests/conftest.reduced_config``
    (``repro_torch.configs.reduced``, without JAX)."""
    from repro_torch.configs.reduced import reduced_config
    return reduced_config(arch)


def capacity(case) -> bool:
    c = CASES[case]
    return c.get("capacity", True) and port_cfg(c["arch"]).is_moe


def ref_key(case) -> str:
    """The reference run a case is held to: its arch and dispatch."""
    return f"{CASES[case]['arch']} capacity={capacity(case)}"


def batches(cfg, n=STEPS, seed=0):
    """``n`` batches of ``SyntheticLM`` (B x S, the reference's stream);
    the VLM's add seeded 0.5 N(0, 1) image embeddings (B, I_IMG, D) with
    ``IMG_ROWS`` valid rows a batch row.  numpy, as the stream gives
    them."""
    from repro_torch.data.pipeline import SyntheticLM
    it = iter(SyntheticLM(cfg.vocab_size, S, B, seed=seed))
    out = []
    for step in range(n):
        b = next(it)
        if cfg.family == "vlm":
            rng = np.random.default_rng(100 + step)
            b["img_embeds"] = (0.5 * rng.standard_normal(
                (B, I_IMG, cfg.d_model))).astype(np.float32)
            b["img_mask"] = np.arange(I_IMG)[None] < np.array(
                IMG_ROWS)[:, None]
        out.append(b)
    return out


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def save_tree(path, tree):
    from repro_torch.tree import flatten
    np.savez(path, **{"/".join(p): np.asarray(v)
                      for p, v in flatten(tree).items()})


def load_tree(path):
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = z[key]
    return out


# ------------------------------------------------------------- the worker
def _gaps(got, want):
    """(largest gap over the leaves relative to each leaf's largest
    magnitude, the leaf it is at): ``got`` DTensors or tensors, ``want``
    tensors or arrays, both trees of one structure."""
    from repro_torch.models.partitioning import whole
    from repro_torch.tree import flatten
    want = flatten(want)
    worst, at = 0.0, ""
    for path, g in flatten(got).items():
        w = torch.as_tensor(np.asarray(want[path]))
        g = whole(g).detach()
        scale = max(w.abs().max().item(), 1e-30)
        gap = (g - w).abs().max().item() / scale
        if gap >= worst:
            worst, at = gap, "/".join(path)
    return worst, at


def _abs_gap(got, want):
    from repro_torch.models.partitioning import whole
    from repro_torch.tree import flatten
    want = flatten(want)
    return max((whole(g) - want[p]).abs().max().item()
               for p, g in flatten(got).items())


def _laid_out(tree, shardings):
    """Whether every DTensor leaf of ``tree`` has the placements
    ``shardings`` (a flattened tree of ``Sharding``) gives its path."""
    from repro_torch.models.partitioning import is_dtensor
    from repro_torch.tree import flatten
    return all(is_dtensor(v) and tuple(v.placements)
               == shardings[p].placements for p, v in flatten(tree).items())


def _weights(out, arch):
    from repro_torch.weights import params_from_jax
    return params_from_jax(load_tree(out / f"weights {arch}.npz"), "cpu")


def _plain_run(cfg, params, cap, bs):
    """The unsharded port: first-batch loss and grads, then STEPS steps'
    losses and the params after them."""
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    opt = AdamW(**OPT)
    model = build_model(cfg, device="cpu", capacity_moe=cap)
    loss, grads = value_and_grad(model.loss, params, tensors(bs[0]))
    step, state, losses = make_train_step(model, opt), opt.init(params), []
    p = params
    for b in bs:
        p, state, l_ = step(p, state, tensors(b))
        losses.append(l_.item())
    return loss.item(), grads, losses, p


def _train_case(report, out, case, ref):
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.data.pipeline import ShardedPrefetcher, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import train_cell, value_and_grad
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import flatten
    c = CASES[case]
    cfg, cap = port_cfg(c["arch"]), capacity(case)
    fsdp, layout = c.get("fsdp", True), c.get("layout", "tp")
    params = _weights(out, c["arch"])
    bs = batches(cfg)
    plain = _plain_run(cfg, params, cap, bs)
    mesh = make_mesh(*MESHES[c["mesh"]], device_type="cpu")
    step, placed, state, b_sh = train_cell(
        cfg, mesh, fsdp=fsdp, layout=layout, remat="full",
        capacity_moe=cap, opt=AdamW(**OPT), params=params)
    sh = flatten(param_shardings(params, cfg, mesh, fsdp=fsdp,
                                 layout=layout))
    if c.get("prefetch"):
        feed = ShardedPrefetcher(iter(SyntheticLM(cfg.vocab_size, S, B)),
                                 shardings=b_sh)
        fed = [next(feed) for _ in range(STEPS)]
        feed.close()
        report[f"batch placed {case}"] = [
            [tuple(map(str, t.placements)) for t in b.values()]
            for b in fed[:1]][0]
    else:
        fed = [tensors(b) for b in bs]
    loss, grads = value_and_grad(step.model.loss, placed, fed[0])
    r = ref[ref_key(case)]
    report[f"loss {case}"] = [abs(loss.item() - plain[0]),
                              abs(loss.item() - r["loss"])]
    report[f"grads {case}"] = [*_gaps(grads, plain[1]),
                               *_gaps(grads, r["grads"])]
    losses, laid = [], _laid_out(grads, sh)
    for b in fed:
        placed, state, l_ = step(placed, state, b)
        losses.append(l_.item())
        laid &= _laid_out(placed, sh) and _laid_out(state.mu, sh) \
            and _laid_out(state.nu, sh)
    report[f"steps {case}"] = [max(abs(a - b) for a, b in
                                   zip(losses, plain[2])),
                               _abs_gap(placed, plain[3])]
    report[f"laid out {case}"] = laid


def _fault_case(report, out):
    """RWKV-6 on (2, 2), fsdp: the first-batch gradient gaps to the
    unsharded port with each planted backward fault."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import train_cell, value_and_grad
    from repro_torch.models import partitioning as P
    cfg = port_cfg("rwkv6-7b")
    params = _weights(out, "rwkv6-7b")
    b = batches(cfg, 1)[0]
    plain = _plain_run(cfg, params, False, [b])
    mesh = make_mesh(*MESHES["(2, 2)"], device_type="cpu")
    step, placed, _, _ = train_cell(cfg, mesh, params=params)
    faults = {
        # the entry of a replicated input into split work without the
        # all-reduce of its partial gradients
        "identity at f": (P._Enter, lambda ctx, g: (g, None)),
        # a sum every rank then uses alike, its gradient all-reduced
        "all-reduce at g": (P._Sum, lambda ctx, g: (
            P._all_reduce(g.clone(), ctx.groups), None, None)),
    }
    for name, (fn, backward) in faults.items():
        real = fn.backward
        fn.backward = staticmethod(backward)
        try:
            _, grads = value_and_grad(step.model.loss, placed, tensors(b))
        finally:
            fn.backward = real
        report[f"fault {name}"] = _gaps(grads, plain[1])[0]
    _, grads = value_and_grad(step.model.loss, placed, tensors(b))
    report["fault none"] = _gaps(grads, plain[1])[0]


# each collective's backward against the gradient of the loss its
# convention defines, on the world's 4 ranks: "split" — each rank's loss
# is its own part of the whole, sum_r l_r (the result feeds work split
# over the ranks); "alike" — every rank computes the same loss l, which is
# the whole (Megatron's and DTensor's convention for a replicated value)
COLLECTIVES = ("gather_rows split", "gather_rows alike",
               "gather_cols split", "gather_cols alike",
               "scatter_rows_sum split", "sum_over alike", "sum_over split",
               "enter_split split", "broadcast_from alike",
               "broadcast_from split")


def _collective_case(report):
    """Each of ``COLLECTIVES``: the largest gap of the rank's gradient to
    the one its convention gives, computed here from every rank's seeded
    weights (a loss sum(w * y): its gradient in y is w)."""
    import torch.distributed as dist
    from repro_torch.models import partitioning as P
    g, r, n = dist.group.WORLD, dist.get_rank(), WORLD
    cols = 7                          # cut 2, 2, 2, 1 over the ranks

    def w(s, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            20 + s))

    def run(name):
        fn, mode = name.split()
        split = mode == "split"
        # this rank's input: its own, or (enter_split) the same on every
        # rank; 2 of gather_cols' 7 columns (the last rank 1), 4 rows to
        # scatter over 4 ranks
        shape = {"gather_cols": (2, 2 - (r == n - 1)),
                 "scatter_rows_sum": (n, 3)}.get(fn, (2, 3))
        x = torch.randn(shape, generator=torch.Generator().manual_seed(
            10 + (0 if fn == "enter_split" else r))).requires_grad_(True)
        if fn == "gather_rows":
            y = P.gather_rows(x, g, redundant=not split)
        elif fn == "gather_cols":
            y = P.gather_cols(x, g, cols, redundant=not split)
        elif fn == "scatter_rows_sum":
            y = P.scatter_rows_sum(x, g)
        elif fn == "sum_over":
            y = P.sum_over(x, (g,), redundant=not split)
        elif fn == "enter_split":
            y = P.enter_split(x, (g,))
        else:
            y = P.broadcast_from(x, g, 1, redundant=not split)
        loss = (w(r if split else 0, y.shape) * y).sum()
        got, = torch.autograd.grad(loss, [x])
        # the gradient the convention gives to this rank's x
        if fn == "gather_rows":
            ws = [w(s if split else 0, (2 * n, 3)) for s in range(n)]
            want = (sum(ws) if split else ws[0])[2 * r:2 * r + 2]
        elif fn == "gather_cols":
            ws = [w(s if split else 0, (2, cols)) for s in range(n)]
            want = (sum(ws) if split else ws[0])[:, 2 * r:2 * r + 2]
            want = want[:, :shape[1]]
        elif fn == "scatter_rows_sum":
            want = torch.cat([w(s, (1, 3)) for s in range(n)])
        elif fn in ("sum_over", "enter_split"):
            want = sum(w(s, (2, 3)) for s in range(n)) if split \
                else w(0, (2, 3))
        else:
            want = (sum(w(s, (2, 3)) for s in range(n)) if split
                    else w(0, (2, 3))) * (r == 1)
        return (got - want).abs().max().item()

    for name in COLLECTIVES:
        report[f"collective {name}"] = run(name)


def _resume_case(report, out):
    """The dense cell: one step on (2, 2), a sharded save, a restore onto
    (1, 4) by ``elastic_restore``, two more steps; the params against the
    unsharded port's three steps, the losses too."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import train_cell
    from repro_torch.optim.adamw import AdamW, AdamWState
    from repro_torch.runtime.elastic import elastic_restore
    from repro_torch.tree import flatten
    cfg = port_cfg("llama3-8b")
    params = _weights(out, "llama3-8b")
    plain = _plain_run(cfg, params, False, batches(cfg))
    src = SyntheticLM(cfg.vocab_size, S, B)
    it = iter(src)
    mesh = make_mesh(*MESHES["(2, 2)"], device_type="cpu")
    step, placed, state, _ = train_cell(cfg, mesh, opt=AdamW(**OPT),
                                        params=params)
    placed, state, l0 = step(placed, state, tensors(next(it)))
    ck = Checkpointer(out / "resume")
    ck.save(1, {"params": placed, "opt": state, "data": src.state_dict()})
    mesh = make_mesh(*MESHES["(1, 4)"], device_type="cpu")
    step, like, like_state, _ = train_cell(cfg, mesh, opt=AdamW(**OPT),
                                           params=params)

    def shardings(m):
        ps = param_shardings(like, cfg, m, fsdp=True)
        return {"params": ps, "opt": AdamWState(step=None, mu=ps, nu=ps),
                "data": None}
    got = elastic_restore(ck, 1, {"params": like, "opt": like_state,
                                  "data": src.state_dict()}, shardings,
                          mesh)
    src = SyntheticLM(cfg.vocab_size, S, B)
    src.load_state_dict(got["data"])
    it, placed, state = iter(src), got["params"], got["opt"]
    losses = [l0.item()]
    for _ in range(2):
        placed, state, l_ = step(placed, state, tensors(next(it)))
        losses.append(l_.item())
    report["resume"] = [
        max(abs(a - b) for a, b in zip(losses, plain[2])),
        _abs_gap(placed, plain[3]), int(state.step.item()),
        _laid_out(placed, flatten(param_shardings(like, cfg, mesh,
                                                  fsdp=True)))]


def _serve_case(report, out, case):
    """Lock-step prefill and DECODE greedy steps on an fsdp partitioner
    (weights stored over "data" too; under the zero3 layout over every
    axis, with heads over nothing and the batch and decode state over
    every axis) against the unsharded port; the largest logit gap, and
    the local shape of a layer's matmul weight."""
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner, place
    from repro_torch.tree import flatten, map_with_path
    arch, layout = SERVE[case]["arch"], SERVE[case].get("layout", "tp")
    cfg = port_cfg(arch)
    params = _weights(out, arch)
    mesh = make_mesh(*MESHES["(2, 2)"], device_type="cpu")
    sh = flatten(param_shardings(params, cfg, mesh, fsdp=True,
                                 layout=layout))
    placed = map_with_path(lambda p, v: place(v, sh[p]), params)
    toks = torch.from_numpy(batches(cfg, 1)[0]["tokens"][:, :12])
    got = []
    for part in (None, make_partitioner(mesh, fsdp=True, layout=layout)):
        kw = {} if part is None else dict(part=part, tp=2)
        model = build_model(cfg, device="cpu", **kw)
        p = params if part is None else placed
        with torch.no_grad():
            state = model.init_decode_state(p, B, 12 + DECODE + 1)
            logits, state = model.prefill(p, state, toks)
            out_ = [logits]
            for _ in range(DECODE):
                nxt = (got[0][len(out_) - 1] if got else
                       logits).argmax(-1).to(torch.int32)
                logits, state = model.decode_step(p, state, nxt)
                out_.append(logits)
        got.append(torch.stack(out_))
    w = placed["layers"]
    for k in FSDP_LEAF[cfg.family]:
        w = w[k]
    report[f"serve {case}"] = [(got[1] - got[0]).abs().max().item(),
                               list(w.to_local().shape),
                               [str(p) for p in w.placements]]


def _worker(rank, port, out, cases):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    out = Path(out)
    report = {}
    try:
        for case in cases:
            if case in SERVE:
                _serve_case(report, out, case)
        if "fault" in cases:
            _fault_case(report, out)
            _collective_case(report)
        if "resume" in cases:
            _resume_case(report, out)
        train = [c for c in cases if c in CASES]
        if train:
            # the parent writes the reference's gradients meanwhile
            for _ in range(3000):
                if (out / "ref.npz").exists():
                    break
                time.sleep(0.1)
            ref = read_reference(out / "ref.npz")
            for case in train:
                _train_case(report, out, case, ref)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (out / f"report_{rank}.json").write_text(json.dumps(report))


def _main(out, cases):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, out, cases), nprocs=WORLD, join=True)
    reports = [json.loads(Path(out, f"report_{r}.json").read_text())
               for r in range(WORLD)]
    # {key: [rank 0's value, ..., rank 3's]}
    keys = sorted({k for r in reports for k in r})
    print(json.dumps({k: [r.get(k) for r in reports] for k in keys}))


# ----------------------------------------------------- the parent's part
def _jax_cfg(arch):
    from tests.conftest import reduced_config
    return reduced_config(arch)


def _perturbed(tree, rng):
    """The numpy params with every constant floating leaf moved by seeded
    0.3 N(0, 1) (``tests/test_torch_train.perturbed``)."""
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng) for k, v in sorted(tree.items())}
    a = np.asarray(tree)
    if a.dtype.kind == "f" and a.size and np.all(a == a.flat[0]):
        a = (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


def write_weights(out, archs):
    """Each arch's perturbed reference init, written for the ranks;
    returns {arch: numpy tree}."""
    import jax
    from repro.models.api import build_model as jax_build_model
    weights = {}
    for arch in archs:
        tree = _perturbed(jax.tree.map(np.asarray, jax.jit(jax_build_model(
            _jax_cfg(arch)).init)(
                # rpr: ignore[RPR001] -- another model's weights, from seed 0
                jax.random.PRNGKey(0))), np.random.default_rng(0))
        save_tree(out / f"weights {arch}.npz", tree)
        weights[arch] = load_tree(out / f"weights {arch}.npz")
    return weights


def write_reference(out, weights, cases):
    """The JAX package's loss and gradients on each case's first batch,
    one jitted ``value_and_grad`` an arch and dispatch; written whole, for
    ranks that wait for the file."""
    import jax
    import jax.numpy as jnp
    from repro.models.api import build_model as jax_build_model
    runs = {}
    for case in cases:
        key = ref_key(case)
        if key in runs:
            continue
        arch = CASES[case]["arch"]
        kw = dict(capacity_moe=True, capacity_factor=1.25) \
            if capacity(case) else {}
        fn = jax.jit(jax.value_and_grad(jax_build_model(
            _jax_cfg(arch), **kw).loss))
        runs[key] = fn(jax.tree.map(jnp.asarray, weights[arch]),
                       jax.tree.map(jnp.asarray,
                                    batches(port_cfg(arch), 1)[0]))
    np.savez(out / "ref_tmp.npz", **_host_arrays(runs))
    os.replace(out / "ref_tmp.npz", out / "ref.npz")


def _host_arrays(runs):
    """{"<key>|loss", "<key>|grads/<path>": numpy} of the reference's
    (loss, grads) runs."""
    import jax
    from repro_torch.tree import flatten
    arrays = {}
    for key, (loss, grads) in runs.items():
        arrays[f"{key}|loss"] = np.asarray(loss)
        for p, g in flatten(jax.tree.map(np.asarray, grads)).items():
            arrays[f"{key}|grads/" + "/".join(p)] = g
    return arrays


def read_reference(path):
    """{reference key: {"loss": float, "grads": nested dict}}."""
    out = {}
    with np.load(path) as z:
        for name in z.files:
            key, rest = name.split("|", 1)
            run = out.setdefault(key, {"grads": {}})
            if rest == "loss":
                run["loss"] = float(z[name])
                continue
            node = run["grads"]
            *head, last = rest.split("/")[1:]
            for k in head:
                node = node.setdefault(k, {})
            node[last] = z[name]
    return out


def start_ranks(tmp_path_factory, cases, timeout=240):
    """The ranks run ``cases`` (train cases, ``SERVE`` cases, "fault",
    "resume"; one subprocess, ``timeout`` s at most) while this process
    computes the JAX package's gradients.  Returns {report key: one value
    a rank}."""
    out = tmp_path_factory.mktemp("train_shard")
    archs = sorted({CASES[c]["arch"] for c in cases if c in CASES}
                   | {SERVE[c]["arch"] for c in cases if c in SERVE}
                   | ({"rwkv6-7b"} if "fault" in cases else set())
                   | ({"llama3-8b"} if "resume" in cases else set()))
    weights = write_weights(out, archs)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), str(REPO)]), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, str(out), *cases],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        write_reference(out, weights, [c for c in cases if c in CASES])
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2:])


# ------------------------------------------------ what the tests assert
# float32 bounds: the loss within LOSS_TOL of the unsharded port's and of
# the reference's; every gradient leaf within GRAD_TOL of its largest
# magnitude of the unsharded port's (zamba2: its SSD scans' backward
# reorders float32 sums over four layers of sixteen tokens, and most of
# its leaves land at 1.2e-5 to 2.8e-5 on (2, 2), so 5e-5) and within
# REF_GRAD_TOL of the reference's (the port's own parity bound across the
# frameworks, ``tests/test_torch_train.py``); three steps' losses and the
# params after them within LOSS_TOL and PARAM_TOL of the unsharded
# port's.
LOSS_TOL, REF_GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-5
GRAD_TOL = {None: 1e-5, "zamba2-2.7b": 5e-5}
WHAT = ("loss", "grads vs port", "grads vs reference", "steps", "laid out")


def check_case(runs, case, what):
    """The assertion ``what`` (of ``WHAT``) for train case ``case`` on
    every rank."""
    if what == "loss":
        gaps = runs[f"loss {case}"]
        assert len(gaps) == WORLD
        assert max(g[0] for g in gaps) <= LOSS_TOL, gaps
        assert max(g[1] for g in gaps) <= LOSS_TOL, gaps
    elif what == "grads vs port":
        gaps = runs[f"grads {case}"]
        tol = GRAD_TOL.get(CASES[case]["arch"], GRAD_TOL[None])
        assert len(gaps) == WORLD and max(g[0] for g in gaps) <= tol, gaps
    elif what == "grads vs reference":
        gaps = runs[f"grads {case}"]
        assert len(gaps) == WORLD
        assert max(g[2] for g in gaps) <= REF_GRAD_TOL, gaps
    elif what == "steps":
        gaps = runs[f"steps {case}"]
        assert len(gaps) == WORLD
        assert max(g[0] for g in gaps) <= LOSS_TOL, gaps
        assert max(g[1] for g in gaps) <= PARAM_TOL, gaps
    else:
        assert runs[f"laid out {case}"] == [True] * WORLD


# the serve cases' logits: within 1e-5 of the unsharded port's (zamba2
# 2e-5, its sharded decode's bound in tests/test_torch_ssm_shard_zamba2.py)
SERVE_TOL = {None: 1e-5, "zamba2-2.7b": 2e-5}


def check_serve(runs, case, what):
    """The assertion ``what`` for serve case ``case`` on every rank:
    "logits" — every step's logits within ``SERVE_TOL`` of the unsharded
    port's; "stored" — the rank's shard of a layer's matmul weight
    (``FSDP_LEAF``): under fsdp half of D (over "data") and half of its
    other axis (over "model"), the MoE's every expert row (this mesh has
    no "pod"); under zero3 a quarter of D (over "data" then "model") and
    the whole other axis."""
    from repro_torch.models.mamba2 import mamba_dims
    got = runs[f"serve {case}"]
    arch = SERVE[case]["arch"]
    if what == "logits":
        gaps = [g[0] for g in got]
        tol = SERVE_TOL.get(arch, SERVE_TOL[None])
        assert len(gaps) == WORLD and max(gaps) <= tol, gaps
        return
    cfg = port_cfg(arch)
    half = {"dense": cfg.d_ff, "moe": cfg.d_ff, "ssm": cfg.d_model}.get(
        cfg.family)
    lead = [cfg.n_layers]
    if cfg.family == "hybrid":
        d_in, nh, _, ns, _ = mamba_dims(cfg)
        half = 2 * d_in + 2 * ns + nh
        lead = [cfg.n_layers // cfg.shared_attn_every,
                cfg.shared_attn_every]
    if SERVE[case].get("layout") == "zero3":
        want = lead + [cfg.d_model // 4, half]
        placed = [f"S({len(lead)})"] * 2
    else:
        want = lead + [cfg.n_experts] * cfg.is_moe + [cfg.d_model // 2,
                                                      -(-half // 2)]
        placed = [f"S({len(want) - 2})", f"S({len(want) - 1})"]
    assert [g[1:] for g in got] == [[want, placed]] * WORLD, got
