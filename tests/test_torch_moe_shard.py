"""MoE expert parallelism over "pod" with sharded ring caches: each rank
holds its experts' rows (over "pod") with its d_ff slice (over "model"),
its heads' shard of the attention weights and of the KV cache — a ring
past the window, linear below it — and an expert migration moves only the
weight rows that change "pod" rank.

Four CPU ranks over gloo, spawned once in a subprocess (its own timeout);
the (4, 1, 1) mesh runs in ``tests/test_torch_moe_shard_pod4.py``, whose
ranks can run beside these on another worker.
The parent process writes the weights (the port's init at each mesh's tp,
with the router, the QKV biases and identity ``owner``/``share`` maps
seeded in both packages: the init's zero biases would hide a bias that
does not move with its head), starts the ranks, and while they run
computes what they are held to: the JAX package's lock-step and
cacheless logits (jitted once each) and the JAX package's and the
unsharded port engine's streams, migration logs and router loads.  The
model is a reduced mixtral in float32 (8 query heads of 8 over 2 KV
heads, 4 experts, window 8), on three meshes: ("pod", "data", "model")
(2, 1, 2) at tp 2, (4, 1, 1) at tp 1, and ("data", "model") (1, 4) at tp
4, where the experts are replicated and only d_ff is split.  Every rank
checks and reports:
- lock-step ``prefill`` (prompts of 12, which wrap the ring, and 6, a
  padded tail) and per-step ``decode_step`` logits over the ring, with
  and without the kernels' plain versions, against the unsharded port's
  and the JAX package's;
- the cacheless ``forward``'s logits and aux loss, dense and capacity
  dispatch, against the same two;
- ``WaveServingEngine(part=...)`` greedy streams over the ring (two waves
  of prompts of 12 and 6, 10 new tokens, λ 3, an expert straggler and a
  head straggler at step 4) and ``ServingEngine(part=...)`` below the
  window (window 128, ``max_seq`` 64) from linear and int8 caches,
  against the unsharded port engine's and the JAX package's engine's;
- its migration log (equal on every rank and to the unsharded engine's),
  the router loads the controller read at every interval (bit for bit the
  unsharded engine's), its local expert stacks (L, E/pod, D, F/tp) and
  cache shards (L, B/dp, T, KvE/tp, dh), written in place;
- the bytes it sent in each migration: the crossing KV rows times their
  bytes and the crossing expert rows times their d_ff slice's bytes
  (counted here from the applied permutations);
- the bytes one sharded MoE layer's collectives move: no more than its
  activations, far below one expert row's weights.

The worker imports no JAX.  The tests without ranks, at the end, hold the
per-rank expert partials to the whole block and the rules to the
reference's.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 1e-5
B, STEPS, T_MAX = 4, 4, 32          # lock-step logits over the ring
PROMPTS = (12, 6)                   # wraps the window of 8; a padded tail
FORWARD_S = 12
WAVE_PROMPTS = (12, 6, 12, 6, 12, 6, 12, 6)
WAVE = dict(n_slots=4, max_seq=32, lam=3, seed=0)
WAVE_NEW = 10
CONT_PROMPTS = (5, 11, 8, 14, 6)
CONT = dict(n_slots=4, max_seq=64, lam=3, seed=0)
STRAGGLE_AT = 4
BELOW_WINDOW = 128

# name -> (mesh shape, mesh dimension names, tp)
ALL_MESHES = {
    "pod 2 model 2": ((2, 1, 2), ("pod", "data", "model"), 2),
    "pod 4": ((4, 1, 1), ("pod", "data", "model"), 1),
    "data 1 model 4": ((1, 4), ("data", "model"), 4),
}
# the meshes this file's ranks run; tests/test_torch_moe_shard_pod4.py
# runs "pod 4" beside them, on another worker
MESHES = ("pod 2 model 2", "data 1 model 4")
# engine runs: kind -> (window, kv_quant, scheduler)
RUNS = {"wave ring": (8, False, "wave"),
        "linear": (BELOW_WINDOW, False, "continuous"),
        "int8": (BELOW_WINDOW, True, "continuous")}
LOG_KEYS = ("step", "n_migrations", "mig_bytes", "n_expert_migrations",
            "expert_mig_bytes", "applied", "reason", "expert_applied",
            "expert_reason")


def _weights_of(tp):
    """tp 1 and tp 2 lay 8 heads over 2 KV heads out alike (no padding,
    no repeat), so they share weights and expectations."""
    return "tp4" if tp == 4 else "tp1"


# weights key -> the tp its weights are drawn at
WEIGHT_TP = {"tp1": 1, "tp4": 4}


def _overrides(**over):
    return {**dict(n_layers=2, d_model=48, d_ff=96, vocab_size=96,
                   dtype="float32", param_dtype="float32", n_heads=8,
                   d_head=8, n_kv_heads=2, n_experts=4, sliding_window=8,
                   qkv_bias=True), **over}


def _cfg(**over):
    from repro_torch.configs import get_config
    return get_config("mixtral-8x7b").with_overrides(**_overrides(**over))


def _run_cfg(kind):
    window, kv, _ = RUNS[kind]
    return dict(sliding_window=window, kv_quant=kv)


def _tokens(S):
    return np.random.default_rng(S).integers(0, 96, (B, S)).astype(
        np.int32)


def _prompts(lengths):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 96, size=n) for n in lengths]


def _stragglers(eng):
    """A 500x straggler on the device holding the most expert blocks, and
    another on the device holding the most heads of the others (alone,
    the first moves only experts here)."""
    counts = np.zeros(eng.net.n_devices)
    for b in eng.controller.blocks:
        if b.kind == "expert":
            counts[int(eng.controller.place[b.index])] += 1
    dev = int(counts.argmax())
    heads = np.asarray(eng.controller.head_counts(), float)
    heads[dev] = -1
    for d in (dev, int(heads.argmax())):
        eng.net.inject_straggler(d, slowdown=500.0)


def _drive(eng, kind):
    """The run's traffic with the stragglers landing after decode step 4:
    the wave scheduler from its token hook, the continuous one between its
    steps.  Returns {rid: tokens}."""
    if RUNS[kind][2] == "wave":
        fired = []

        def sink(req, tok, done):
            if not fired and eng.decode_steps == STRAGGLE_AT:
                _stragglers(eng)
                fired.append(True)

        eng.token_sink = sink
        for p in _prompts(WAVE_PROMPTS):
            eng.submit(p, max_new_tokens=WAVE_NEW)
        eng.run()
    else:
        for i, p in enumerate(_prompts(CONT_PROMPTS)):
            eng.submit(p, max_new_tokens=8 + 2 * (i % 2))
        while True:
            if eng.decode_steps == STRAGGLE_AT:
                _stragglers(eng)
            if not eng.step():
                break
    return {str(r.rid): [int(t) for t in r.out_tokens] for r in eng.finished}


def _log(eng):
    return [[e[k] for k in LOG_KEYS] for e in eng.migration_log]


def _watch_loads(eng):
    """The whole router loads the controller reads at every interval, as
    float32 values (exact in JSON)."""
    from repro_torch.models.partitioning import whole
    seen, inner = [], eng._feed_expert_loads

    def feed(states):
        seen.append([whole(st["expert_load"]).tolist() for st in states])
        return inner(states)

    eng._feed_expert_loads = feed
    return seen


def _engine(kind, tp, **kw):
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import ServingEngine, WaveServingEngine
    cls = WaveServingEngine if RUNS[kind][2] == "wave" else ServingEngine
    base = WAVE if RUNS[kind][2] == "wave" else CONT
    return cls(_cfg(**_run_cfg(kind)), use_kernel=True, device="cpu",
               net=DeviceNetwork.sample(4, seed=1), tp=tp, **base, **kw)


def _save_tree(path, tree):
    from repro_torch.tree import flatten
    np.savez(path, **{"/".join(p): np.asarray(v)
                      for p, v in flatten(tree).items()})


def _load_tree(path):
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
def _placed(params, cfg, mesh):
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.models.partitioning import place
    from repro_torch.tree import flatten, map_with_path
    sh = flatten(param_shardings(params, cfg, mesh))
    return map_with_path(lambda p, v: place(v.clone(), sh[p]), params)


def _coord(mesh, name):
    """This rank's coordinate and the size of mesh dimension ``name``
    (0 and 1 where the mesh has none)."""
    names = tuple(mesh.mesh_dim_names)
    if name not in names:
        return 0, 1
    m = names.index(name)
    return mesh.get_coordinate()[m], mesh.size(m)


def _crossing(src, coord, ranks):
    """Rows of this rank's chunk that a permutation ``src`` (…, n) — the
    source row of each destination — lands in another rank's chunk."""
    n = src.shape[-1] // ranks
    dst_rank = np.arange(src.shape[-1]) // n
    return int(((src // n == coord) & (dst_rank != coord)).sum())


def _lockstep(model, params, tokens, first):
    """Lock-step prefill then STEPS decode steps fed ``first``'s greedy
    tokens; the logits of every call, stacked, and the state."""
    state = model.init_decode_state(params, B, T_MAX)
    out, state = model.prefill(params, state, tokens)
    logits = [out]
    for s in range(STEPS):
        nxt = torch.from_numpy(first[s].argmax(-1).astype(np.int32))
        out, state = model.decode_step(params, state, nxt)
        logits.append(out)
    return torch.stack(logits), state


def _check_logits(report, name, mesh, params, placed, ref):
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import local, make_partitioner
    tp = ALL_MESHES[name][2]
    cfg = _cfg()
    for S in PROMPTS:
        want = ref[f"{_weights_of(tp)} lockstep {S}"]
        tokens = torch.from_numpy(_tokens(S))
        for uk in (False, True):
            plain, _ = _lockstep(build_model(cfg, tp=tp, use_kernel=uk,
                                             device="cpu"),
                                 params, tokens, want)
            got, state = _lockstep(
                build_model(cfg, tp=tp, use_kernel=uk, device="cpu",
                            part=make_partitioner(mesh)),
                placed, tokens, want)
            label = f"{name} S={S} kernel={uk}"
            report[f"logits {label} vs port"] = \
                (got - plain).abs().max().item()
            report[f"logits {label} vs reference"] = \
                (got - torch.from_numpy(want)).abs().max().item()
            report[f"ring shard {label}"] = list(
                local(state["cache"]["k"]).shape)
            report[f"ring pos {label}"] = bool(torch.equal(
                local(state["cache"]["pos"]), state["cache"]["pos"]
                .full_tensor()))


def _check_forward(report, name, mesh, params, placed, ref):
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner, whole
    tp = ALL_MESHES[name][2]
    tokens = torch.from_numpy(_tokens(FORWARD_S))
    for cap in (False, True):
        kw = dict(tp=tp, device="cpu", capacity_moe=cap)
        plain, aux = build_model(_cfg(), **kw).forward(params, tokens)
        got, got_aux = build_model(_cfg(), part=make_partitioner(mesh),
                                   **kw).forward(placed, tokens)
        got = whole(got)
        label = f"{name} capacity={cap}"
        key = f"{_weights_of(tp)} forward capacity={cap}"
        report[f"forward {label} vs port"] = [
            (got - plain).abs().max().item(),
            abs(got_aux.item() - aux.item())]
        report[f"forward {label} vs reference"] = [
            (got - torch.from_numpy(ref[key])).abs().max().item(),
            abs(got_aux.item() - float(ref[key + " aux"]))]


def _check_layer(report, name, mesh, params, placed):
    """One MoE layer (dense and capacity dispatch) on a one-token-a-row
    batch, sharded, against the unsharded block, with the bytes its
    collectives move on this rank counted from each call's tensors."""
    import torch.distributed as dist
    from repro_torch.models import moe
    from repro_torch.models.partitioning import local, make_partitioner
    part = make_partitioner(mesh)
    cfg = _cfg()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    h = part.shard(x, ("batch", "seq", "d_model"))
    p_whole = {k: v[0] for k, v in params["layers"]["moe"].items()}
    p_mesh = {k: v[0] for k, v in placed["layers"]["moe"].items()}
    moved = []
    spied = {"all_gather": lambda out, t, **k: t,
             "reduce_scatter": lambda out, parts, **k: torch.cat(parts),
             "all_reduce": lambda t, **k: t}
    inner = {n: getattr(dist, n) for n in spied}

    def spy(n):
        def call(*a, **k):
            t = spied[n](*a, **k)
            moved.append(t.numel() * t.element_size())
            return inner[n](*a, **k)
        return call

    for label, run in (("dense", moe.moe_block),
                       ("capacity", moe.moe_block_capacity)):
        want = run(cfg, p_whole, x)
        moved.clear()
        for n in spied:
            setattr(dist, n, spy(n))
        try:
            got = run(cfg, p_mesh, h, part=part)
        finally:
            for n in spied:
                setattr(dist, n, inner[n])
        report[f"layer {name} {label}"] = [
            (got[0].full_tensor() - want[0]).abs().max().item(),
            abs(got[1].item() - want[1].item()),
            bool(torch.equal(got[2], want[2])), sum(moved),
            len(moved)]
    report[f"expert stack {name}"] = list(
        local(placed["layers"]["moe"]["w_gate"]).shape)


def _check_engine(report, name, kind, mesh, placed):
    from repro_torch.core.placement_bridge import (expand_kv_perms,
                                                   kv_group_perms,
                                                   relative_perms)
    from repro_torch.models.partitioning import local, make_partitioner
    tp = ALL_MESHES[name][2]
    cfg = _cfg(**_run_cfg(kind))
    eng = _engine(kind, tp, part=make_partitioner(mesh), params=placed)
    hd = eng.model.hd
    run = f"{name} {kind}"
    mc, mranks = _coord(mesh, "model")
    pc, pranks = _coord(mesh, "pod")
    moe_p = eng.params["layers"]["moe"]
    report[f"engine expert stack {run}"] = list(local(moe_p["w_gate"]).shape)
    # one crossing expert row's bytes on this rank: its d_ff slice of the
    # three stacks
    row_w = sum(local(moe_p[n])[0, 0].numel() * local(moe_p[n]).element_size()
                for n in ("w_gate", "w_up", "w_down"))
    want = {}
    migrate_state, migrate_experts = eng._migrate_state, eng._migrate_experts

    def entry():
        return want.setdefault(eng.decode_steps, [eng.decode_steps, 0, 0,
                                                  0, 0])

    def on_heads(state, plan, *a, **kw):
        applied, reason = migrate_state(state, plan, *a, **kw)
        if applied:
            cache = state["cache"]
            bufs = [n for n in cache if n != "pos"]
            row_kv = sum(local(cache[n])[0].select(
                -2 if n in ("k", "v") else -1, 0).numel()
                * local(cache[n]).element_size() for n in bufs)
            rel = relative_perms(plan["prev_perms"], plan["perms"])
            rel = np.broadcast_to(rel, (cfg.n_layers, rel.shape[1]))
            kv = expand_kv_perms(kv_group_perms(rel, hd.Hp // hd.Kp), hd.rep)
            rows = _crossing(kv, mc, mranks)
            e = entry()
            e[1] += rows * len(bufs)
            e[2] += rows * row_kv
        return applied, reason

    def on_experts(plan):
        applied, reason = migrate_experts(plan)
        if applied:
            rel = relative_perms(plan["prev_expert_perms"],
                                 plan["expert_perms"])
            rel = np.broadcast_to(rel, (cfg.n_layers, rel.shape[1]))
            rows = _crossing(rel, pc, pranks)
            e = entry()
            e[3] += 3 * rows
            e[4] += rows * row_w
        return applied, reason

    eng._migrate_state, eng._migrate_experts = on_heads, on_experts
    ptrs, shards, waves = [], set(), [0]
    step, prefill = eng.model.decode_step, eng.model.prefill

    def decode_step(params, state, tokens):
        before = [local(t).data_ptr() for t in state["cache"].values()]
        out, state = step(params, state, tokens)
        # a wave's state is new: its steps are compared among themselves
        ptrs.append(((waves[0], len(eng.exchange_log)), before,
                     [local(t).data_ptr() for t in state["cache"].values()]))
        shards.add(tuple(local(state["cache"]["k"]).shape))
        return out, state

    def wave_prefill(*a):
        waves[0] += 1
        return prefill(*a)

    eng.model.decode_step, eng.model.prefill = decode_step, wave_prefill
    loads = _watch_loads(eng)
    report[f"streams {run}"] = _drive(eng, kind)
    report[f"log {run}"] = _log(eng)
    report[f"loads {run}"] = loads
    report[f"sent {run}"] = [[e["step"], e["kv_rows"], e["kv_bytes"],
                              e["expert_rows"], e["expert_bytes"]]
                             for e in eng.exchange_log]
    report[f"expected sent {run}"] = [want[s] for s in sorted(want)]
    report[f"cache shard {run}"] = sorted(list(s) for s in shards)
    report[f"waves {run}"] = waves[0]
    # decode steps of a wave between the same two migrations see the same
    # storage
    report[f"moved storage {run}"] = sum(
        len({tuple(a[1]), tuple(a[2]), tuple(b[1]), tuple(b[2])}) > 1
        for a, b in zip(ptrs, ptrs[1:]) if a[0] == b[0])
    report[f"decode steps {run}"] = len(ptrs)


def _worker(rank, port, out, names):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.weights import params_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    out = Path(out)
    report = {}
    try:
        cases = {}
        for name in names:
            shape, dims, tp = ALL_MESHES[name]
            mesh = make_mesh(shape, dims, device_type="cpu")
            params = params_from_jax(
                _load_tree(out / f"{_weights_of(tp)}.npz"), "cpu")
            cases[name] = (mesh, params, _placed(params, _cfg(), mesh))
        for name, (mesh, params, placed) in cases.items():
            _check_layer(report, name, mesh, params, placed)
            for kind in RUNS:
                _check_engine(report, name, kind, mesh,
                              _placed(params, _cfg(), mesh))
        # the parent writes the reference's logits while the engines run
        for _ in range(2400):
            if (out / "ref.npz").exists():
                break
            time.sleep(0.1)
        ref = dict(np.load(out / "ref.npz"))
        for name, (mesh, params, placed) in cases.items():
            _check_logits(report, name, mesh, params, placed, ref)
            _check_forward(report, name, mesh, params, placed, ref)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (out / f"report_{rank}.json").write_text(json.dumps(report))


def _main(out, names):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, out, names), nprocs=WORLD, join=True)
    reports = [json.loads(Path(out, f"report_{r}.json").read_text())
               for r in range(WORLD)]
    # {key: [rank 0's value, ..., rank 3's]}
    keys = sorted({k for r in reports for k in r})
    print(json.dumps({k: [r.get(k) for r in reports] for k in keys}))


# ----------------------------------------------------- the parent's part
def _write_weights(out):
    """The weights of tp 1 (and 2) and tp 4 — the port's init from seed
    0, the router redrawn and the QKV biases seeded on the real heads
    (padded rows stay zero), identity expert maps — written for the ranks
    and returned as numpy trees."""
    from repro_torch.models.api import build_model
    from repro_torch.models.moe import expert_identity
    weights = {}
    for tp in WEIGHT_TP.values():
        rng = np.random.default_rng(7)
        cfg = _cfg()
        params = build_model(cfg, tp=tp, device="cpu").init(
            # rpr: ignore[RPR001] -- another model's weights, from seed 0
            torch.Generator().manual_seed(0))
        attn, moe_p = params["layers"]["attn"], params["layers"]["moe"]
        for n, real in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            b = torch.zeros_like(attn[n])
            b[..., :real, :] = torch.from_numpy(0.5 * rng.standard_normal(
                tuple(b[..., :real, :].shape))).float()
            attn[n] = b
        moe_p["router"] = torch.from_numpy(rng.standard_normal(
            tuple(moe_p["router"].shape)).astype(np.float32)
            / np.sqrt(cfg.d_model))
        moe_p["owner"], moe_p["share"] = expert_identity(cfg.n_experts,
                                                         cfg.n_layers)
        _save_tree(out / f"{_weights_of(tp)}.npz", params)
        weights[_weights_of(tp)] = _load_tree(out / f"{_weights_of(tp)}.npz")
    return weights


def _jax_cfg(**over):
    from repro.configs import get_config as jax_get_config
    return jax_get_config("mixtral-8x7b").with_overrides(**_overrides(**over))


def _compiled(model):
    """The reference's lock-step prefill, decode step and cacheless
    forward, each compiled once (the state donated, as the reference
    engine does)."""
    import jax
    return (jax.jit(model.prefill, donate_argnums=(1,)),
            jax.jit(model.decode_step, donate_argnums=(1,)),
            jax.jit(model.forward))


def _weight_sets(names):
    """(weights key, its tp) of the meshes ``names``."""
    keys = {_weights_of(ALL_MESHES[n][2]) for n in names}
    return [(k, WEIGHT_TP[k]) for k in sorted(keys)]


def _write_reference_logits(out, weights, names):
    """The JAX package's lock-step logits over the ring for each prompt
    length and its cacheless logits and aux loss, dense and capacity
    dispatch, on the weights of the meshes ``names``; written whole, for
    ranks that wait for the file."""
    import jax
    import jax.numpy as jnp
    from repro.models.api import build_model as jax_build_model
    ref = {}
    for key, tp in _weight_sets(names):
        pj = jax.tree.map(jnp.asarray, weights[key])
        model = jax_build_model(_jax_cfg(), tp=tp)
        prefill, step, forward = _compiled(model)
        for S in PROMPTS:
            state = model.init_decode_state(pj, B, T_MAX)
            got, state = prefill(pj, state, jnp.asarray(_tokens(S)))
            got = [np.asarray(got)]
            for _ in range(STEPS):
                nxt, state = step(pj, state, jnp.asarray(
                    got[-1].argmax(-1).astype(np.int32)))
                got.append(np.asarray(nxt))
            ref[f"{key} lockstep {S}"] = np.stack(got)
        for cap in (False, True):
            fwd = _compiled(jax_build_model(_jax_cfg(), tp=tp,
                                            capacity_moe=cap))[2] \
                if cap else forward
            logits, aux = fwd(pj, jnp.asarray(_tokens(FORWARD_S)))
            ref[f"{key} forward capacity={cap}"] = np.asarray(logits)
            ref[f"{key} forward capacity={cap} aux"] = np.asarray(aux)
    np.savez(out / "ref_tmp.npz", **ref)
    os.replace(out / "ref_tmp.npz", out / "ref.npz")


def _engine_expectations(weights, names):
    """The JAX package's engine and the unsharded port engine on the
    weights of the meshes ``names`` and each run's traffic: streams,
    migration logs and (the port's) router loads."""
    import jax
    import jax.numpy as jnp
    from repro.core.network import DeviceNetwork as JaxNetwork
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro.serving.engine import WaveServingEngine as JaxWave
    from repro_torch.weights import params_from_jax

    expect = {}
    for key, tp in _weight_sets(names):
        for kind in RUNS:
            wave = RUNS[kind][2] == "wave"
            ref = (JaxWave if wave else JaxEngine)(
                _jax_cfg(**_run_cfg(kind)), net=JaxNetwork.sample(4, seed=1),
                tp=tp, **(WAVE if wave else CONT))
            ref.params = jax.tree.map(jnp.asarray, weights[key])
            port = _engine(kind, tp, params=params_from_jax(weights[key],
                                                             "cpu"))
            loads = _watch_loads(port)
            expect[f"{key} {kind}"] = {
                "reference": _drive(ref, kind), "port": _drive(port, kind),
                "reference log": _log(ref), "port log": _log(port),
                "port loads": loads}
    return expect


def start_ranks(tmp_path_factory, names):
    """The ranks run the meshes ``names`` (one subprocess, 240 s at most)
    while this process computes the reference's logits and serves the
    same traffic on the reference and unsharded engines.  Returns (the
    expectations, {report key: one value a rank})."""
    out = tmp_path_factory.mktemp("moe_shard")
    weights = _write_weights(out)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), str(REPO)]), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, str(out), *names],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        _write_reference_logits(out, weights, names)
        expect = _engine_expectations(weights, names)
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    return expect, json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_ranks(tmp_path_factory, MESHES)


def _expect(runs, name, kind):
    return runs[0][f"{_weights_of(ALL_MESHES[name][2])} {kind}"]


def logit_cases(meshes):
    return [(m, S, uk, against) for m in meshes for S in PROMPTS
            for uk in (False, True) for against in ("port", "reference")]


@pytest.mark.parametrize("mesh,S,uk,against", logit_cases(MESHES))
def test_sharded_ring_logits_equal_unsharded(runs, mesh, S, uk, against):
    """Every rank's whole lock-step prefill and per-step decode logits
    over the ring against the unsharded port's and the JAX package's on
    the same weights; the ring's slot positions are the same on every
    rank (replicated)."""
    label = f"{mesh} S={S} kernel={uk}"
    gaps = runs[1][f"logits {label} vs {against}"]
    assert len(gaps) == WORLD and max(gaps) <= TOL, gaps
    assert runs[1][f"ring pos {label}"] == [True] * WORLD


@pytest.mark.parametrize("mesh", MESHES)
def test_lockstep_ring_shard_shape(runs, mesh):
    """Each rank's ring shard is (L, B/dp, window, KvE/tp, dh)."""
    from repro_torch.models.layers import head_dims
    shape, names, tp = ALL_MESHES[mesh]
    cfg = _cfg()
    hd = head_dims(cfg, tp)
    dp = int(np.prod(shape[:-1]))
    want = [cfg.n_layers, B // dp, cfg.sliding_window, hd.KvE // shape[-1],
            hd.dh]
    for S in PROMPTS:
        for uk in (False, True):
            assert runs[1][f"ring shard {mesh} S={S} kernel={uk}"] == \
                [want] * WORLD


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("capacity", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_forward_equals_unsharded(runs, mesh, capacity, against):
    """The cacheless forward's logits (whole) and aux loss on every rank,
    dense and capacity dispatch."""
    gaps = runs[1][f"forward {mesh} capacity={capacity} vs {against}"]
    assert len(gaps) == WORLD
    assert max(g[0] for g in gaps) <= TOL, gaps
    assert max(g[1] for g in gaps) <= TOL, gaps


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("kind", list(RUNS))
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_engine_streams_equal_unsharded(runs, mesh, kind, against):
    want = _expect(runs, mesh, kind)[against]
    n = len(WAVE_PROMPTS if RUNS[kind][2] == "wave" else CONT_PROMPTS)
    assert len(want) == n
    assert runs[1][f"streams {mesh} {kind}"] == [want] * WORLD


@pytest.mark.parametrize("kind", list(RUNS))
@pytest.mark.parametrize("mesh", MESHES)
def test_migration_logs_and_loads_equal_on_every_rank(runs, mesh, kind):
    """Every rank runs the same scheduler and controller: its log equals
    the others' and the unsharded port engine's, head and expert
    migrations were applied, and the router loads the controller read at
    every interval equal the unsharded engine's bit for bit."""
    run = f"{mesh} {kind}"
    want = _expect(runs, mesh, kind)
    logs = runs[1][f"log {run}"]
    assert logs == [want["port log"]] * WORLD
    assert any(e[5] and e[1] for e in logs[0]), "no head migration applied"
    assert any(e[7] and e[3] for e in logs[0]), \
        "no expert migration applied"
    assert runs[1][f"loads {run}"] == [want["port loads"]] * WORLD
    assert len(want["port loads"]) > 2


@pytest.mark.parametrize("kind", list(RUNS))
@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_shards_written_in_place(runs, mesh, kind):
    """The local expert stacks are (L, E/pod, D, F/tp); the cache shard is
    (L, B/dp, T, KvE/tp, dh) — the ring's T its window — and decode steps
    between two migrations write it in place."""
    from repro_torch.models.layers import head_dims
    shape, names, tp = ALL_MESHES[mesh]
    cfg = _cfg(**_run_cfg(kind))
    hd = head_dims(cfg, tp)
    pod = shape[0] if "pod" in names else 1
    dp = int(np.prod(shape[:-1]))
    run = f"{mesh} {kind}"
    assert runs[1][f"engine expert stack {run}"] == [[
        cfg.n_layers, cfg.n_experts // pod, cfg.d_model,
        cfg.d_ff // shape[-1]]] * WORLD
    wave = RUNS[kind][2] == "wave"
    T = cfg.sliding_window if wave else CONT["max_seq"]
    assert runs[1][f"cache shard {run}"] == [[[
        cfg.n_layers, WAVE["n_slots"] // dp, T, hd.KvE // shape[-1],
        hd.dh]]] * WORLD
    assert min(runs[1][f"decode steps {run}"]) > 10
    assert runs[1][f"moved storage {run}"] == [0] * WORLD
    assert runs[1][f"waves {run}"] == [2 if wave else 0] * WORLD


@pytest.mark.parametrize("kind", list(RUNS))
@pytest.mark.parametrize("mesh", MESHES)
def test_migrations_send_only_the_rows_that_change_rank(runs, mesh, kind):
    """Per migration step, each rank's sent KV rows and bytes equal the KV
    rows of its chunk that the applied head permutation lands in another
    "model" rank's chunk times a row's bytes, and its sent expert rows
    and bytes the expert rows of its chunk that the applied expert
    permutation lands in another "pod" rank's chunk times their d_ff
    slice's bytes in the three stacks.  On a "pod" mesh some expert row
    crosses."""
    run = f"{mesh} {kind}"
    sent = runs[1][f"sent {run}"]
    assert sent == runs[1][f"expected sent {run}"]
    if "pod" in ALL_MESHES[mesh][1]:
        assert sum(e[3] for per_rank in sent for e in per_rank) > 0
    else:
        assert all(e[3] == 0 for per_rank in sent for e in per_rank)
    if ALL_MESHES[mesh][0][-1] > 1:
        assert sum(e[1] for per_rank in sent for e in per_rank) > 0


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
@pytest.mark.parametrize("mesh", MESHES)
def test_a_sharded_layer_moves_activations_not_weights(runs, mesh,
                                                       dispatch):
    """One MoE layer on a (4, 1, 48) batch: the sharded output within
    1e-6 of the whole block's (aux too, the routed fraction bit-equal),
    and the tensors its collectives carry on each rank (gathered tokens
    and gates, partial outputs, the routing sums) no more than four times
    the layer's activations — below a tenth of one expert row's weights,
    which never travel."""
    cfg = _cfg()
    gaps = runs[1][f"layer {mesh} {dispatch}"]
    act = B * 1 * cfg.d_model * 4
    row = 3 * cfg.d_model * cfg.d_ff * 4
    for gap, aux_gap, same_freq, moved, calls in gaps:
        assert gap <= 1e-6 and aux_gap <= 1e-6 and same_freq
        assert moved <= 4 * act < row / 10, (moved, act, row)
        assert calls > 0
    shape, names, _ = ALL_MESHES[mesh]
    pod = shape[0] if "pod" in names else 1
    assert runs[1][f"expert stack {mesh}"] == [[
        cfg.n_layers, cfg.n_experts // pod, cfg.d_model,
        cfg.d_ff // shape[-1]]] * WORLD


# ------------------------------------------------- without ranks (CPU)
def _block_case(seed=3):
    """A reduced mixtral layer's expert params with a non-identity
    physical layout (rows permuted, owner/share following) and a batch."""
    from repro_torch.models.api import build_model
    from repro_torch.models.moe import expert_identity
    cfg = _cfg(n_layers=1)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    perm = torch.tensor([2, 0, 3, 1])
    for n in ("w_gate", "w_up", "w_down"):
        p[n] = p[n][perm]
    owner, share = expert_identity(cfg.n_experts)
    p["owner"], p["share"] = owner[perm], share[perm]
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (3, 8, cfg.d_model)).astype(np.float32))
    return cfg, p, x


@pytest.mark.parametrize("maps", ["permuted", "none"])
@pytest.mark.parametrize("ff_split", [1, 2])
@pytest.mark.parametrize("expert_split", [2, 4])
@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_per_rank_expert_partials_sum_to_the_whole_block(
        dispatch, expert_split, ff_split, maps):
    """Each rank's partial of a MoE layer — its expert rows (with their
    slice of the owner/share maps, or of the gates without maps) and its
    d_ff slice, over every token — summed over the ranks equals the whole
    block within 1e-6; the aux loss and routed fraction are the whole
    block's on every rank."""
    from repro_torch.models import moe
    from repro_torch.models.partitioning import ExpertShard
    cfg, p, x = _block_case()
    if maps == "none":
        p = {k: v for k, v in p.items() if k not in ("owner", "share")}
    block = moe._dense_dispatch if dispatch == "dense" \
        else moe._capacity_dispatch
    want = block(cfg, p, x, ExpertShard(0, cfg.n_experts))
    n, f = cfg.n_experts // expert_split, cfg.d_ff // ff_split
    total = torch.zeros_like(want[0])
    for e in range(expert_split):
        for j in range(ff_split):
            rows, cols = slice(e * n, (e + 1) * n), slice(j * f, (j + 1) * f)
            loc = dict(p, w_gate=p["w_gate"][rows, :, cols],
                       w_up=p["w_up"][rows, :, cols],
                       w_down=p["w_down"][rows, cols])
            if maps == "permuted":
                loc.update(owner=p["owner"][rows], share=p["share"][rows])
            out, aux, freq = block(cfg, loc, x, ExpertShard(e * n, n))
            assert torch.equal(aux, want[1]) and torch.equal(freq, want[2])
            total += out
    torch.testing.assert_close(total, want[0], atol=1e-6, rtol=0)


def test_ring_state_shardings_equal_reference_on_a_pod_mesh():
    """The ring decode state (k, v, their slot positions, the lock-step
    position, the router loads) of mixtral on a ("pod", "data", "model")
    mesh: every leaf's placement is the reference's — k/v batch over
    ("pod", "data") and heads over "model", "pos" replicated, the loads'
    layer axis over the data axes."""
    import jax
    from repro.core import placement_bridge as jbridge
    from repro.models.api import build_model as jax_build_model
    from repro_torch.core import placement_bridge as bridge
    from repro_torch.models import partitioning as part
    from repro_torch.models.api import build_model
    from repro_torch.tree import flatten
    from tests.test_torch_sharding import StandInMesh
    names = ("pod", "data", "model")
    mj = jax_build_model(_jax_cfg())
    pj = jax.eval_shape(mj.init, jax.random.PRNGKey(0))
    ref_state = jax.eval_shape(lambda p: mj.init_decode_state(p, 4, T_MAX),
                               pj)
    port_state = build_model(_cfg(), device="cpu").init_decode_state(
        None, 4, T_MAX)
    want = jbridge.decode_state_shardings(
        ref_state, None, jax.make_mesh((1, 1, 1), names))
    got = flatten(bridge.decode_state_shardings(
        port_state, None, StandInMesh((2, 2, 2), names)))
    paths = {tuple(jbridge._path_names(p)): tuple(sh.spec)
             for p, sh in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(paths) - {("pos",)} == set(got) - {("pos",)}
    assert ("cache", "pos") in paths
    for path, spec in paths.items():
        if path in got:
            assert got[path].placements == part.placements(
                StandInMesh((2, 2, 2), names), spec), path


def test_a_pod_degree_that_does_not_split_the_experts_is_refused():
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner
    from tests.test_torch_sharding import StandInMesh
    part = make_partitioner(StandInMesh((3, 1, 1), ("pod", "data", "model")))
    with pytest.raises(ValueError, match="pod"):
        build_model(_cfg(), part=part, device="cpu")
    build_model(_cfg(n_experts=6), part=part, device="cpu")


def test_paged_moe_engine_on_a_mesh_is_refused():
    """The MoE family serves paged on a mesh (a pool for each batch rank,
    ``tests/test_torch_paged_shard.py`` over "pod"): a pool that does not
    split over the batch ranks ("pod" x "data") is the one refusal left,
    raised before any weight is placed.  On a one-rank gloo mesh the paged
    MoE engine (mixtral without its window: both packages keep windowed
    archs off paged caches, and below the window the function is the
    same) is the continuous engine, its experts DTensors, and streams the
    unsharded paged engine's tokens on the same weights."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.partitioning import is_dtensor, make_partitioner
    from repro_torch.serving.engine import ServingEngine, make_engine
    from tests.test_torch_shard_serve import _local_tree
    from tests.test_torch_sharding import StandInMesh
    cfg = _cfg(sliding_window=0)
    kw = dict(paged=True, page_size=8, tp=4, device="cpu", use_kernel=True,
              **CONT)
    part = make_partitioner(StandInMesh((2, 1, 2), ("pod", "data", "model")))
    with pytest.raises(ValueError, match="kv_pages=9 "):
        ServingEngine(cfg, part=part, kv_pages=9, **kw)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"),
                         device_type="cpu")
        eng = make_engine(cfg, part=make_partitioner(mesh), **kw)
        assert type(eng) is ServingEngine
        assert is_dtensor(eng.params["layers"]["moe"]["w_gate"])
        plain = ServingEngine(cfg, params=_local_tree(eng.params), **kw)
        for e in (eng, plain):
            for p in _prompts(CONT_PROMPTS[:3]):
                e.submit(p, max_new_tokens=6)
            e.run()
        streams = [{r.rid: r.out_tokens for r in e.finished}
                   for e in (eng, plain)]
        assert len(streams[0]) == 3 and streams[0] == streams[1]
        assert len(eng.allocators) == 1 and eng.allocator.live_pages == 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2:])
