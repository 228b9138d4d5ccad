"""Sharded decode and serving of the dense family on a DeviceMesh: each
rank holds its shard of the weights and its heads' shard of the KV cache,
and a head migration moves only the rows that change rank.

Four CPU ranks over gloo, spawned once in a subprocess (its own timeout).
The parent process writes each case's weights (the port's init, QKV
biases seeded nonzero on the real heads: the init's zero biases would hide
a bias that does not move with its head), starts the ranks, and while
they run computes what they are held to: the JAX package's lock-step
logits (jitted once per case) and the JAX package's and the unsharded
port engine's streams and migration logs.  On a (2, 2) ("data", "model")
mesh (llama3 reduced, tp 2) and a (1, 4) one (the same llama at tp 4,
each KV head replicated twice; qwen1.5 reduced to 6 heads padded to 8),
every rank checks and reports:
- lock-step ``prefill`` and per-step ``decode_step`` logits of the sharded
  model from a linear cache, with and without the kernels' plain
  versions, and from an int8 one with them, against the unsharded port's
  (and, linear, the JAX package's);
- ``ServingEngine(part=...)`` greedy streams, with a 500x straggler at
  step 4 so that migrations move KV rows between ranks, against the
  unsharded port engine's and the JAX package's engine's (linear and
  int8 caches on both meshes, paged and int8-paged on (1, 4));
- its migration log (equal on every rank and to the unsharded engine's);
- its local cache shard of shape (L, B/dp, T, KvE/tp, dh), written in
  place (the same ``data_ptr`` across every decode step between two
  migrations);
- the bytes it sent in each migration: the KV rows that change rank, and
  that it held, times their row bytes (counted here from the applied
  permutations, independently of the exchange);
- ``apply_layer_head_perms`` and ``permute_model_heads_layers`` on
  sharded tensors: each rank's shard equals its chunk of the unsharded
  permutation, bit for bit.

The models run in float32.  The worker imports no JAX.  The tests without
ranks, at the end, hold the rank-local kernel row maps to the whole call
and check the refusals.
"""
import dataclasses
import json
import math
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
B, PROMPT, STEPS = 4, 8, 3          # lock-step logits
T_MAX = 16
PROMPT_LENS = (5, 11, 8, 14, 6)     # engine traffic
STRAGGLE_AT = 4
ENGINE = dict(n_slots=4, max_seq=64, lam=3, seed=0)
PAGE = 8

# name -> (arch, overrides, (data, model) mesh, tp)
CASES = {
    "llama (2, 2)": ("llama3-8b", dict(n_heads=8, d_head=8, n_kv_heads=2,
                                       qkv_bias=True), (2, 2), 2),
    "llama rep 2 (1, 4)": ("llama3-8b", dict(n_heads=8, d_head=8,
                                             n_kv_heads=2, qkv_bias=True),
                           (1, 4), 4),
    "qwen padded (1, 4)": ("qwen1.5-32b", dict(n_heads=6, d_head=8,
                                               n_kv_heads=6), (1, 4), 4),
}
# engine runs: (case, cache kind); paged stores need "data" 1
KINDS = {"linear": {}, "int8": dict(kv_quant=True),
         "paged": dict(paged=True), "int8 paged": dict(kv_quant=True,
                                                        paged=True)}
RUNS = [("llama (2, 2)", "linear"), ("llama (2, 2)", "int8"),
        ("llama rep 2 (1, 4)", "linear"), ("llama rep 2 (1, 4)", "int8"),
        ("llama rep 2 (1, 4)", "paged"), ("llama rep 2 (1, 4)", "int8 paged"),
        ("qwen padded (1, 4)", "linear")]
LOG_KEYS = ("step", "n_migrations", "mig_bytes", "applied", "reason")
# lock-step logit runs (kv_quant, use_kernel): the int8 cache through the
# kernels' plain versions, held to the unsharded port only (the port's
# int8 path is held to the reference by the paging and quantization
# tests)
LOGIT_RUNS = [(False, False), (False, True), (True, True)]


def _run_id(case, kind):
    return f"{case} {kind}"


def _cfg(case, **over):
    """The port's config of a case (the reference's is built from the
    same overrides)."""
    from repro_torch.configs import get_config
    arch, o, _, _ = CASES[case]
    return get_config(arch).with_overrides(**_overrides(arch, o, over))


def _overrides(arch, o, over):
    base = dict(n_layers=2, d_model=48, d_ff=96, vocab_size=96,
                dtype="float32", param_dtype="float32")
    return {**base, **o, **over}


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 96, size=n) for n in PROMPT_LENS]


def _tokens():
    return np.random.default_rng(1).integers(0, 96, (B, PROMPT)).astype(
        np.int32)


def _drive(eng):
    """Every request submitted, then scheduler steps to the end with a
    500x straggler landing at step 4 on the device holding most heads."""
    for i, p in enumerate(_prompts()):
        eng.submit(p, max_new_tokens=7 + 2 * (i % 2))
    while True:
        if eng.decode_steps == STRAGGLE_AT:
            dev = int(eng.controller.head_counts().argmax())
            eng.net.inject_straggler(dev, slowdown=500.0)
        if not eng.step():
            break
    return {str(r.rid): [int(t) for t in r.out_tokens] for r in eng.finished}


def _log(eng):
    return [[e[k] for k in LOG_KEYS] for e in eng.migration_log]


def _engine_kw(case, kind):
    kw = dict(ENGINE, tp=CASES[case][3])
    if KINDS[kind].get("paged"):
        kw.update(paged=True, page_size=PAGE)
    return kw


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


def _lockstep(model, params, tokens, first):
    """Lock-step prefill then STEPS decode steps fed ``first``'s greedy
    tokens; the logits of every call, stacked."""
    state = model.init_decode_state(params, B, T_MAX)
    out, state = model.prefill(params, state, tokens)
    logits = [out]
    for s in range(STEPS):
        nxt = torch.from_numpy(first[s].argmax(-1).astype(np.int32))
        out, state = model.decode_step(params, state, nxt)
        logits.append(out)
    return torch.stack(logits), state


def _check_logits(report, case, mesh, params, placed, ref):
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import local, make_partitioner
    tp = CASES[case][3]
    tokens = torch.from_numpy(_tokens())
    want = ref[case]
    for kv, uk in LOGIT_RUNS:
        cfg = _cfg(case, kv_quant=kv)
        plain, _ = _lockstep(build_model(cfg, tp=tp, use_kernel=uk,
                                         device="cpu"),
                             params, tokens, want)
        got, state = _lockstep(
            build_model(cfg, tp=tp, use_kernel=uk, device="cpu",
                        part=make_partitioner(mesh)),
            placed, tokens, want)
        label = f"{case} kv={kv} kernel={uk}"
        report[f"logits {label} vs port"] = \
            (got - plain).abs().max().item()
        if not kv:
            report[f"logits {label} vs reference"] = \
                (got - torch.from_numpy(want)).abs().max().item()
        report[f"lockstep cache {label}"] = list(
            local(state["cache"]["k"]).shape)


def _expected_sent(rel, G, rep, coord, ranks, row_bytes):
    """The KV rows this rank sends in a migration by ``rel`` (L, Hp), and
    their bytes: rows of its chunk that land in another rank's chunk."""
    from repro_torch.core.placement_bridge import (expand_kv_perms,
                                                   kv_group_perms)
    kv = expand_kv_perms(kv_group_perms(rel, G), rep) if G > 1 else rel
    n = kv.shape[1] // ranks
    dst_rank = np.arange(kv.shape[1]) // n
    rows = int(((kv // n == coord) & (dst_rank[None] != coord)).sum())
    return rows, rows * row_bytes


def _check_engine(report, case, kind, mesh, placed):
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.core.placement_bridge import relative_perms
    from repro_torch.models.partitioning import local, make_partitioner
    from repro_torch.serving.engine import ServingEngine
    cfg = _cfg(case, kv_quant=KINDS[kind].get("kv_quant", False))
    eng = ServingEngine(cfg, part=make_partitioner(mesh), use_kernel=True,
                        device="cpu", net=DeviceNetwork.sample(4, seed=1),
                        params=placed, **_engine_kw(case, kind))
    hd = eng.model.hd
    run = _run_id(case, kind)
    coord = mesh.get_coordinate()[1]
    ranks = mesh.size(1)
    cache = eng.state["cache"]
    report[f"shard {run}"] = list(local(cache["k"]).shape)
    # the bytes of one KV row of this rank's shard, over k, v and scales
    row_bytes = sum(local(t)[0].select(-2 if n in ("k", "v") else -1, 0)
                    .numel() * local(t).element_size()
                    for n, t in cache.items())
    want_sent = []
    inner = eng._migrate_state

    def migrate(state, plan, *a, **kw):
        applied, reason = inner(state, plan, *a, **kw)
        if applied:
            rel = relative_perms(plan["prev_perms"], plan["perms"])
            rel = np.broadcast_to(rel, (cfg.n_layers, rel.shape[1]))
            rows, nbytes = _expected_sent(rel, hd.Hp // hd.Kp, hd.rep,
                                          coord, ranks, row_bytes)
            # each crossing row moves in every cache buffer
            want_sent.append((rows * len(cache), nbytes))
        return applied, reason

    eng._migrate_state = migrate
    ptrs = []
    step = eng.model.decode_step

    def decode_step(params, state, tokens):
        before = [local(t).data_ptr() for t in state["cache"].values()]
        out, state = step(params, state, tokens)
        ptrs.append((len(eng.exchange_log), before,
                     [local(t).data_ptr() for t in state["cache"].values()]))
        return out, state

    eng.model.decode_step = decode_step
    report[f"streams {run}"] = _drive(eng)
    report[f"log {run}"] = _log(eng)
    report[f"sent {run}"] = [[e["kv_rows"], e["kv_bytes"]]
                             for e in eng.exchange_log]
    report[f"expected sent {run}"] = [list(w) for w in want_sent]
    # decode steps between the same two migrations see the same storage
    report[f"moved storage {run}"] = sum(
        len({tuple(a[1]), tuple(a[2]), tuple(b[1]), tuple(b[2])}) > 1
        for a, b in zip(ptrs, ptrs[1:]) if a[0] == b[0])
    report[f"decode steps {run}"] = len(ptrs)


def _check_permutations(report, mesh, params, placed, cfg, tp):
    """Sharded ``apply_layer_head_perms`` and ``permute_model_heads_layers``
    against the unsharded ones: each rank's shard is its chunk."""
    from repro_torch.core.placement_bridge import (apply_layer_head_perms,
                                                   permute_model_heads_layers)
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import (Sharding, local, place,
                                                 placements)
    from repro_torch.tree import flatten
    model = build_model(cfg, tp=tp, device="cpu")
    hd = model.hd
    G = hd.Hp // hd.Kp
    rng = np.random.default_rng(9)
    # group-consistent query-head permutations, one per layer
    perms = np.stack([(rng.permutation(hd.Hp // G)[:, None] * G
                       + np.arange(G)).reshape(-1)
                      for _ in range(cfg.n_layers)])
    k = torch.from_numpy(rng.standard_normal(
        (cfg.n_layers, B, T_MAX, hd.KvE, hd.dh)).astype(np.float32))
    spec = (None, "data", None, "model", None)
    dk = place(k.clone(), Sharding(mesh, placements(mesh, spec)))
    want, _ = apply_layer_head_perms(k, k, perms, head_axis=-2,
                                     group_size=G, rep=hd.rep)
    sent = {}
    got, _ = apply_layer_head_perms(dk, dk.clone(), perms, head_axis=-2,
                                    group_size=G, rep=hd.rep, sent=sent)
    same = torch.equal(local(got),
                       local(place(want, Sharding(mesh, dk.placements))))
    want_p = flatten(permute_model_heads_layers(params, perms,
                                                group_size=G))
    got_p = flatten(permute_model_heads_layers(placed, perms, group_size=G))
    same_p = all(torch.equal(local(got_p[p]), local(place(
        want_p[p], Sharding(mesh, tuple(got_p[p].placements)))))
        for p in want_p)
    report["sharded permutation is the chunk of the whole"] = \
        [bool(same), bool(same_p), sent.get("rows", 0)]


def _worker(rank, port, out):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.weights import params_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    out = Path(out)
    report = {}
    try:
        meshes, cases = {}, {}
        for case, (_, _, shape, tp) in CASES.items():
            if shape not in meshes:
                meshes[shape] = make_debug_mesh(*shape, device_type="cpu")
            params = params_from_jax(_load_tree(out / f"{case}.npz"), "cpu")
            cases[case] = (meshes[shape], params,
                           _placed(params, _cfg(case), meshes[shape]))
        for case, kind in RUNS:
            mesh, params, _ = cases[case]
            _check_engine(report, case, kind, mesh,
                          _placed(params, _cfg(case), mesh))
        # the parent writes the reference's logits while the engines run
        for _ in range(2400):
            if (out / "ref.npz").exists():
                break
            time.sleep(0.1)
        ref = dict(np.load(out / "ref.npz"))
        for case, (mesh, params, placed) in cases.items():
            _check_logits(report, case, mesh, params, placed, ref)
        mesh, params, placed = cases["llama (2, 2)"]
        _check_permutations(report, mesh, params, placed,
                            _cfg("llama (2, 2)"), CASES["llama (2, 2)"][3])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (out / f"report_{rank}.json").write_text(json.dumps(report))


def _main(out):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, out), nprocs=WORLD, join=True)
    reports = [json.loads(Path(out, f"report_{r}.json").read_text())
               for r in range(WORLD)]
    # {key: [rank 0's value, ..., rank 3's]}
    keys = sorted({k for r in reports for k in r})
    print(json.dumps({k: [r.get(k) for r in reports] for k in keys}))


# ----------------------------------------------------- the parent's part
def _write_weights(out):
    """Each case's weights — the port's init at its tp from seed 0, QKV
    biases seeded on the real heads (padded rows stay zero) — written for
    the ranks and returned as numpy trees."""
    from repro_torch.models.api import build_model
    weights = {}
    rng = np.random.default_rng(7)
    for case, (_, _, _, tp) in CASES.items():
        cfg = _cfg(case)
        params = build_model(cfg, tp=tp, device="cpu").init(
            # rpr: ignore[RPR001] -- another model's weights, from seed 0
            torch.Generator().manual_seed(0))
        attn = params["layers"]["attn"]
        for n, real in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            b = torch.zeros_like(attn[n])
            b[..., :real, :] = torch.from_numpy(0.5 * rng.standard_normal(
                tuple(b[..., :real, :].shape))).float()
            attn[n] = b
        _save_tree(out / f"{case}.npz", params)
        weights[case] = _load_tree(out / f"{case}.npz")
    return weights


def _jax_cfg(case, **over):
    from repro.configs import get_config as jax_get_config
    arch, o, _, _ = CASES[case]
    return jax_get_config(arch).with_overrides(**_overrides(arch, o, over))


def _compiled(model):
    """The reference's lock-step prefill and decode step, compiled once
    each (the state donated, as the reference engine does)."""
    import jax
    return tuple(jax.jit(f, donate_argnums=(1,))
                 for f in (model.prefill, model.decode_step))


def _write_reference_logits(out, weights):
    """The JAX package's lock-step logits of each case (linear cache),
    prefill and decode compiled once each (``_compiled``); written whole,
    for ranks that wait for the file."""
    import jax
    import jax.numpy as jnp
    from repro.models.api import build_model as jax_build_model
    logits = {}
    for case, (_, _, _, tp) in CASES.items():
        pj = jax.tree.map(jnp.asarray, weights[case])
        model = jax_build_model(_jax_cfg(case), tp=tp)
        prefill, step = _compiled(model)
        state = model.init_decode_state(pj, B, T_MAX)
        out_, state = prefill(pj, state, jnp.asarray(_tokens()))
        got = [np.asarray(out_)]
        for _ in range(STEPS):
            out_, state = step(pj, state, jnp.asarray(
                got[-1].argmax(-1).astype(np.int32)))
            got.append(np.asarray(out_))
        logits[case] = np.stack(got)
    np.savez(out / "ref_tmp.npz", **logits)
    os.replace(out / "ref_tmp.npz", out / "ref.npz")


def _engine_expectations(weights):
    """The JAX package's engine and the unsharded port engine on each
    run's weights and traffic: their streams and migration logs."""
    import jax
    import jax.numpy as jnp
    from repro.core.network import DeviceNetwork as JaxNetwork
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.weights import params_from_jax

    expect = {}
    for case, kind in RUNS:
        params = weights[case]
        over = dict(kv_quant=KINDS[kind].get("kv_quant", False))
        kw = _engine_kw(case, kind)
        ref = JaxEngine(_jax_cfg(case, **over),
                        net=JaxNetwork.sample(4, seed=1), **kw)
        ref.params = jax.tree.map(jnp.asarray, params)
        port = ServingEngine(_cfg(case, **over), use_kernel=True,
                             device="cpu", net=DeviceNetwork.sample(4, seed=1),
                             params=params_from_jax(params, "cpu"), **kw)
        expect[_run_id(case, kind)] = {
            "reference": _drive(ref), "port": _drive(port),
            "reference log": _log(ref), "port log": _log(port)}
    return expect


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run (one subprocess, 240 s at most) while this process
    computes the reference's logits and serves the same traffic on the
    reference and unsharded engines."""
    out = tmp_path_factory.mktemp("shard_serve")
    weights = _write_weights(out)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), str(REPO)]), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env,
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        _write_reference_logits(out, weights)
        expect = _engine_expectations(weights)
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    return expect, json.loads(stdout.strip().splitlines()[-1])


LOGIT_CASES = [(c, kv, uk, against) for c in CASES for kv, uk in LOGIT_RUNS
               for against in (("port",) if kv else ("port", "reference"))]


@pytest.mark.parametrize("case,kv,uk,against", LOGIT_CASES)
def test_sharded_lockstep_logits_equal_unsharded(runs, case, kv, uk,
                                                 against):
    """Every rank's whole prefill and per-step decode logits against the
    unsharded port's and (linear cache) the JAX package's on the same
    weights."""
    gaps = runs[1][f"logits {case} kv={kv} kernel={uk} vs {against}"]
    assert len(gaps) == WORLD and max(gaps) <= TOL, gaps


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("case,kind", RUNS)
def test_sharded_engine_streams_equal_unsharded(runs, case, kind, against):
    expect, report = runs
    run = _run_id(case, kind)
    want = expect[run][against]
    assert len(want) == len(PROMPT_LENS)
    assert report[f"streams {run}"] == [want] * WORLD


@pytest.mark.parametrize("case,kind", RUNS)
def test_migration_logs_equal_on_every_rank(runs, case, kind):
    """Every rank runs the same scheduler and controller: its log equals
    the others' and the unsharded port engine's (and, plans aside from
    the paged pricing, the reference's, which the port engine tests
    hold)."""
    expect, report = runs
    run = _run_id(case, kind)
    logs = report[f"log {run}"]
    assert logs == [expect[run]["port log"]] * WORLD
    assert any(e[3] and e[1] for e in logs[0]), "no migration was applied"


@pytest.mark.parametrize("case,kind", RUNS)
def test_each_rank_holds_its_cache_shard_written_in_place(runs, case, kind):
    """The local shard is (L, B/dp, T, KvE/tp, dh) — a paged store (L,
    n_pages + 1, P, KvE/tp, dh) — and decode steps between two migrations
    write it in place."""
    from repro_torch.models.layers import head_dims
    _, report = runs
    run = _run_id(case, kind)
    _, _, (dp, tp_mesh), tp = CASES[case]
    cfg = _cfg(case)
    hd = head_dims(cfg, tp)
    if KINDS[kind].get("paged"):
        pages = ENGINE["n_slots"] * ENGINE["max_seq"] // PAGE
        want = [cfg.n_layers, pages + 1, PAGE, hd.KvE // tp_mesh, hd.dh]
    else:
        want = [cfg.n_layers, ENGINE["n_slots"] // dp, ENGINE["max_seq"],
                hd.KvE // tp_mesh, hd.dh]
    assert report[f"shard {run}"] == [want] * WORLD
    assert min(report[f"decode steps {run}"]) > 8
    assert report[f"moved storage {run}"] == [0] * WORLD


@pytest.mark.parametrize("case,kind", RUNS)
def test_migrations_send_only_the_rows_that_change_rank(runs, case, kind):
    """Per applied migration, each rank's sent rows and bytes equal the KV
    rows of its chunk that the applied permutation lands in another
    rank's chunk, times a row's bytes; some rank sends some."""
    _, report = runs
    run = _run_id(case, kind)
    sent = report[f"sent {run}"]
    assert sent == report[f"expected sent {run}"]
    assert sum(rows for per_rank in sent for rows, _ in per_rank) > 0


@pytest.mark.parametrize("case", [c for c in CASES])
def test_lockstep_cache_shard_shape(runs, case):
    _, report = runs
    _, _, (dp, tp_mesh), tp = CASES[case]
    from repro_torch.models.layers import head_dims
    cfg = _cfg(case)
    hd = head_dims(cfg, tp)
    want = [cfg.n_layers, B // dp, T_MAX, hd.KvE // tp_mesh, hd.dh]
    for kv, uk in LOGIT_RUNS:
        assert report[f"lockstep cache {case} kv={kv} kernel={uk}"] == \
            [want] * WORLD


def test_sharded_permutations_are_chunks_of_the_whole(runs):
    """On the (2, 2) mesh: a (L, B, T, KvE, dh) cache and the placed
    weights permuted by random group-consistent perms; every rank's shard
    is bit-equal to its chunk of the unsharded result, and rows were
    sent."""
    got = runs[1]["sharded permutation is the chunk of the whole"]
    assert all(r[0] and r[1] for r in got), got
    assert sum(r[2] for r in got) > 0


# ------------------------------------------------- without ranks (CPU)
class _StandInMesh:
    """What ``local_extent`` and the refusals read of a ``DeviceMesh``:
    dimension names and sizes, this rank's coordinate."""

    def __init__(self, shape, names, coord=None):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)
        self.coord = coord

    def size(self, mesh_dim=None):
        return math.prod(self.shape) if mesh_dim is None \
            else self.shape[mesh_dim]

    def get_coordinate(self):
        return self.coord


@pytest.mark.parametrize("n", [7, 8, 1, 0])
def test_local_extent_cuts_as_torch_chunk(n):
    """Each rank's slice of an uneven axis sharded over "model" (and a
    second axis over "data") is its ``torch.chunk``."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.partitioning import Sharding, local_extent
    x = torch.arange(n * 6).reshape(n, 6)
    for d in range(2):
        for m in range(4):
            mesh = _StandInMesh((2, 4), ("data", "model"), coord=(d, m))
            ext = local_extent(x.shape, Sharding(mesh, (Shard(1),
                                                        Shard(0))))
            rows = torch.chunk(x, 4, dim=0)
            want = rows[m] if m < len(rows) else x[:0]
            want = torch.chunk(want, 2, dim=1)[d]
            got = x.narrow(0, *ext[0]).narrow(1, *ext[1])
            assert torch.equal(got, want), (d, m, ext)
    mesh = _StandInMesh((1, 1), ("data", "model"), coord=(0, 0))
    assert local_extent((n, 6), Sharding(mesh, (Replicate(),) * 2)) == \
        [(0, n), (0, 6)]


def _decode_case(kind, rng, *, B_=3, H=8, KvE=4, T=40, dh=16, P=8):
    """q, a cache of ``kind`` and lengths at the port's shapes (q (B, 1,
    H, dh); linear (B, T, KvE, dh); paged (n_pages, P, KvE, dh) with a
    scrambled page table)."""
    q = torch.from_numpy(rng.standard_normal((B_, 1, H, dh)).astype(
        np.float32))
    lens = torch.tensor([T, 17, 1][:B_], dtype=torch.int32)
    kv = {n: torch.from_numpy(rng.standard_normal((B_, T, KvE, dh)).astype(
        np.float32)) for n in ("k", "v")}
    if "int8" in kind:
        for n in ("k", "v"):
            kv[n + "_sc"] = torch.from_numpy(rng.uniform(
                0.01, 0.1, (B_, T, KvE)).astype(np.float32))
            kv[n] = torch.from_numpy(rng.integers(
                -127, 128, (B_, T, KvE, dh)).astype(np.int8))
    pmap = None
    if "paged" in kind:
        n_log = T // P
        order = rng.permutation(B_ * n_log)
        pmap = torch.from_numpy(order.reshape(B_, n_log).astype(np.int32))
        kv = {n: t.reshape((B_ * n_log, P) + t.shape[2:])[
            torch.from_numpy(np.argsort(order))] for n, t in kv.items()}
    return q, kv, lens, pmap


def _decode(kind, q, kv, lens, pmap, rows, inv):
    from repro_torch.kernels import ops
    if kind == "linear":
        return ops.decode_attention_resident_bshd(q, kv["k"], kv["v"], lens,
                                                  rows, inv_rows=inv)
    if kind == "int8":
        return ops.decode_attention_int8_resident_bshd(
            q, kv["k"], kv["k_sc"], kv["v"], kv["v_sc"], lens, rows,
            inv_rows=inv)
    if kind == "paged":
        return ops.decode_attention_paged_bshd(q, kv["k"], kv["v"], lens,
                                               pmap, rows, inv_rows=inv)
    return ops.decode_attention_int8_paged_bshd(
        q, kv["k"], kv["k_sc"], kv["v"], kv["v_sc"], lens, pmap, rows,
        inv_rows=inv)


@pytest.mark.parametrize("kind", list(KINDS))
def test_localized_rows_put_together_equal_the_whole_call(kind):
    """A straggler plan's row maps under a non-identity applied layout,
    localized to each of 4 head shards (``local_head_rows``): the kernel's
    plain version on each rank's q heads and KV rows, put together, is the
    whole call.  Each shard's rows are its heads once each, in the whole
    map's order, and keep whole KV groups."""
    from repro_torch.core.blocks import make_blocks
    from repro_torch.core.placement_bridge import head_row_maps
    from repro_torch.models.partitioning import local_head_rows
    rng = np.random.default_rng(3)
    H, KvE, ranks = 8, 4, 4
    G = H // KvE
    q, kv, lens, pmap = _decode_case(kind, rng, H=H, KvE=KvE)
    blocks = make_blocks(H)
    place = rng.integers(0, 4, len(blocks))
    layout = (rng.permutation(KvE)[:, None] * G + np.arange(G)).reshape(
        1, -1)
    rows, inv = head_row_maps(place, blocks, 4, H, perms=layout)
    assert not np.array_equal(rows[0], np.arange(H))
    whole = _decode(kind, q, kv, lens, pmap, torch.from_numpy(rows[0]),
                    torch.from_numpy(inv[0]))
    n, nk = H // ranks, KvE // ranks
    parts = []
    for r in range(ranks):
        lr, li = local_head_rows(rows, r * n, n)
        np.testing.assert_array_equal(lr[0] + r * n,
                                      [x for x in rows[0]
                                       if r * n <= x < (r + 1) * n])
        assert set(lr[0] // G) == set(range(nk))      # whole KV groups
        kv_r = {name: t[:, :, r * nk:(r + 1) * nk] for name, t in kv.items()}
        parts.append(_decode(kind, q[:, :, r * n:(r + 1) * n], kv_r, lens,
                             pmap, torch.from_numpy(lr[0]),
                             torch.from_numpy(li[0])))
    torch.testing.assert_close(torch.cat(parts, dim=2), whole, atol=1e-6,
                               rtol=1e-6)


def test_local_head_rows_refuse_maps_that_miss_the_range():
    from repro_torch.models.partitioning import local_head_rows
    with pytest.raises(ValueError, match="cover"):
        local_head_rows(np.array([[0, 1, 1, 3]]), 0, 2)


def test_paged_cache_on_a_mesh_with_data_above_1_is_refused():
    """A page store on a mesh whose "data" is above 1 is a pool for each
    data rank (its page axis over "data", as the decode-state rule places
    it; ``tests/test_torch_paged_shard.py`` serves from it): only a pool
    that does not split evenly over the data ranks is refused, with its
    numbers, and so is a paged state whose rows do not."""
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner
    cfg = _cfg("llama (2, 2)")
    part = make_partitioner(_StandInMesh((2, 2), ("data", "model")))
    model = build_model(cfg, tp=2, part=part, device="cpu")
    with pytest.raises(ValueError, match="7 pages .* 2 batch ranks"):
        model.init_paged_cache(7, 4)
    with pytest.raises(ValueError, match="3 rows .* 2 batch ranks"):
        model.init_paged_state(None, 3, 8, 4, 2)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "musicgen-large",
                                  "rwkv6-7b", "zamba2-2.7b",
                                  "llama-3.2-vision-11b"])
def test_serving_engine_refuses_a_mesh_outside_the_dense_family(arch):
    """No family is refused a mesh any more: the engine serves the MoE,
    audio, VLM, RWKV-6 and Zamba2 families on one.  Placing their weights
    needs a real ``DeviceMesh``, so each case builds the engine on a
    one-rank gloo mesh, its weights DTensors there: musicgen and the VLM
    through the continuous engine (``make_engine("auto")`` does not fall
    back to the wave engine), the others through the wave engine.  The
    decode states' caches (a VLM's image K/V and mask too) are DTensors
    placed as the decode-state rules say, and every family but MoE serves
    the unsharded engine's greedy streams on the same weights (a VLM's
    requests with an image of all, half and none of its buffer)."""
    from repro_torch.configs import get_config
    from repro_torch.core.placement_bridge import decode_state_shardings
    from repro_torch.models.partitioning import is_dtensor, make_partitioner
    from repro_torch.serving.engine import (ServingEngine, WaveServingEngine,
                                            make_engine)
    from repro_torch.tree import flatten
    from tests.conftest import reduced_config
    cfg = get_config(arch).with_overrides(
        **dataclasses.asdict(reduced_config(arch)))
    continuous = cfg.family in ("audio", "vlm")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        part = make_partitioner(mesh)
        kw = dict(tp=4, device="cpu", n_slots=2, max_seq=16, lam=3)
        if cfg.family == "vlm":
            kw["img_tokens"] = 4
        eng = make_engine(cfg, part=part, **kw)
        assert type(eng) is (ServingEngine if continuous
                             else WaveServingEngine) and eng.part is part
        if cfg.family == "moe":
            assert is_dtensor(eng.params["layers"]["moe"]["w_gate"])
            return
        big = {"ssm": "wr", "hybrid": "w_in"}.get(cfg.family)
        assert is_dtensor(eng.params["layers"][big] if big
                          else eng.params["layers"]["attn"]["wq"])
        state = eng.state if continuous else \
            eng.model.init_decode_state(eng.params, 2, 16)
        want = flatten(decode_state_shardings(state, cfg, mesh))
        leaves = {p: t for p, t in flatten(state).items()
                  if p[0] in ("cache", "img_kv", "img_mask")}
        assert leaves and all(
            is_dtensor(t) and tuple(t.placements) == want[p].placements
            for p, t in leaves.items())
        plain = make_engine(cfg, params=_local_tree(eng.params), **kw)
        rng = np.random.default_rng(3)
        for e in (eng, plain):
            for i, n in enumerate((5, 5, 7)):
                img = {} if cfg.family != "vlm" or i == 1 else dict(
                    img_embeds=rng.standard_normal((4 // (1 + i // 2),
                                                    cfg.d_model)))
                e.submit(np.random.default_rng(n).integers(0, 97, n), 6,
                         **img)
            e.run()
        streams = [{r.rid: r.out_tokens for r in e.finished}
                   for e in (eng, plain)]
        assert len(streams[0]) == 3 and streams[0] == streams[1]
    finally:
        dist.destroy_process_group()


def _local_tree(tree):
    """A copy of a tree of one-rank DTensors as plain tensors."""
    from repro_torch.models.partitioning import local
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    return local(tree).clone()


def test_one_row_stays_whole_on_the_data_axes():
    """``for_batch``: a batch that splits over "data" keeps the rules; one
    row, or rows that do not split, keep the batch whole there."""
    from repro_torch.models.partitioning import make_partitioner
    part = make_partitioner(_StandInMesh((2, 2), ("data", "model")))
    assert part.for_batch(4) is part
    for b in (1, 3):
        assert part.for_batch(b).rules["batch"] is None
        assert part.for_batch(b).rules["heads"] == "model"
    one = make_partitioner(_StandInMesh((1, 4), ("data", "model")))
    assert one.for_batch(2) is one and one.for_batch(1) is not one


if __name__ == "__main__":
    _main(sys.argv[1])
