"""int8 weights and paged caches on a DeviceMesh: the four gloo ranks and
the parent's expectations behind ``tests/test_torch_int8_shard.py``,
``tests/test_torch_int8_shard_hybrid.py`` and
``tests/test_torch_paged_shard.py``.

Each test file starts four CPU ranks over gloo in one subprocess (its own
timeout) for its cases.  The parent writes each case's float32 weights —
the port's init at the case's tp from seed 0, with the leaves the
reference's init leaves at zero or one seeded in both packages (QKV
biases on the real heads, LayerNorm and MLP biases, the router, the VLM's
gates, Zamba2's SSM parameters): a zero init would hide a bias added on
every rank — and while the ranks run computes what they are held to.

int8 weights (``INT8_CASES``).  Every rank quantizes the float32 weights
with ``quantize_params`` and places the ``q8``/``sc`` leaves by
``param_shardings``, then checks and reports:
- each int8 leaf's placement and local shape (``param_spec``'s);
- lock-step ``prefill`` and per-step ``decode_step`` logits, with and
  without the kernels' plain versions (a VLM's over images that fill,
  half fill and leave empty a row's buffer), against the unsharded port
  on the same int8 weights and the JAX package's model on its own
  ``quantize_params`` of the float32 weights (jitted once a case);
- mixtral's cacheless forward, dense and capacity dispatch over "pod";
- the collectives inside ``quantization.wt`` of every placed int8 leaf
  (``CommDebugMode``): none;
- a planted fault (each rank quantizing its own shard of the float32
  weights, its scales from that shard's absmax), through the lock-step
  logits: the gap the tests must see above their bound.

Paged caches (``PAGED_RUNS``).  ``ServingEngine(paged=True, part=...)``
(``make_engine("auto")``: the tests assert that it did not fall back to
the wave engine) serves the traffic with a 500x straggler at step 4
(mixtral's: one on the device with the most expert blocks and one on the
device with the most other heads), and every rank reports its streams,
admission and migration logs, its waits by batch rank, its store's local
shape and whether every decode step saw one storage, the largest page id
in its page table (rank-local: below its pool), whether every
allocator's invariants held after every step, and the KV rows and bytes
each applied migration sent against the rows of its chunk that the plan
puts on another "model" rank (worked out from the plan here).  The
parent serves the same traffic through the unsharded port engine and the
JAX package's engine at the default pool; at a tight pool it replays the
admissions and retires through one ``PagedKVAllocator`` a batch rank
(``replay_pools``).  A planted fault — the engine mounting global page
ids (the pool's offset of the row's batch rank plus its local id) — is
run through admission alone (a global id past a rank's pool would index
past its store) and its largest page id reported.

Mixtral keeps paged caches only without a sliding window, in both
packages (``init_paged_cache``): the paged runs serve it with
``sliding_window=0``, the same function as a window of 4096 at
``max_seq`` 64.  The worker imports no JAX.  ``python
tests/torch_mem_ranks.py <dir> <int8|paged> <fault case> <case> ...``
runs the ranks by hand once the parent has written ``<dir>``'s weights
and ``ref.npz``.
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

from tests.torch_audio_vlm_ranks import (_crossing_bytes, images, load_tree,
                                         save_tree)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 1e-5
# Zamba2's logits: each of its blocks differs from the unsharded one's by a
# few ulps under the sharded reductions, and the residual stream
# compounds them (as in tests/test_torch_ssm_shard_zamba2.py, which holds
# its float32 logits to the same bound against the port); measured on int8
# weights: 8.5e-6 against the port, 1.13e-5 against the reference
ZAMBA2_TOL = 2e-5
B, PROMPT, STEPS, T_MAX = 4, 8, 3, 16      # lock-step logits
FORWARD_S = 12
GATE, GATE_FFN = 0.7, 0.5

# name -> (mesh shape, mesh dimension names)
MESHES = {"(1, 4)": ((1, 4), ("data", "model")),
          "(2, 2)": ((2, 2), ("data", "model")),
          "(4, 1)": ((4, 1), ("data", "model")),
          "(2, 1, 2)": ((2, 1, 2), ("pod", "data", "model"))}
BASE = dict(d_model=64, d_ff=128, vocab_size=97, dtype="float32",
            param_dtype="float32", n_heads=8, d_head=8)
ZAMBA2 = dict(n_layers=4, shared_attn_every=2, n_heads=4, d_head=16,
              n_kv_heads=4, ssm_head_dim=16, ssm_state=8)
MIXTRAL = dict(n_layers=2, n_kv_heads=2, n_experts=4, qkv_bias=True)
LLAMA = dict(n_layers=2, n_kv_heads=2, qkv_bias=True)
# case -> (arch, overrides, mesh name); tp is the mesh's "model" degree
INT8_CASES = {
    "llama (2, 2)": ("llama3-8b", LLAMA, "(2, 2)"),
    "glm4 (1, 4)": ("glm4-9b", dict(n_layers=2, n_kv_heads=2), "(1, 4)"),
    "qwen padded (1, 4)": ("qwen1.5-32b",
                           dict(n_layers=2, n_heads=6, n_kv_heads=6),
                           "(1, 4)"),
    "musicgen (2, 2)": ("musicgen-large", dict(n_layers=2, n_kv_heads=8),
                        "(2, 2)"),
    "mixtral (2, 1, 2)": ("mixtral-8x7b", dict(MIXTRAL, sliding_window=8),
                          "(2, 1, 2)"),
    "vlm (1, 4)": ("llama-3.2-vision-11b", dict(n_layers=5, n_kv_heads=4),
                   "(1, 4)"),
    "vlm (2, 2)": ("llama-3.2-vision-11b", dict(n_layers=5, n_kv_heads=4),
                   "(2, 2)"),
    "zamba2 (1, 4)": ("zamba2-2.7b", ZAMBA2, "(1, 4)"),
    "zamba2 (4, 1)": ("zamba2-2.7b", ZAMBA2, "(4, 1)"),
}
# paged runs: name -> (arch, overrides, mesh name, kv_pages; None: the
# default pool, the group's dense reservation)
PAGE = 8
PAGED_RUNS = {
    "llama paged (2, 2)": ("llama3-8b", LLAMA, "(2, 2)", None),
    "llama int8-paged (2, 2)": ("llama3-8b", dict(LLAMA, kv_quant=True),
                                "(2, 2)", None),
    "llama paged (1, 4)": ("llama3-8b", LLAMA, "(1, 4)", None),
    "llama int8-paged (1, 4)": ("llama3-8b", dict(LLAMA, kv_quant=True),
                                "(1, 4)", None),
    "mixtral paged (2, 1, 2)": ("mixtral-8x7b",
                                dict(MIXTRAL, sliding_window=0), "(2, 1, 2)",
                                None),
    # tight pools: rank 0 waits (6 pages, 3 a rank), rank 1 waits (10)
    "llama tight 6 (2, 2)": ("llama3-8b", LLAMA, "(2, 2)", 6),
    "llama tight 10 (2, 2)": ("llama3-8b", LLAMA, "(2, 2)", 10),
}
PROMPT_LENS = (5, 11, 8, 14, 6, 9)         # engine traffic
ENGINE = dict(n_slots=4, max_seq=64, lam=3, seed=0)
STRAGGLE_AT = 4
LOG_KEYS = ("step", "n_migrations", "mig_bytes", "n_expert_migrations",
            "applied", "reason", "expert_applied")


def _entry(case):
    return INT8_CASES[case] if case in INT8_CASES else PAGED_RUNS[case]


def mesh_of(case):
    return MESHES[_entry(case)[2]]


def tp_of(case):
    return mesh_of(case)[0][-1]


def dp_of(case):
    return int(np.prod(mesh_of(case)[0][:-1]))


def overrides(case):
    return {**BASE, **_entry(case)[1]}


def arch_of(case):
    return _entry(case)[0]


def port_cfg(case):
    from repro_torch.configs import get_config
    return get_config(arch_of(case)).with_overrides(**overrides(case))


def is_vlm(case):
    return arch_of(case) == "llama-3.2-vision-11b"


def kv_pages_of(case):
    return PAGED_RUNS[case][3]


def tokens(S=PROMPT):
    return np.random.default_rng(1).integers(0, 97, (B, S)).astype(
        np.int32)


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 97, size=n) for n in PROMPT_LENS]


def max_new(i):
    return 7 + 2 * (i % 2)


def drive(eng, on_step=None):
    """Every request submitted, then scheduler steps to the end with the
    stragglers landing at step ``STRAGGLE_AT`` (``stragglers``);
    ``on_step()`` after each step.  Returns {rid: tokens}."""
    for i, p in enumerate(prompts()):
        eng.submit(p, max_new_tokens=max_new(i))
    while True:
        if eng.decode_steps == STRAGGLE_AT:
            stragglers(eng)
        if not eng.step():
            break
        if on_step is not None:
            on_step()
    return {str(r.rid): [int(t) for t in r.out_tokens] for r in eng.finished}


def stragglers(eng):
    """A 500x straggler on the device holding the most heads; for an
    expert-placing controller, first one on the device holding the most
    expert blocks, then the heads' one on another device."""
    heads = np.asarray(eng.controller.head_counts(), float)
    experts = np.zeros(eng.net.n_devices)
    for b in eng.controller.blocks:
        if b.kind == "expert":
            experts[int(eng.controller.place[b.index])] += 1
    if experts.any():
        dev = int(experts.argmax())
        eng.net.inject_straggler(dev, slowdown=500.0)
        heads[dev] = -1
    eng.net.inject_straggler(int(heads.argmax()), slowdown=500.0)


def log_of(eng):
    return [[e[k] for k in LOG_KEYS] for e in eng.migration_log]


def admissions_of(eng):
    return [[e["step"], e["slot"], e["rid"], e["bucket"], e["pages"]]
            for e in eng.admission_log]


def engine_kw(case):
    kw = dict(ENGINE, tp=tp_of(case), paged=True, page_size=PAGE)
    if kv_pages_of(case) is not None:
        kw["kv_pages"] = kv_pages_of(case)
    return kw


def network(package):
    return package.sample(4, seed=1)


# ------------------------------------------------------------- the worker
def _placed(params, cfg, mesh):
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.models.partitioning import place
    from repro_torch.tree import flatten, map_with_path
    sh = flatten(param_shardings(params, cfg, mesh))
    return map_with_path(lambda p, v: place(v.clone(), sh[p]), params)


def _own_shard_quantized(params, cfg, mesh):
    """The planted fault: each rank quantizes its own shard of every
    quantizable float32 leaf (its scales from its shard's absmax), placed
    as ``param_spec`` places ``q8`` and ``sc``.  A scale the placement
    replicates has the whole shape on every rank, a sharded one the
    rank's chunk: the shard's own scales have those shapes too."""
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.models.partitioning import Sharding, from_local, local
    from repro_torch.models.quantization import (_BASE_NDIM,
                                                 quantize_params,
                                                 quantize_weight)
    from repro_torch.tree import flatten
    q = quantize_params(params)
    sh = flatten(param_shardings(q, cfg, mesh))
    floats = flatten(_placed(params, cfg, mesh))
    placed = _placed(q, cfg, mesh)
    for path, leaf in _int8_leaves(placed).items():
        base = 3 if path[-2:-1] == ("moe",) else _BASE_NDIM[path[-1]]
        own = quantize_weight(local(floats[path]), base)
        for part in ("q8", "sc"):
            leaf[part] = from_local(own[part], Sharding(
                mesh, sh[path + (part,)].placements), leaf[part].shape)
    return placed


def _lockstep(model, params, case, first, S=PROMPT):
    """Lock-step prefill then STEPS decode steps fed ``first``'s greedy
    tokens; the logits of every call, stacked."""
    kw = {}
    if is_vlm(case):
        img, mask = images(B)
        kw = dict(img_embeds=torch.from_numpy(img),
                  img_mask=torch.from_numpy(mask))
    state = model.init_decode_state(params, B, T_MAX, **kw)
    out, state = model.prefill(params, state, torch.from_numpy(tokens(S)))
    logits = [out]
    for s in range(STEPS):
        nxt = torch.from_numpy(first[s].argmax(-1).astype(np.int32))
        out, state = model.decode_step(params, state, nxt)
        logits.append(out)
    return torch.stack(logits)


def _int8_leaves(tree, path=()):
    """{path: int8 leaf} of a param tree."""
    from repro_torch.models.quantization import is_quantized
    if is_quantized(tree):
        return {path: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_int8_leaves(v, path + (k,)))
        return out
    return {}


def _check_int8(report, case, mesh, params, ref, fault):
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import (Sharding, is_dtensor,
                                                 local, local_extent,
                                                 make_partitioner, whole)
    from repro_torch.models.quantization import quantize_params, wt
    from repro_torch.tree import flatten
    cfg, tp = port_cfg(case), tp_of(case)
    q = quantize_params(params)
    placed = _placed(q, cfg, mesh)
    sh = flatten(param_shardings(q, cfg, mesh))
    leaves = _int8_leaves(placed)
    wrong = []
    for path, leaf in leaves.items():
        for part in ("q8", "sc"):
            t, want = leaf[part], sh[path + (part,)]
            if not (is_dtensor(t) and tuple(t.placements) == want.placements
                    and list(local(t).shape) == [
                        n for _, n in local_extent(t.shape, want)]
                    and local(t).dtype == (torch.int8 if part == "q8"
                                           else torch.float32)):
                wrong.append("/".join(path + (part,)))
    report[f"int8 leaves {case}"] = [len(leaves), wrong]
    with CommDebugMode() as comm:
        for leaf in leaves.values():
            wt({"w": leaf}, "w", torch.float32)
    report[f"wt collectives {case}"] = comm.get_total_counts()
    for uk in (False, True):
        plain = _lockstep(build_model(cfg, tp=tp, use_kernel=uk,
                                      device="cpu"), q, case, ref[case])
        got = _lockstep(build_model(cfg, tp=tp, use_kernel=uk, device="cpu",
                                    part=make_partitioner(mesh)),
                        placed, case, ref[case])
        report[f"logits {case} kernel={uk} vs port"] = \
            (got - plain).abs().max().item()
        report[f"logits {case} kernel={uk} vs reference"] = \
            (got - torch.from_numpy(ref[case])).abs().max().item()
    if cfg.is_moe:
        toks = torch.from_numpy(tokens(FORWARD_S))
        for cap in (False, True):
            kw = dict(tp=tp, device="cpu", capacity_moe=cap)
            want, want_aux = build_model(cfg, **kw).forward(q, toks)
            got, aux = build_model(cfg, part=make_partitioner(mesh),
                                   **kw).forward(placed, toks)
            got, aux = whole(got), whole(aux)
            report[f"forward {case} capacity={cap}"] = [
                (got - want).abs().max().item(),
                (got - torch.from_numpy(ref[f"{case} forward {cap}"])
                 ).abs().max().item(),
                abs(float(aux) - float(want_aux)),
                abs(float(aux) - float(ref[f"{case} forward {cap} aux"]))]
    if case == fault:
        plain = _lockstep(build_model(cfg, tp=tp, use_kernel=True,
                                      device="cpu"), q, case, ref[case])
        got = _lockstep(build_model(cfg, tp=tp, use_kernel=True,
                                    device="cpu",
                                    part=make_partitioner(mesh)),
                        _own_shard_quantized(params, cfg, mesh), case,
                        ref[case])
        report[f"fault {case}"] = (got - plain).abs().max().item()


def _check_paged(report, case, mesh, params, fault):
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.core.placement_bridge import relative_perms
    from repro_torch.models.partitioning import local, make_partitioner
    from repro_torch.serving.engine import make_engine
    cfg = port_cfg(case)
    eng = make_engine(cfg, mode="auto", part=make_partitioner(mesh),
                      use_kernel=True, device="cpu",
                      net=network(DeviceNetwork),
                      params=_placed(params, cfg, mesh), **engine_kw(case))
    report[f"engine type {case}"] = type(eng).__name__
    hd = eng.model.hd
    coord, ranks = mesh.get_coordinate()[-1], mesh.size(mesh.ndim - 1)
    want_sent = []
    inner = eng._migrate_state

    def migrate(state, plan, *a, **kw):
        applied, reason = inner(state, plan, *a, **kw)
        if applied:
            rel = np.broadcast_to(
                relative_perms(plan["prev_perms"], plan["perms"]),
                (cfg.n_layers, hd.Hp))
            want_sent.append(_crossing_bytes(
                rel, hd, coord, ranks,
                [(n, t, t.shape[0]) for n, t in state["cache"].items()]))
        return applied, reason

    eng._migrate_state = migrate
    pool = eng.kv_pages // eng.batch_ranks
    seen = {"ptrs": set(), "largest id": -1, "invariants": True,
            "steps": 0}
    step = eng.model.decode_step

    def decode_step(p, state, toks):
        seen["ptrs"].add(tuple(local(t).data_ptr()
                               for t in state["cache"].values()))
        seen["largest id"] = max(seen["largest id"],
                                 int(local(state["page_map"]).max()))
        seen["steps"] += 1
        return step(p, state, toks)

    def check():
        for a in eng.allocators:
            try:
                a.check_invariants()
            except AssertionError:
                seen["invariants"] = False

    eng.model.decode_step = decode_step
    report[f"streams {case}"] = drive(eng, on_step=check)
    report[f"log {case}"] = log_of(eng)
    report[f"admissions {case}"] = admissions_of(eng)
    report[f"waits {case}"] = [eng.page_waits, eng.rank_page_waits]
    report[f"store {case}"] = {n: list(local(t).shape)
                               for n, t in eng.state["cache"].items()}
    report[f"storages {case}"] = len(seen["ptrs"])
    report[f"decode steps {case}"] = seen["steps"]
    report[f"largest page id {case}"] = [seen["largest id"], pool]
    report[f"invariants {case}"] = seen["invariants"] and all(
        a.live_pages == 0 for a in eng.allocators)
    report[f"sent {case}"] = [[e["kv_rows"], e["kv_bytes"]]
                              for e in eng.exchange_log if e["kv_rows"]
                              or e["kv_bytes"]]
    report[f"expected sent {case}"] = [list(w) for w in want_sent
                                       if w[0] or w[1]]
    if case == fault:
        report[f"fault {case}"] = _global_ids_fault(cfg, case, mesh, params)


def _global_ids_fault(cfg, case, mesh, params):
    """The planted fault: the engine mounts global page ids — the offset
    of the row's batch rank's pool plus its local id — into the table.
    Admission alone (the prefill replaced by zero logits: a global id past
    a rank's pool indexes past its store) fills every slot; returns the
    largest id in this rank's table and its pool's size."""
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.models.partitioning import local, make_partitioner
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, part=make_partitioner(mesh), use_kernel=True,
                        device="cpu", net=network(DeviceNetwork),
                        params=_placed(params, cfg, mesh), **engine_kw(case))
    pool = eng.kv_pages // eng.batch_ranks

    def mount(g, row, pos):
        alloc, r = eng._pool(g, row)
        ids = alloc.page_map_row(r)
        b = row // eng.rows_per_rank
        ids = np.where(ids >= 0, ids + b * pool, ids)
        eng.states[g] = eng.model.mount_slot_pages(eng.states[g], row, ids,
                                                   pos)

    def prefill_paged(p, state, toks, row, start, length):
        return torch.zeros((1, cfg.vocab_size)), state

    eng._mount = mount
    eng.model.prefill_paged = prefill_paged
    for i, p in enumerate(prompts()):
        eng.submit(p, max_new_tokens=max_new(i))
    eng._admit()
    return [int(local(eng.state["page_map"]).max()), pool]


def _worker(rank, port, out, kind, fault, cases):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.weights import params_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    out = Path(out)
    report = {}
    try:
        meshes = {}
        for case in cases:
            shape, names = mesh_of(case)
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, names, device_type="cpu")
        params = {case: params_from_jax(load_tree(out / f"{case}.npz"),
                                        "cpu") for case in cases}
        if kind == "paged":
            for case in cases:
                _check_paged(report, case, meshes[mesh_of(case)[0]],
                             params[case], fault)
        else:
            # the parent writes the reference's logits while ranks start
            for _ in range(2400):
                if (out / "ref.npz").exists():
                    break
                time.sleep(0.1)
            ref = dict(np.load(out / "ref.npz"))
            for case in cases:
                _check_int8(report, case, meshes[mesh_of(case)[0]],
                            params[case], ref, fault)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (out / f"report_{rank}.json").write_text(json.dumps(report))


def _main(out, kind, fault, cases):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, out, kind, fault, cases), nprocs=WORLD,
             join=True)
    reports = [json.loads(Path(out, f"report_{r}.json").read_text())
               for r in range(WORLD)]
    # {key: [rank 0's value, ..., rank 3's]}
    keys = sorted({k for r in reports for k in r})
    print(json.dumps({k: [r.get(k) for r in reports] for k in keys}))


# ----------------------------------------------------- the parent's part
def _seeded(rng, t, scale, real=None):
    """``t`` redrawn as ``scale`` N(0, 1) from ``rng``; with ``real``, only
    the first ``real`` rows of its head axis (-2), padded heads kept
    zero."""
    out = torch.zeros_like(t)
    rows = (slice(None),) * (t.dim() - 2) + (slice(0, real),) \
        if real is not None else (slice(None),)
    out[rows] = torch.from_numpy(scale * rng.standard_normal(
        tuple(out[rows].shape))).to(t.dtype)
    return out


def write_weights(out, cases):
    """Each case's float32 weights — the port's init at its tp from seed
    0, the leaves the reference's init leaves at zero or one drawn from
    seed 7 — written for the ranks and returned as numpy trees."""
    from repro_torch.models.api import build_model
    from repro_torch.models.moe import expert_identity
    from tests.torch_ssm_ranks import SEEDED
    weights = {}
    for case in cases:
        cfg = port_cfg(case)
        params = build_model(cfg, tp=tp_of(case), device="cpu").init(
            # rpr: ignore[RPR001] -- another model's weights, from seed 0
            torch.Generator().manual_seed(0))
        rng = np.random.default_rng(7)
        stacks = [params["layers"]] + [params[k] for k in ("cross_layers",
                                                           "shared")
                                       if k in params]
        for lay in stacks:
            attn = lay.get("attn", {})
            for n, real in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
                if n in attn:
                    attn[n] = _seeded(rng, attn[n], 0.5, real)
            for n in ("ln1_b", "ln2_b"):
                if n in lay:
                    lay[n] = _seeded(rng, lay[n], 0.3)
            for n in ("b_up", "b_down"):
                if n in lay.get("mlp", {}):
                    lay["mlp"][n] = _seeded(rng, lay["mlp"][n], 0.3)
        if "ln_f_b" in params:
            params["ln_f_b"] = _seeded(rng, params["ln_f_b"], 0.3)
        if is_vlm(case):
            cross = params["cross_layers"]
            cross["attn"]["gate"] = torch.full_like(cross["attn"]["gate"],
                                                    GATE)
            cross["gate_ffn"] = torch.full_like(cross["gate_ffn"], GATE_FFN)
        if cfg.is_moe:
            moe = params["layers"]["moe"]
            moe["router"] = _seeded(rng, moe["router"],
                                    1 / np.sqrt(cfg.d_model))
            moe["owner"], moe["share"] = expert_identity(cfg.n_experts,
                                                         cfg.n_layers)
        if cfg.family == "hybrid":
            for leaf, draw in SEEDED["zamba2"].items():
                params["layers"][leaf] = torch.from_numpy(draw(
                    rng, tuple(params["layers"][leaf].shape)).astype(
                        np.float32))
        save_tree(out / f"{case}.npz", params)
        weights[case] = load_tree(out / f"{case}.npz")
    return weights


def _jax_cfg(case):
    from repro.configs import get_config as jax_get_config
    return jax_get_config(arch_of(case)).with_overrides(**overrides(case))


def write_reference_logits(out, weights, cases):
    """The JAX package's lock-step logits of each case on its own
    ``quantize_params`` of the float32 weights (its plain path; prefill
    and decode compiled once a case), and mixtral's cacheless logits and
    aux loss, dense and capacity dispatch; written whole, for ranks that
    wait for the file."""
    import jax
    import jax.numpy as jnp
    from repro.models.api import build_model as jax_build_model
    from repro.models.quantization import quantize_params
    def lockstep(case, pj):
        model = jax_build_model(_jax_cfg(case), tp=tp_of(case))
        prefill, step = (jax.jit(f, donate_argnums=(1,))
                         for f in (model.prefill, model.decode_step))
        kw = {}
        if is_vlm(case):
            img, mask = images(B)
            kw = dict(img_embeds=jnp.asarray(img),
                      img_mask=jnp.asarray(mask))
        state = model.init_decode_state(pj, B, T_MAX, **kw)
        got, state = prefill(pj, state, jnp.asarray(tokens()))
        got = [got]
        for _ in range(STEPS):
            nxt, state = step(pj, state,
                              jnp.argmax(got[-1], -1).astype(jnp.int32))
            got.append(nxt)
        return {case: np.asarray(jnp.stack(got))}

    def forward(case, pj, cap):
        fwd = jax.jit(jax_build_model(_jax_cfg(case), tp=tp_of(case),
                                      capacity_moe=cap).forward)
        logits, aux = fwd(pj, jnp.asarray(tokens(FORWARD_S)))
        return {f"{case} forward {cap}": np.asarray(logits),
                f"{case} forward {cap} aux": np.asarray(aux)}

    ref = {}
    for case in cases:
        pj = quantize_params(jax.tree.map(jnp.asarray, weights[case]))
        ref.update(lockstep(case, pj))
        if _jax_cfg(case).is_moe:
            ref.update(forward(case, pj, False))
            ref.update(forward(case, pj, True))
    np.savez(out / "ref_tmp.npz", **ref)
    os.replace(out / "ref_tmp.npz", out / "ref.npz")


def engine_expectations(weights, cases):
    """The JAX package's paged engine (its plain path) and the unsharded
    port's (the kernels' plain versions) on each run's weights and
    traffic: streams, admission and migration logs, and the port's
    waits (the reference engine counts none)."""
    import jax
    import jax.numpy as jnp
    from repro.core.network import DeviceNetwork as JaxNetwork
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.weights import params_from_jax
    expect = {}
    for case in cases:
        ref = JaxEngine(_jax_cfg(case), net=network(JaxNetwork),
                        **engine_kw(case))
        ref.params = jax.tree.map(jnp.asarray, weights[case])
        port = ServingEngine(port_cfg(case), use_kernel=True, device="cpu",
                             net=network(DeviceNetwork),
                             params=params_from_jax(weights[case], "cpu"),
                             **engine_kw(case))
        expect[case] = {
            "reference": drive(ref), "port": drive(port),
            "reference log": log_of(ref), "port log": log_of(port),
            "reference admissions": admissions_of(ref),
            "port admissions": admissions_of(port),
            "port waits": port.page_waits}
    return expect


def replay_pools(dp, kv_pages):
    """The admissions and retires of the run's traffic replayed on the
    host through one ``PagedKVAllocator`` a batch rank, by the engine's
    rule written out here: each step admits the queue head into the
    lowest free slot while that slot's rank's pool can reserve its
    horizon (else that rank waits, and admission stops for the step),
    then every live slot writes its next position (a page drawn at a page
    boundary) and emits a token, and a slot that reached its budget or
    the cache's edge retires.  ``dp`` batch ranks share ``kv_pages``
    pages.  Returns (waits by rank, admissions [step, slot, rid, bucket,
    pages])."""
    from repro_torch.serving.paging import PagedKVAllocator
    n, seq = ENGINE["n_slots"], ENGINE["max_seq"]
    per = n // dp
    pools = [PagedKVAllocator(kv_pages // dp, PAGE, per, seq // PAGE)
             for _ in range(dp)]
    queue = [(i, len(p), max_new(i)) for i, p in enumerate(prompts())]
    slots = [None] * n              # [rid, prompt length, budget, emitted]
    waits, admitted, step = [0] * dp, [], 0

    def done(s):
        _, L0, budget, k = slots[s]
        if k >= budget or L0 + k >= seq - 1:
            b, r = divmod(s, per)
            pools[b].release(r)
            slots[s] = None

    while True:
        while queue and None in slots:
            s = slots.index(None)
            b, r = divmod(s, per)
            rid, L0, budget = queue[0]
            horizon = min(L0 + budget + 1, seq)
            if not pools[b].can_admit(L0, horizon):
                waits[b] += 1
                break
            queue.pop(0)
            pages = pools[b].admit(r, n_tokens=L0, horizon=horizon)
            slots[s] = [rid, L0, budget, 1]
            admitted.append([step, s, rid, PAGE, len(pages)])
            done(s)
        live = [s for s in range(n) if slots[s] is not None]
        if not live:
            break
        for s in live:
            b, r = divmod(s, per)
            write = slots[s][1] + slots[s][3] - 1
            if write >= pools[b].pages_for(r) * PAGE:
                pools[b].extend(r, write + 1)
        step += 1
        for s in live:
            slots[s][3] += 1
            done(s)
    return waits, admitted


def start_ranks(tmp_path_factory, kind, cases, fault, timeout=240):
    """The ranks run ``cases`` of ``kind`` ("int8" or "paged") and plant
    the fault in case ``fault`` (one subprocess, ``timeout`` s at most),
    while this process computes the reference's logits (int8) or serves
    the same traffic on the reference and unsharded engines (paged).
    Returns (the expectations, {report key: one value a rank})."""
    out = tmp_path_factory.mktemp(f"{kind}_shard")
    weights = write_weights(out, cases)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), str(REPO)]), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, str(out), kind, fault,
                             *cases],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        expect = {}
        if kind == "int8":
            write_reference_logits(out, weights, cases)
        else:
            expect = engine_expectations(
                weights, [c for c in cases if kv_pages_of(c) is None])
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    return expect, json.loads(stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:])


# ------------------------------------------------ what the tests assert
def expected_store(case):
    """{buffer: local shape} of a rank's page store: its pool of
    ``kv_pages / dp`` pages plus its sink, its KV rows over "model" —
    (L, kv_pages/dp + 1, P, KvE/tp, dh), int8 scales without dh."""
    from repro_torch.models.layers import head_dims
    cfg = port_cfg(case)
    hd = head_dims(cfg, tp_of(case))
    pages = kv_pages_of(case) or ENGINE["n_slots"] * ENGINE["max_seq"] // PAGE
    lead = [cfg.n_layers, pages // dp_of(case) + 1, PAGE,
            hd.KvE // tp_of(case)]
    out = {n: lead + [hd.dh] for n in ("k", "v")}
    if cfg.kv_quant:
        out.update({n: lead for n in ("k_sc", "v_sc")})
    return out


# ------------------------------------------- the tests, shared by the files
# The int8 files import these and define the fixtures they take: ``runs``
# (``start_ranks`` of their cases), ``case`` (one per case), ``logit_run``
# (case, use_kernel, against) and ``fault`` (the case holding the planted
# fault).

def test_int8_leaves_are_placed_as_param_spec_says(runs, case):
    """Every rank's ``q8`` and ``sc`` leaves are DTensors placed as
    ``param_shardings`` says, local int8 and float32 shards of
    ``param_spec``'s local shapes."""
    leaves = runs[1][f"int8 leaves {case}"]
    assert len(leaves) == WORLD and leaves[0][0] > 0
    assert all(n == leaves[0][0] and wrong == [] for n, wrong in leaves)


def test_dequantizing_a_placed_leaf_takes_no_collective(runs, case):
    """``quantization.wt`` of every placed int8 leaf dequantizes the
    rank's shard: ``CommDebugMode`` counts no collective on any rank."""
    assert runs[1][f"wt collectives {case}"] == [0] * WORLD


def test_sharded_int8_lockstep_logits_equal_unsharded(runs, logit_run):
    """Every rank's whole lock-step prefill and per-step decode logits on
    the placed int8 weights (a VLM's over images that fill, half fill and
    leave empty a row's buffer), with and without the kernels' plain
    versions, against the unsharded port on the same int8 weights and
    the JAX package's model on its own ``quantize_params``: ``TOL``,
    Zamba2's ``ZAMBA2_TOL``."""
    case, uk, against = logit_run
    tol = ZAMBA2_TOL if arch_of(case) == "zamba2-2.7b" else TOL
    gaps = runs[1][f"logits {case} kernel={uk} vs {against}"]
    assert len(gaps) == WORLD and max(gaps) <= tol, gaps


def test_the_planted_int8_fault_is_caught(runs, fault):
    """Each rank quantizing its own shard (its scales from its shard's
    absmax) moves the logits far past ``TOL``: the lock-step test would
    fail it."""
    gaps = runs[1][f"fault {fault}"]
    assert len(gaps) == WORLD and min(gaps) > 100 * TOL, gaps
