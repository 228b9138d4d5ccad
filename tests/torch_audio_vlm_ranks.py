"""The audio and VLM families on a DeviceMesh: the four gloo ranks and the
parent's expectations behind ``tests/test_torch_audio_shard.py``
(musicgen-large) and ``tests/test_torch_vlm_shard.py``
(llama-3.2-vision-11b).

Each test file starts four CPU ranks over gloo in one subprocess (its own
timeout) for its cases; the parent writes each case's weights — the
port's init at the case's tp from seed 0, with the leaves the reference's
init leaves at zero seeded nonzero in both packages (``bq``/``bk``/``bv``,
musicgen's LayerNorm biases ``ln1_b``/``ln2_b``/``ln_f_b`` and MLP biases
``b_up``/``b_down``; the VLM's cross-attention ``gate`` 0.7 and
``gate_ffn`` 0.5): zero inits would hide a bias added on every rank or a
cross layer read from the wrong shard — and while the ranks run computes
what they are held to: the JAX package's lock-step logits (jitted once a
case) and the JAX package's and the unsharded port engine's streams and
migration logs.  On ("data", "model") meshes (1, 4) and (2, 2) every rank
checks and reports, for a float32 reduced model:
- lock-step ``prefill`` and per-step ``decode_step`` logits, with and
  without the kernels' plain versions (an int8 cache: with them), against
  the unsharded port's and the JAX package's; the local shapes of the
  cache and image K/V shards and whether every decode step kept them;
  the cacheless ``forward``'s logits against the unsharded port's;
- ``make_engine("auto", part=...)``: the engine's type, its greedy streams
  under a 500x straggler at step 4 (a VLM request carries an image that
  fills, half fills or leaves empty its slot's buffer), its migration log,
  the KV rows and bytes each applied migration sent, against the rows
  whose rank the plan changes (counted here from the plan, independently
  of the exchange), and whether the cache and image K/V shards kept their
  storage over every decode step;
- a planted fault (musicgen: ``b_down`` added on every rank's partial sum;
  the VLM: a cross layer's ``wo`` output taken as the whole, without the
  reduction over "model"), run through the lock-step logits: the gap the
  tests must see above their bound.

The worker imports no JAX.  ``python tests/torch_audio_vlm_ranks.py <dir>
<fault case> <case> ...`` runs the ranks by hand once the parent has
written ``<dir>``'s weights and ``ref.npz``.  The tests themselves are at
the end, shared by the test files: each imports them and gives them its
``runs``, ``case``, ``case_uk`` and ``fault`` fixtures.
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
B, PROMPT, STEPS, T_MAX = 4, 8, 3, 16      # lock-step logits
PROMPT_LENS = (5, 11, 8, 14, 6)            # engine traffic
ENGINE = dict(n_slots=B, max_seq=64, lam=3, seed=0)
STRAGGLE_AT = 4
I_IMG = 8
# a request's image rows: all of the buffer, half of it, none
IMG_ROWS = (I_IMG, I_IMG // 2, 0)
GATE, GATE_FFN = 0.7, 0.5

TOL = 1e-5
# an int8 cache's logits (the shared tests' doc)
INT8_TOL = 1e-3

MESHES = {"(1, 4)": (1, 4), "(2, 2)": (2, 2)}
BASE = dict(d_model=64, d_ff=128, vocab_size=97, dtype="float32",
            param_dtype="float32", n_heads=8, d_head=8, qkv_bias=True)
# case -> (arch, overrides, mesh name); tp is the mesh's "model" degree
CASES = {
    "musicgen (1, 4)": ("musicgen-large", dict(n_layers=2, n_kv_heads=8),
                        "(1, 4)"),
    "musicgen (2, 2)": ("musicgen-large", dict(n_layers=2, n_kv_heads=8),
                        "(2, 2)"),
    # 8 q over 4 KV heads: one KV row a rank at tp 4, no replication
    "vlm kv 4 (1, 4)": ("llama-3.2-vision-11b",
                        dict(n_layers=5, n_kv_heads=4), "(1, 4)"),
    "vlm kv 4 (2, 2)": ("llama-3.2-vision-11b",
                        dict(n_layers=5, n_kv_heads=4), "(2, 2)"),
    # 8 q over 2 KV heads: each KV head replicated twice (rep 2) at tp 4
    "vlm kv 2 (1, 4)": ("llama-3.2-vision-11b",
                        dict(n_layers=5, n_kv_heads=2), "(1, 4)"),
    "vlm kv 2 int8 (1, 4)": ("llama-3.2-vision-11b",
                             dict(n_layers=5, n_kv_heads=2, kv_quant=True),
                             "(1, 4)"),
}
# the simulated network's seed (1 unless named): seed 1's network moves no
# group of four query heads (8 over 2 KV heads) under the straggler;
# seed 2's moves one
NET_SEED = {"vlm kv 2 (1, 4)": 2, "vlm kv 2 int8 (1, 4)": 2}
LOG_KEYS = ("step", "n_migrations", "mig_bytes", "applied", "reason")


def overrides(case):
    return {**BASE, **CASES[case][1]}


def port_cfg(case):
    from repro_torch.configs import get_config
    return get_config(CASES[case][0]).with_overrides(**overrides(case))


def is_vlm(case):
    return CASES[case][0] == "llama-3.2-vision-11b"


def tp_of(case):
    return MESHES[CASES[case][2]][1]


def quant(case):
    return bool(CASES[case][1].get("kv_quant"))


def tokens():
    return np.random.default_rng(1).integers(0, 97, (B, PROMPT)).astype(
        np.int32)


def images(n, seed=4):
    """``n`` image buffers (n, I_IMG, D) and right-padded masks, row b
    holding ``IMG_ROWS[b % 3]`` valid rows (0: a fully masked row)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, I_IMG, BASE["d_model"])).astype(
        np.float32)
    mask = np.zeros((n, I_IMG), bool)
    for b in range(n):
        mask[b, :IMG_ROWS[b % 3]] = True
    return img, mask


def requests(case):
    """The engine's prompts and, for a VLM, each request's image (None
    for an empty one)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=n) for n in PROMPT_LENS]
    if not is_vlm(case):
        return prompts, [None] * len(prompts)
    img, mask = images(len(prompts), seed=6)
    return prompts, [img[i, :mask[i].sum()] if mask[i].any() else None
                     for i in range(len(prompts))]


def drive(eng, case):
    """Every request submitted, then scheduler steps to the end with a
    500x straggler landing at step 4 on the device holding most heads.
    Returns {rid: tokens}."""
    for i, (p, img) in enumerate(zip(*requests(case))):
        kw = {} if img is None else dict(img_embeds=img)
        eng.submit(p, max_new_tokens=7 + 2 * (i % 2), **kw)
    while True:
        if eng.decode_steps == STRAGGLE_AT:
            dev = int(eng.controller.head_counts().argmax())
            eng.net.inject_straggler(dev, slowdown=500.0)
        if not eng.step():
            break
    return {str(r.rid): [int(t) for t in r.out_tokens] for r in eng.finished}


def log_of(eng):
    return [[e[k] for k in LOG_KEYS] for e in eng.migration_log]


def network(case, package):
    """The case's simulated device network, from ``package``'s
    ``DeviceNetwork`` (the port's or the JAX package's)."""
    return package.sample(4, seed=NET_SEED.get(case, 1))


def engine_kw(case):
    kw = dict(ENGINE, tp=tp_of(case))
    if is_vlm(case):
        # one column a head: a plan is one layout for every layer, which
        # the VLM's (G, 4) stacks take
        kw.update(img_tokens=I_IMG, layer_mode="columns")
    return kw


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
def _placed(params, cfg, mesh):
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.models.partitioning import place
    from repro_torch.tree import flatten, map_with_path
    sh = flatten(param_shardings(params, cfg, mesh))
    return map_with_path(lambda p, v: place(v.clone(), sh[p]), params)


def _buffers(state):
    """{name: local tensor} of a state's cache and image K/V shards."""
    from repro_torch.models.partitioning import local
    out = {f"cache/{n}": local(t) for n, t in state["cache"].items()}
    out.update({f"img_kv/{n}": local(t)
                for n, t in state.get("img_kv", {}).items()})
    return out


def _init_state(model, params, case, batch, max_seq):
    kw = {}
    if is_vlm(case):
        img, mask = images(batch)
        kw = dict(img_embeds=torch.from_numpy(img),
                  img_mask=torch.from_numpy(mask))
    return model.init_decode_state(params, batch, max_seq, **kw)


def _lockstep(model, params, case, first):
    """Lock-step prefill then STEPS decode steps fed ``first``'s greedy
    tokens; the logits of every call, stacked, the final state and
    whether every decode step kept each shard's storage."""
    state = _init_state(model, params, case, B, T_MAX)
    out, state = model.prefill(params, state, torch.from_numpy(tokens()))
    logits, kept = [out], True
    for s in range(STEPS):
        before = {k: t.data_ptr() for k, t in _buffers(state).items()}
        nxt = torch.from_numpy(first[s].argmax(-1).astype(np.int32))
        out, state = model.decode_step(params, state, nxt)
        kept &= before == {k: t.data_ptr()
                           for k, t in _buffers(state).items()}
        logits.append(out)
    return torch.stack(logits), state, kept


def _check_logits(report, case, mesh, params, placed, ref):
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner, whole
    cfg, tp = port_cfg(case), tp_of(case)
    want = ref[case]
    for uk in ((True,) if quant(case) else (False, True)):
        label = f"{case} kernel={uk}"
        if not quant(case):
            # the cacheless forward (a VLM's image K/V projected and placed
            # in the call), whole logits at every position
            kw = {}
            if is_vlm(case):
                img, mask = images(B)
                kw = dict(img_embeds=torch.from_numpy(img),
                          img_mask=torch.from_numpy(mask))
            toks = torch.from_numpy(tokens())
            plain, _ = build_model(cfg, tp=tp, use_kernel=uk,
                                   device="cpu").forward(params, toks, **kw)
            got, _ = build_model(cfg, tp=tp, use_kernel=uk, device="cpu",
                                 part=make_partitioner(mesh)).forward(
                placed, toks, **kw)
            report[f"forward {label}"] = \
                (whole(got) - plain).abs().max().item()
        plain, whole_state, _ = _lockstep(
            build_model(cfg, tp=tp, use_kernel=uk, device="cpu"), params,
            case, want)
        got, state, kept = _lockstep(
            build_model(cfg, tp=tp, use_kernel=uk, device="cpu",
                        part=make_partitioner(mesh)),
            placed, case, want)
        report[f"logits {label} vs port"] = (got - plain).abs().max().item()
        report[f"logits {label} vs reference"] = \
            (got - torch.from_numpy(want)).abs().max().item()
        report[f"shards {label}"] = {k: list(t.shape) for k, t in
                                     _buffers(state).items()}
        report[f"in place {label}"] = kept
        if quant(case):
            # int8 values: how many of the rank's differ from its chunk of
            # the unsharded cache, and by how many steps at most
            diff = [(_chunk(whole_state["cache"][n], state["cache"][n])
                     .int() - _buffers(state)[f"cache/{n}"].int()).abs()
                    for n in ("k", "v")]
            report[f"int8 cache {label}"] = [
                int(sum((d > 0).sum() for d in diff)),
                int(max(d.max() for d in diff)),
                int(sum(d.numel() for d in diff))]


def _chunk(whole, dt):
    """The rank's chunk of ``whole``, cut as DTensor ``dt`` is placed."""
    from repro_torch.models.partitioning import Sharding, local_extent
    for d, (lo, n) in enumerate(local_extent(dt.shape, Sharding(
            dt.device_mesh, tuple(dt.placements)))):
        whole = whole.narrow(d, lo, n)
    return whole


def _faulty_mlp(inner):
    """``layers.mlp_block`` with ``b_down`` added on every rank's partial
    sum of ``h @ w_down`` before the reduction over "model"."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor
    from repro_torch.models.partitioning import NULL, is_dtensor, local

    def mlp_block(cfg, p, x, *, part=NULL):
        if cfg.mlp_type != "gelu" or not is_dtensor(x):
            return inner(cfg, p, x, part=part)
        h = F.gelu(x @ p["w_up"].to(x.dtype) + p["b_up"].to(x.dtype),
                   approximate="tanh")
        h = part.constrain(h, ("batch", "seq", "d_ff"))
        out = h @ p["w_down"].to(x.dtype)
        out = DTensor.from_local(local(out) + local(p["b_down"]),
                                 out.device_mesh, out.placements,
                                 run_check=False)
        return part.constrain(out, ("batch", "res_seq", "d_model"))
    return mlp_block


def _faulty_project_out(inner):
    """``layers._project_out`` whose gated (cross-attention) output is the
    rank's own heads' ``wo`` product taken as the whole, with no
    reduction over "model"."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.partitioning import NULL, is_dtensor, local

    def project_out(p, out, *, gate=None, part=NULL):
        if gate is None or not is_dtensor(out):
            return inner(p, out, gate=gate, part=part)
        y = torch.einsum("bshk,hkd->bsd", local(out),
                         local(p["wo"]).to(out.dtype))
        y = y * torch.tanh(local(gate)).to(y.dtype)
        return DTensor.from_local(
            y, out.device_mesh,
            part.placements(("batch", "res_seq", "d_model")),
            run_check=False)
    return project_out


def _check_fault(report, case, mesh, params, placed, ref):
    """The lock-step logits with the family's planted fault, against the
    unsharded port's: the gap the tests' bound must catch."""
    from repro_torch.models import layers as L
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner
    cfg, tp = port_cfg(case), tp_of(case)
    name = "_project_out" if is_vlm(case) else "mlp_block"
    inner = getattr(L, name)
    plain, _, _ = _lockstep(build_model(cfg, tp=tp, use_kernel=True,
                                        device="cpu"), params, case,
                            ref[case])
    setattr(L, name, (_faulty_project_out if is_vlm(case)
                      else _faulty_mlp)(inner))
    try:
        got, _, _ = _lockstep(build_model(cfg, tp=tp, use_kernel=True,
                                          device="cpu",
                                          part=make_partitioner(mesh)),
                              placed, case, ref[case])
    finally:
        setattr(L, name, inner)
    report[f"fault {case}"] = (got - plain).abs().max().item()


def _check_engine(report, case, mesh, placed):
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.core.placement_bridge import relative_perms
    from repro_torch.models.partitioning import make_partitioner
    from repro_torch.serving.engine import make_engine
    eng = make_engine(port_cfg(case), mode="auto",
                      part=make_partitioner(mesh), use_kernel=True,
                      device="cpu", net=network(case, DeviceNetwork),
                      params=placed, **engine_kw(case))
    report[f"engine type {case}"] = type(eng).__name__
    hd = eng.model.hd
    coord, ranks = mesh.get_coordinate()[1], mesh.size(1)
    want_sent = []
    inner = eng._migrate_state

    def migrate(state, plan, *a, **kw):
        applied, reason = inner(state, plan, *a, **kw)
        if applied:
            rel = relative_perms(plan["prev_perms"], plan["perms"])
            if is_vlm(case):
                want_sent.append(_expected_sent_vlm(
                    rel[:1], state, hd, coord, ranks))
            else:
                want_sent.append(_expected_sent_layers(
                    np.broadcast_to(rel, (eng.cfg.n_layers, rel.shape[1])),
                    state["cache"], hd, coord, ranks))
        return applied, reason

    eng._migrate_state = migrate
    ptrs = []
    step = eng.model.decode_step

    def decode_step(params, state, toks):
        ptrs.append(sorted((k, t.data_ptr())
                           for k, t in _buffers(state).items()))
        out, state = step(params, state, toks)
        ptrs.append(sorted((k, t.data_ptr())
                           for k, t in _buffers(state).items()))
        return out, state

    eng.model.decode_step = decode_step
    report[f"streams {case}"] = drive(eng, case)
    report[f"log {case}"] = log_of(eng)
    report[f"sent {case}"] = [[e["kv_rows"], e["kv_bytes"]]
                              for e in eng.exchange_log]
    report[f"weights sent {case}"] = [e["weight_rows"]
                                      for e in eng.exchange_log]
    report[f"expected sent {case}"] = [list(w) for w in want_sent]
    report[f"engine shards {case}"] = {k: list(t.shape) for k, t in
                                       _buffers(eng.state).items()}
    # every decode step, across migrations too, sees the same storage
    report[f"storages {case}"] = len({json.dumps(p) for p in ptrs})
    report[f"decode steps {case}"] = len(ptrs) // 2


def _expected_sent_layers(rel, cache, hd, coord, ranks):
    """``_crossing_bytes`` of a (L, ...) cache: plan rows (L, Hp)."""
    return _crossing_bytes(rel, hd, coord, ranks,
                           [(n, t, t.shape[0]) for n, t in cache.items()])


def _expected_sent_vlm(rel, state, hd, coord, ranks):
    """``_crossing_bytes`` of the VLM: the one plan row over every (G, 4)
    cell of the self layers' cache and every G cell of the image K/V."""
    bufs = [(n, t, t.shape[0] * t.shape[1])
            for n, t in state["cache"].items()]
    bufs += [(n, t, t.shape[0]) for n, t in state["img_kv"].items()]
    return _crossing_bytes(rel, hd, coord, ranks, bufs)


def _crossing_bytes(rel, hd, coord, ranks, bufs):
    """The KV rows this rank sends by the query-head plan ``rel`` (one row
    for every cell, or one a cell), and their bytes, from the plan alone:
    the expanded KV rows of its chunk that land in another rank's chunk,
    in every cell of every buffer (values and int8 scales, the image
    K/V), each at its buffer's local row bytes.  The plan's expanded KV
    rows are worked out here, not by the engine's helpers: new expanded
    row e serves the query heads of new positions [(e // rep)·G, ...), so
    it holds replica ``e % rep`` of the old KV head of the query head now
    first among them, ``rel[l, (e // rep)·G] // G``."""
    from repro_torch.models.partitioning import local
    G = hd.Hp // hd.Kp
    rel = np.atleast_2d(np.asarray(rel))
    e = np.arange(hd.KvE)
    kv = rel[:, e // hd.rep * G] // G * hd.rep + e % hd.rep
    n = kv.shape[1] // ranks
    # crossing rows of each plan row (one row: the same for every cell)
    per_row = ((kv // n == coord)
               & (np.arange(kv.shape[1])[None] // n != coord)).sum(-1)
    rows = nbytes = 0
    for name, t, cells in bufs:
        loc = local(t)
        axis = -1 if name.endswith("_sc") else -2
        row_bytes = loc.numel() // (cells * loc.shape[axis]) \
            * loc.element_size()
        crossing = int(per_row.sum()) if len(per_row) == cells \
            else int(per_row[0]) * cells
        rows += crossing
        nbytes += crossing * row_bytes
    return rows, nbytes


def _worker(rank, port, out, fault, cases):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.weights import params_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    out = Path(out)
    report = {}
    try:
        meshes, runs = {}, {}
        for case in cases:
            shape = MESHES[CASES[case][2]]
            if shape not in meshes:
                meshes[shape] = make_debug_mesh(*shape, device_type="cpu")
            params = params_from_jax(load_tree(out / f"{case}.npz"), "cpu")
            runs[case] = (meshes[shape], params)
        for case, (mesh, params) in runs.items():
            _check_engine(report, case, mesh,
                          _placed(params, port_cfg(case), mesh))
        # the parent writes the reference's logits while the engines run
        for _ in range(2400):
            if (out / "ref.npz").exists():
                break
            time.sleep(0.1)
        ref = dict(np.load(out / "ref.npz"))
        for case, (mesh, params) in runs.items():
            placed = _placed(params, port_cfg(case), mesh)
            _check_logits(report, case, mesh, params, placed, ref)
            if case == fault:
                _check_fault(report, case, mesh, params, placed, ref)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (out / f"report_{rank}.json").write_text(json.dumps(report))


def _main(out, fault, cases):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, out, fault, cases), nprocs=WORLD,
             join=True)
    reports = [json.loads(Path(out, f"report_{r}.json").read_text())
               for r in range(WORLD)]
    # {key: [rank 0's value, ..., rank 3's]}
    keys = sorted({k for r in reports for k in r})
    print(json.dumps({k: [r.get(k) for r in reports] for k in keys}))


# ----------------------------------------------------- the parent's part
def write_weights(out, cases):
    """Each case's weights — the port's init at its tp from seed 0, the
    biases seeded from seed 7 and the VLM's gates set — written for the
    ranks and returned as numpy trees."""
    from repro_torch.models.api import build_model
    weights = {}
    for case in cases:
        cfg = port_cfg(case)
        params = build_model(cfg, tp=tp_of(case), device="cpu").init(
            torch.Generator().manual_seed(0))
        rng = np.random.default_rng(7)
        stacks = [params["layers"]] + ([params["cross_layers"]]
                                       if is_vlm(case) else [])
        for lay in stacks:
            for n in ("bq", "bk", "bv"):
                lay["attn"][n] = _seeded(rng, lay["attn"][n], 0.5)
            for n in ("ln1_b", "ln2_b"):
                if n in lay:
                    lay[n] = _seeded(rng, lay[n], 0.3)
            for n in ("b_up", "b_down"):
                if n in lay["mlp"]:
                    lay["mlp"][n] = _seeded(rng, lay["mlp"][n], 0.3)
        if "ln_f_b" in params:
            params["ln_f_b"] = _seeded(rng, params["ln_f_b"], 0.3)
        if is_vlm(case):
            cross = params["cross_layers"]
            cross["attn"]["gate"] = torch.full_like(cross["attn"]["gate"],
                                                    GATE)
            cross["gate_ffn"] = torch.full_like(cross["gate_ffn"], GATE_FFN)
        save_tree(out / f"{case}.npz", params)
        weights[case] = load_tree(out / f"{case}.npz")
    return weights


def _seeded(rng, t, scale):
    return torch.from_numpy(scale * rng.standard_normal(tuple(t.shape))
                            ).to(t.dtype)


def _jax_cfg(case):
    from repro.configs import get_config as jax_get_config
    return jax_get_config(CASES[case][0]).with_overrides(**overrides(case))


def model_key(case):
    """What decides a case's unsharded model, engine and weights: its arch,
    overrides, head layout and network (two meshes whose tp lay the heads
    out alike share them)."""
    from repro_torch.models.layers import head_dims
    return (CASES[case][0], json.dumps(overrides(case), sort_keys=True),
            head_dims(port_cfg(case), tp_of(case)), NET_SEED.get(case, 1))


def _once(cases, run):
    """{case: run(case)}, ``run`` called once for the cases of each
    ``model_key``."""
    done, out = {}, {}
    for case in cases:
        key = model_key(case)
        if key not in done:
            done[key] = run(case)
        out[case] = done[key]
    return out


def write_reference_logits(out, weights, cases):
    """The JAX package's lock-step logits of each case (its plain path;
    an int8 cache's case too), prefill and decode compiled once each;
    written whole, for ranks that wait for the file."""
    import jax
    import jax.numpy as jnp
    from repro.models.api import build_model as jax_build_model

    def run(case):
        pj = jax.tree.map(jnp.asarray, weights[case])
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
        return np.asarray(jnp.stack(got))

    np.savez(out / "ref_tmp.npz", **_once(cases, run))
    os.replace(out / "ref_tmp.npz", out / "ref.npz")


def engine_expectations(weights, cases):
    """The JAX package's engine (its plain path) and the unsharded port
    engine (the kernels' plain versions) on each case's weights and
    traffic: streams and migration logs."""
    import jax
    import jax.numpy as jnp
    from repro.core.network import DeviceNetwork as JaxNetwork
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.weights import params_from_jax

    def run(case):
        ref = JaxEngine(_jax_cfg(case), net=network(case, JaxNetwork),
                        **engine_kw(case))
        ref.params = jax.tree.map(jnp.asarray, weights[case])
        port = ServingEngine(port_cfg(case), use_kernel=True, device="cpu",
                             net=network(case, DeviceNetwork),
                             params=params_from_jax(weights[case], "cpu"),
                             **engine_kw(case))
        return {"reference": drive(ref, case), "port": drive(port, case),
                "reference log": log_of(ref), "port log": log_of(port)}

    return _once(cases, run)


def start_ranks(tmp_path_factory, cases, fault, timeout=240):
    """The ranks run ``cases``, and plant their family's fault in case
    ``fault`` (one subprocess, ``timeout`` s at most), while this process
    computes the reference's logits and serves the same traffic on the
    reference and unsharded engines.  Returns (the expectations, {report
    key: one value a rank})."""
    out = tmp_path_factory.mktemp("audio_vlm_shard")
    weights = write_weights(out, cases)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), str(REPO)]), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, str(out), fault,
                             *cases],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        write_reference_logits(out, weights, cases)
        expect = engine_expectations(weights, cases)
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    return expect, json.loads(stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2], sys.argv[3:])


# ------------------------------------------------ what the tests assert
def expected_shards(case, T):
    """{buffer: local shape} of a rank: batch rows over "data", expanded
    KV rows over "model" — musicgen's cache (L, B/dp, T, KvE/tp, dh), the
    VLM's (G, 4, B/dp, T, KvE/tp, dh) (int8: and scales without dh) and
    its image K/V (G, B/dp, I, KvE/tp, dh)."""
    from repro_torch.models.layers import head_dims
    dp, tp = MESHES[CASES[case][2]]
    cfg = port_cfg(case)
    hd = head_dims(cfg, tp)
    # the engine's slots and the lock-step batch are both B rows
    b, kv = B // dp, hd.KvE // tp
    if not is_vlm(case):
        lead = [cfg.n_layers]
    else:
        lead = [cfg.n_layers // 5, 4]
    out = {f"cache/{n}": lead + [b, T, kv, hd.dh] for n in ("k", "v")}
    if quant(case):
        out.update({f"cache/{n}": lead + [b, T, kv]
                    for n in ("k_sc", "v_sc")})
    if is_vlm(case):
        out.update({f"img_kv/{n}": [lead[0], b, I_IMG, kv, hd.dh]
                    for n in ("k", "v")})
    return out


def kernel_runs(cases):
    """(case, use_kernel) of the lock-step runs: an int8 cache's with the
    kernels' plain versions only (as the dense family's sharded tests)."""
    return [(c, uk) for c in cases for uk in ((True,) if quant(c)
                                              else (False, True))]


# ------------------------------------------- the tests, shared by the files
# Each test file imports these and defines the fixtures they take: ``runs``
# (``start_ranks`` of its cases), ``case`` (one per case), ``case_uk`` (one
# per ``kernel_runs`` entry) and ``fault`` (the case holding the planted
# fault).  An int8 cache rounds each K/V value to one of 255 steps, so the
# last-bit differences of the sharded reductions (the partial sums of
# ``wo`` and ``w_down`` over "model") can move a value across a rounding
# boundary: in the VLM's int8 case one of the cache's 16384 values does (by
# one step), which moves the logits by 2.6e-4.  Its logits are held to
# ``INT8_TOL``, its cache to at most one value in a thousand off by one
# step; every float32 case's logits to ``TOL``.

def test_sharded_lockstep_logits_equal_unsharded(runs, case_uk):
    """Every rank's whole lock-step prefill and per-step decode logits
    (a VLM's over images that fill, half fill and leave empty a row's
    buffer), with and without the kernels' plain versions, against the
    unsharded port's and the JAX package's on the same weights; and the
    cacheless forward's at every position against the unsharded
    port's."""
    case, uk = case_uk
    tol = INT8_TOL if quant(case) else TOL
    for against in ("port", "reference"):
        gaps = runs[1][f"logits {case} kernel={uk} vs {against}"]
        assert len(gaps) == WORLD and max(gaps) <= tol, (against, gaps)
    if not quant(case):
        # the cacheless forward at every position, against the port's
        gaps = runs[1][f"forward {case} kernel={uk}"]
        assert len(gaps) == WORLD and max(gaps) <= TOL, ("forward", gaps)


def test_shards_are_local_and_written_in_place(runs, case_uk):
    """Each rank's cache shard is (lead, B/dp, T, KvE/tp, dh) (int8 scales
    alike), a VLM's image K/V shard (G, B/dp, I, KvE/tp, dh); every
    decode step wrote them in place; an int8 cache's values equal the
    rank's chunk of the unsharded port's but for at most one in a
    thousand, off by one step."""
    case, uk = case_uk
    assert runs[1][f"shards {case} kernel={uk}"] == \
        [expected_shards(case, T_MAX)] * WORLD
    assert runs[1][f"in place {case} kernel={uk}"] == [True] * WORLD
    if quant(case):
        for n_diff, most, n in runs[1][f"int8 cache {case} kernel={uk}"]:
            assert most <= 1 and n_diff <= n // 1000, (n_diff, most, n)


def test_sharded_engine_streams_equal_unsharded(runs, case):
    """``make_engine("auto", part=...)`` builds the continuous engine (no
    fallback to the wave engine), and every rank streams the unsharded
    port engine's and the JAX package's engine's greedy tokens under a
    straggler (a VLM's requests carrying full, half and no images)."""
    assert runs[1][f"engine type {case}"] == ["ServingEngine"] * WORLD
    for against in ("port", "reference"):
        want = runs[0][case][against]
        assert len(want) == len(PROMPT_LENS)
        assert runs[1][f"streams {case}"] == [want] * WORLD, against


def test_migration_logs_equal_and_applied(runs, case):
    """Every rank logs the unsharded engine's plans, equal to the JAX
    package's, at least one of them an applied head migration."""
    logs = runs[1][f"log {case}"]
    assert logs == [runs[0][case]["port log"]] * WORLD
    assert runs[0][case]["port log"] == runs[0][case]["reference log"]
    assert any(e[1] and e[3] for e in logs[0])


def test_migrations_send_only_the_rows_that_change_rank(runs, case):
    """Per applied migration, each rank's sent KV rows and bytes — over
    the cache's values (and int8 scales) in every layer cell, and a VLM's
    image K/V in every cross layer — equal the rows of its chunk that the
    plan puts on another rank (counted from the plan); some KV rows and
    some weight rows do move."""
    sent = runs[1][f"sent {case}"]
    assert sent == runs[1][f"expected sent {case}"]
    assert sum(rows for per_rank in sent for rows, _ in per_rank) > 0
    assert sum(sum(w) for w in runs[1][f"weights sent {case}"]) > 0


def test_engine_shards_keep_their_storage(runs, case):
    """The engine's cache (and image K/V) shards are the rank's, and every
    decode step — across admissions, which write a slot's rows, and
    migrations, which permute them in place — sees one storage each."""
    assert runs[1][f"engine shards {case}"] == \
        [expected_shards(case, ENGINE["max_seq"])] * WORLD
    assert runs[1][f"storages {case}"] == [1] * WORLD
    assert min(runs[1][f"decode steps {case}"]) > STRAGGLE_AT


def test_the_planted_fault_is_caught(runs, fault):
    """The family's planted fault (module doc) moves the sharded logits
    far past ``TOL``: the lock-step test would fail it."""
    gaps = runs[1][f"fault {fault}"]
    assert len(gaps) == WORLD and min(gaps) > 100 * TOL, gaps
