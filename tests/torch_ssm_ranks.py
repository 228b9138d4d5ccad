"""The recurrent families on a DeviceMesh: the four gloo ranks and the
parent's expectations behind ``tests/test_torch_ssm_shard.py`` (RWKV-6)
and ``tests/test_torch_ssm_shard_zamba2.py`` (Zamba2: the Mamba-2 backbone
and the shared attention block).

Each test file starts four CPU ranks over gloo in one subprocess (its own
timeout) for one family; the parent writes the weights — the port's init
from seed 0, with the leaves the reference's init leaves at zero or one
seeded nonzero in both packages (RWKV-6's ``u``, ``lora_B``, ``lw_B`` and
``gn_bias``; every Mamba-2 layer's ``conv_b``, ``A_log``, ``dt_bias`` and
``D``): zero inits would hide a bonus, decay, bias or skip taken from the
wrong head — and while the ranks run computes what they are held to: the
JAX package's lock-step and cacheless logits (jitted once each), and the
JAX package's and the unsharded port engine's streams and migration logs.
On ("data", "model") meshes (1, 4) and (2, 2), every rank checks and
reports, for a float32 reduced model (the conftest's reductions; Zamba2
with SSM heads of 16 and a state of 8, so that its 8 SSM heads split over
4 ranks and the evenly cut ``w_in`` (280 columns) and conv channels (144)
fall across the (z, x, B, C, dt) and (x, B, C) boundaries as at full
width):
- lock-step ``prefill`` and per-step ``decode_step`` logits, with and
  without the kernels' plain versions, against the unsharded port's and
  the JAX package's, the state shards' local shapes and whether every
  decode step wrote them in place;
- the cacheless ``forward``'s logits against the same two;
- ``make_engine("auto", part=...)`` greedy streams under a straggler (the
  wave engine), its migration log and what it sent to other ranks, and
  the engine's state shards, written in place;
- one layer's output against the unsharded layer and the bytes its
  collectives carry.

The worker imports no JAX.  ``python tests/torch_ssm_ranks.py <dir>
<family> <mesh names>`` runs the ranks by hand once the parent has written
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
B, STEPS, T_MAX = 4, 4, 32          # lock-step logits
PROMPT = 12
WAVE_PROMPTS = (12, 6, 12, 6, 12, 6, 12, 6)
WAVE = dict(n_slots=4, max_seq=32, lam=3, seed=0)
WAVE_NEW = 10
STRAGGLE_AT = 4

# name -> (mesh shape, mesh dimension names); tp is the "model" degree
MESHES = {"data 1 model 4": ((1, 4), ("data", "model")),
          "data 2 model 2": ((2, 2), ("data", "model"))}
# family -> (arch, overrides of the conftest's reduced config's widths)
BASE = dict(d_model=64, d_ff=128, vocab_size=97, dtype="float32",
            param_dtype="float32", n_heads=4, d_head=16)
FAMILIES = {
    "rwkv6": ("rwkv6-7b", dict(n_layers=2)),
    "zamba2": ("zamba2-2.7b", dict(n_layers=4, shared_attn_every=2,
                                   n_kv_heads=4, ssm_head_dim=16,
                                   ssm_state=8)),
}
# the weights' seeded leaves: name -> draw from a numpy generator
SEEDED = {
    "rwkv6": {"u": lambda r, s: 0.5 * r.standard_normal(s),
              "lora_B": lambda r, s: 0.1 * r.standard_normal(s),
              "lw_B": lambda r, s: 0.5 * r.standard_normal(s),
              "gn_bias": lambda r, s: 0.3 * r.standard_normal(s)},
    "zamba2": {"conv_b": lambda r, s: 0.3 * r.standard_normal(s),
               # decays exp(-exp(A_log) dt) from near 1 to near 0
               "A_log": lambda r, s: r.permutation(np.linspace(
                   -6.0, 3.0, int(np.prod(s)))).reshape(s),
               "dt_bias": lambda r, s: 0.5 * r.standard_normal(s),
               "D": lambda r, s: 1.0 + 0.5 * r.standard_normal(s)},
}
# the engine's log: every plan is logged as not applied, with its reason
LOG_KEYS = ("step", "n_migrations", "mig_bytes", "applied", "reason",
            "n_expert_migrations", "expert_applied")
REASONS = {"rwkv6": "model has no addressable attention heads",
           "zamba2": "state has no addressable KV cache"}


def overrides(family):
    return {**BASE, **FAMILIES[family][1]}


def port_cfg(family):
    from repro_torch.configs import get_config
    return get_config(FAMILIES[family][0]).with_overrides(
        **overrides(family))


def tp_of(name):
    return MESHES[name][0][1]


def tokens(S, seed=0):
    return np.random.default_rng(seed).integers(0, 97, (B, S)).astype(
        np.int32)


def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 97, size=n) for n in WAVE_PROMPTS]


def drive(eng):
    """The wave traffic with a 500x straggler landing, from the token hook,
    on the device holding the most heads after decode step 4.  Returns
    {rid: tokens}."""
    fired = []

    def sink(req, tok, done):
        if not fired and eng.decode_steps == STRAGGLE_AT:
            dev = int(np.argmax(eng.controller.head_counts()))
            eng.net.inject_straggler(dev, slowdown=500.0)
            fired.append(True)

    eng.token_sink = sink
    for p in prompts():
        eng.submit(p, max_new_tokens=WAVE_NEW)
    eng.run()
    assert fired
    return {str(r.rid): [int(t) for t in r.out_tokens] for r in eng.finished}


def log_of(eng):
    return [[e[k] for k in LOG_KEYS] for e in eng.migration_log]


def engine(family, tp, **kw):
    from repro_torch.core.network import DeviceNetwork
    from repro_torch.serving.engine import make_engine
    return make_engine(port_cfg(family), mode="auto", use_kernel=True,
                       device="cpu", net=DeviceNetwork.sample(4, seed=1),
                       tp=tp, **WAVE, **kw)


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


def _state_leaves(state):
    """{path: local tensor} of a decode state's cache."""
    from repro_torch.models.partitioning import local
    from repro_torch.tree import flatten
    return {"/".join(p): local(t) for p, t in flatten(state["cache"]).items()
            if isinstance(t, torch.Tensor)}


def _lockstep(model, params, toks, first):
    """Lock-step prefill then STEPS decode steps fed ``first``'s greedy
    tokens; the logits of every call, stacked, the final state and
    whether every decode step kept each state shard's storage."""
    state = model.init_decode_state(params, B, T_MAX)
    out, state = model.prefill(params, state, toks)
    logits, kept = [out], True
    for s in range(STEPS):
        before = {k: t.data_ptr() for k, t in _state_leaves(state).items()}
        nxt = torch.from_numpy(first[s].argmax(-1).astype(np.int32))
        out, state = model.decode_step(params, state, nxt)
        kept &= before == {k: t.data_ptr()
                           for k, t in _state_leaves(state).items()}
        logits.append(out)
    return torch.stack(logits), state, kept


def _check_logits(report, family, name, mesh, params, placed, ref):
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner
    cfg, tp = port_cfg(family), tp_of(name)
    want = ref["lockstep"]
    toks = torch.from_numpy(tokens(PROMPT))
    for uk in (False, True):
        plain, _, _ = _lockstep(build_model(cfg, tp=tp, use_kernel=uk,
                                            device="cpu"),
                                params, toks, want)
        got, state, kept = _lockstep(
            build_model(cfg, tp=tp, use_kernel=uk, device="cpu",
                        part=make_partitioner(mesh)),
            placed, toks, want)
        label = f"{name} kernel={uk}"
        report[f"logits {label} vs port"] = (got - plain).abs().max().item()
        report[f"logits {label} vs reference"] = \
            (got - torch.from_numpy(want)).abs().max().item()
        report[f"state {label}"] = {k: list(t.shape) for k, t in
                                    _state_leaves(state).items()}
        report[f"in place {label}"] = kept
        plain, _ = build_model(cfg, tp=tp, use_kernel=uk,
                               device="cpu").forward(params, toks)
        got, _ = build_model(cfg, tp=tp, use_kernel=uk, device="cpu",
                             part=make_partitioner(mesh)).forward(placed,
                                                                  toks)
        report[f"forward {label}"] = [
            (got - plain).abs().max().item(),
            (got - torch.from_numpy(ref["forward"])).abs().max().item()]


def _spy_collectives(moved):
    """Wrap the collectives the layers call so that each records the bytes
    of this rank's tensor it carries; returns the undo."""
    import torch.distributed as dist
    inner = {n: getattr(dist, n) for n in ("all_gather", "all_reduce")}
    carried = {"all_gather": lambda out, t, **k: t,
               "all_reduce": lambda t, **k: t}

    def spy(n):
        def call(*a, **k):
            t = carried[n](*a, **k)
            moved.append(t.numel() * t.element_size())
            return inner[n](*a, **k)
        return call

    for n in inner:
        setattr(dist, n, spy(n))
    return lambda: [setattr(dist, n, f) for n, f in inner.items()]


def _check_layer(report, family, name, mesh, params, placed):
    """One recurrent layer on a one-token-a-row batch (a decode step) from
    a nonzero state, sharded, against the unsharded layer, with the bytes
    its collectives carry on this rank and the rank's weight shard."""
    from repro_torch.models.api import build_model
    from repro_torch.models.mamba2 import mamba_block, zero_mamba_state
    from repro_torch.models.partitioning import (head_shard, local,
                                                 make_partitioner)
    from repro_torch.models.transformer import _layer_view
    cfg, tp = port_cfg(family), tp_of(name)
    part = make_partitioner(mesh)
    shard = head_shard(part, B)
    lo, n = shard.rows
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    p_whole = _layer_view(params["layers"], (0, 0) if family == "zamba2"
                          else 0)
    p_mine = {k: local(v) for k, v in _layer_view(
        placed["layers"], (0, 0) if family == "zamba2" else 0).items()}
    g = torch.Generator().manual_seed(9)
    if family == "rwkv6":
        model = build_model(cfg, device="cpu")
        whole = model._zero_state(B, model.H, "cpu")
        whole = {k: 0.3 * torch.randn(t[0].shape, generator=g)
                 for k, t in whole.items()}
        hl, hn = shard.heads(model.H)
        mine = {k: t[lo:lo + n] for k, t in whole.items()}
        mine["wkv"] = mine["wkv"][:, hl:hl + hn]
        want, _ = model._layer(p_whole, x, whole, None, head_shard(
            make_partitioner(None), B))
        run = lambda: model._layer(p_mine, x[lo:lo + n], mine, None,  # noqa
                                   shard)[0]
    else:
        whole = {k: 0.3 * torch.randn(t.shape, generator=g)
                 for k, t in zero_mamba_state(cfg, B).items()}
        c0, cn = shard.span(whole["conv"].shape[-1])
        hl, hn = shard.heads(whole["ssm"].shape[1])
        mine = {"conv": whole["conv"][lo:lo + n, :, c0:c0 + cn],
                "ssm": whole["ssm"][lo:lo + n, hl:hl + hn]}
        want, _ = mamba_block(cfg, p_whole, x, whole)
        want = x + want
        run = lambda: x[lo:lo + n] + mamba_block(  # noqa: E731
            cfg, p_mine, x[lo:lo + n], mine, shard)[0]
    moved = []
    undo = _spy_collectives(moved)
    try:
        got = run()
    finally:
        undo()
    report[f"layer {name}"] = [
        (got - want[lo:lo + n]).abs().max().item(), sum(moved), len(moved),
        sum(t.numel() * t.element_size() for t in p_mine.values())]


def _check_engine(report, family, name, mesh, placed):
    from repro_torch.models.partitioning import make_partitioner
    eng = engine(family, tp_of(name), part=make_partitioner(mesh),
                 params=placed)
    run = f"{name}"
    report[f"engine type {run}"] = type(eng).__name__
    ptrs, shards, waves = [], set(), [0]
    step, prefill = eng.model.decode_step, eng.model.prefill

    def decode_step(params, state, toks):
        before = {k: t.data_ptr() for k, t in _state_leaves(state).items()}
        out, state = step(params, state, toks)
        after = {k: t.data_ptr() for k, t in _state_leaves(state).items()}
        ptrs.append((waves[0], sorted(before.items()), sorted(after.items())))
        shards.add(json.dumps({k: list(t.shape) for k, t in
                               sorted(_state_leaves(state).items())}))
        return out, state

    def wave_prefill(*a):
        waves[0] += 1
        return prefill(*a)

    eng.model.decode_step, eng.model.prefill = decode_step, wave_prefill
    report[f"streams {run}"] = drive(eng)
    report[f"log {run}"] = log_of(eng)
    report[f"sent {run}"] = list(eng.exchange_log)
    report[f"engine state {run}"] = sorted(json.loads(s) for s in shards)
    report[f"waves {run}"] = waves[0]
    # the decode steps of a wave all see the same storage
    report[f"moved storage {run}"] = sum(
        len({str(a[1]), str(a[2]), str(b[1]), str(b[2])}) > 1
        for a, b in zip(ptrs, ptrs[1:]) if a[0] == b[0])
    report[f"decode steps {run}"] = len(ptrs)


def _worker(rank, port, out, family, names):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.weights import params_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    out = Path(out)
    report = {}
    try:
        params = params_from_jax(load_tree(out / "weights.npz"), "cpu")
        cfg = port_cfg(family)
        cases = {}
        for name in names:
            shape, dims = MESHES[name]
            mesh = make_mesh(shape, dims, device_type="cpu")
            cases[name] = (mesh, _placed(params, cfg, mesh))
        for name, (mesh, placed) in cases.items():
            _check_layer(report, family, name, mesh, params, placed)
            _check_engine(report, family, name, mesh,
                          _placed(params, cfg, mesh))
        # the parent writes the reference's logits while the engines run
        for _ in range(2400):
            if (out / "ref.npz").exists():
                break
            time.sleep(0.1)
        ref = dict(np.load(out / "ref.npz"))
        for name, (mesh, placed) in cases.items():
            _check_logits(report, family, name, mesh, params, placed, ref)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (out / f"report_{rank}.json").write_text(json.dumps(report))


def _main(out, family, names):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, out, family, names), nprocs=WORLD,
             join=True)
    reports = [json.loads(Path(out, f"report_{r}.json").read_text())
               for r in range(WORLD)]
    # {key: [rank 0's value, ..., rank 3's]}
    keys = sorted({k for r in reports for k in r})
    print(json.dumps({k: [r.get(k) for r in reports] for k in keys}))


# ----------------------------------------------------- the parent's part
def write_weights(out, family):
    """The port's init from seed 0 with the family's ``SEEDED`` leaves
    drawn from seed 7, written for the ranks and returned as a numpy
    tree."""
    from repro_torch.models.api import build_model
    params = build_model(port_cfg(family), device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    lay = params["layers"]
    for leaf, draw in SEEDED[family].items():
        lay[leaf] = torch.from_numpy(draw(rng, tuple(lay[leaf].shape))
                                     .astype(np.float32))
    save_tree(out / "weights.npz", params)
    return load_tree(out / "weights.npz")


def _jax_cfg(family):
    from repro.configs import get_config as jax_get_config
    return jax_get_config(FAMILIES[family][0]).with_overrides(
        **overrides(family))


def write_reference_logits(out, weights, family):
    """The JAX package's lock-step logits (prefill, then STEPS decode
    steps fed its own greedy tokens) and its cacheless logits, each
    compiled once; written whole, for ranks that wait for the file."""
    import jax
    import jax.numpy as jnp
    from repro.models.api import build_model as jax_build_model
    pj = jax.tree.map(jnp.asarray, weights)
    model = jax_build_model(_jax_cfg(family))
    prefill = jax.jit(model.prefill, donate_argnums=(1,))
    step = jax.jit(model.decode_step, donate_argnums=(1,))
    state = model.init_decode_state(pj, B, T_MAX)
    got, state = prefill(pj, state, jnp.asarray(tokens(PROMPT)))
    got = [got]
    for _ in range(STEPS):
        nxt, state = step(pj, state,
                          jnp.argmax(got[-1], -1).astype(jnp.int32))
        got.append(nxt)
    logits, _ = jax.jit(model.forward)(pj, jnp.asarray(tokens(PROMPT)))
    np.savez(out / "ref_tmp.npz", lockstep=np.asarray(jnp.stack(got)),
             forward=np.asarray(logits))
    os.replace(out / "ref_tmp.npz", out / "ref.npz")


def engine_expectations(weights, family):
    """The JAX package's engine (its plain path) and the unsharded port
    engine (the kernels' plain versions) on the same weights and traffic:
    streams and migration logs."""
    import jax
    import jax.numpy as jnp
    from repro.core.network import DeviceNetwork as JaxNetwork
    from repro.serving.engine import make_engine as jax_make_engine
    from repro_torch.weights import params_from_jax
    ref = jax_make_engine(_jax_cfg(family), mode="auto",
                          net=JaxNetwork.sample(4, seed=1), **WAVE)
    ref.params = jax.tree.map(jnp.asarray, weights)
    port = engine(family, 1, params=params_from_jax(weights, "cpu"))
    return {"reference": drive(ref), "port": drive(port),
            "reference log": log_of(ref), "port log": log_of(port),
            "types": [type(ref).__name__, type(port).__name__]}


def start_ranks(tmp_path_factory, family, names=tuple(MESHES)):
    """The ranks run the meshes ``names`` (one subprocess, 240 s at most)
    while this process computes the reference's logits and serves the
    same traffic on the reference and unsharded engines.  Returns (the
    expectations, {report key: one value a rank})."""
    out = tmp_path_factory.mktemp(f"ssm_shard_{family}")
    weights = write_weights(out, family)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), str(REPO)]), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, str(out), family,
                             *names], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        write_reference_logits(out, weights, family)
        expect = engine_expectations(weights, family)
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    return expect, json.loads(stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2], sys.argv[3:])


# ------------------------------------------------ what the tests assert
def expected_state(family, name, T):
    """{state leaf: local shape} of a rank on mesh ``name``: batch rows
    over "data", heads (WKV, SSM, the shared block's KV rows) and conv
    channels over "model"."""
    from repro_torch.models.layers import head_dims
    from repro_torch.models.mamba2 import mamba_dims
    (dp, tp), _ = MESHES[name]
    cfg, b = port_cfg(family), B // dp
    if family == "rwkv6":
        L, D, H = cfg.n_layers, cfg.d_model, cfg.n_heads
        dh = D // H
        return {"shift_t": [L, b, D], "shift_c": [L, b, D],
                "wkv": [L, b, H // tp, dh, dh]}
    d_in, nh, dh, ns, cw = mamba_dims(cfg)
    G, g = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
    hd = head_dims(cfg, tp)
    return {"attn_cache/k": [G, b, T, hd.KvE // tp, hd.dh],
            "attn_cache/v": [G, b, T, hd.KvE // tp, hd.dh],
            "mamba/conv": [G, g, b, cw - 1, (d_in + 2 * ns) // tp],
            "mamba/ssm": [G, g, b, nh // tp, dh, ns]}


def layer_bytes(family, name):
    """The bytes one layer's collectives carry on a rank of mesh ``name``
    on a decode step (one token a row), by design: RWKV-6 all-reduces its
    time mix's and channel mix's partial outputs (D a token each) and
    gathers the receptance gate's columns (D / tp); a Mamba-2 block
    gathers its ``w_in`` columns (a chunk of 2 d_in + 2 ns + nh) and its
    conv channels (a chunk of d_in + 2 ns), all-reduces the gated norm's
    sum of squares (1) and the partial output (D).  And the layer's
    activations' bytes (D a token)."""
    from repro_torch.models.mamba2 import mamba_dims
    (dp, tp), _ = MESHES[name]
    cfg, rows = port_cfg(family), B // dp
    D = cfg.d_model
    if family == "rwkv6":
        per_token = 2 * D + -(-D // tp)
    else:
        d_in, nh, _, ns, _ = mamba_dims(cfg)
        per_token = -(-(2 * d_in + 2 * ns + nh) // tp) \
            + -(-(d_in + 2 * ns) // tp) + 1 + D
    return 4 * rows * per_token, 4 * rows * D
