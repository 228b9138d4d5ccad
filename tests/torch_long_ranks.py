"""Long-decode on a DeviceMesh (the reference's ``seq_over_data`` rules):
the four gloo ranks and the parent's expectations behind
``tests/test_torch_long_decode.py`` (zamba2 and RWKV-6) and
``tests/test_torch_long_decode_moe.py`` (mixtral).

Under ``make_partitioner(mesh, seq_over_data=True)`` a batch-1 model
keeps its batch whole and shards its KV cache's sequence over "data" (a
ring: its slots) and its heads over "model": each rank writes the
positions it owns, attends over them alone and the ranks merge the partial
softmaxes (``partitioning.SeqShard``).  RWKV-6 has no cache: its WKV state
is replicated over "data".  A test file starts four CPU ranks over gloo in
one subprocess (its own timeout) for its families; the parent writes the
weights — the port's init from seed 0 with the leaves the reference's init
leaves at zero or one seeded in both packages (``torch_ssm_ranks.SEEDED``;
mixtral's QKV biases and router) — and while the ranks run computes the
JAX package's unsharded greedy run (a prefill from position 0, then
``STEPS`` greedy decode steps, each compiled once).  Every rank, on each of
its family's meshes and with and without the kernels' plain versions,
runs the same greedy run unsharded and sharded and reports:
- the sharded logits' gap to the unsharded port's and to the reference's,
  and the three greedy streams;
- its cache shard's local shape and its rows ``[lo, lo + n)`` against the
  unsharded cache's: layer 0's bit for bit after the prefill and after the
  last step (its K/V depend only on the tokens), every layer's gap;
- the bytes one layer's merge carries (two all-reduces: the LSE's max,
  then the weighted outputs beside their weights; no K or V), the
  all-gathers a decode step makes (mixtral: the expert layer gathers no
  tokens when the batch is whole) and RWKV-6's state shards;
- with ``SeqShard.merge`` planted to return the rank's local output
  unmerged, the logits' gap to the unsharded port (must exceed the bound);
- (zamba2, first mesh) whether a cache placed as the port placed it before
  the long-decode rules were wired (its sequence replicated over "data")
  is refused by the attention layer, and the state placed now accepted.

The worker imports no JAX.  ``python tests/torch_long_ranks.py <dir>
<family> ...`` runs the ranks by hand once the parent has written
``<dir>``'s weights (``<family>.npz``).
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

from tests import torch_ssm_ranks as SSM

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
STEPS = 16
# family -> (arch, overrides, prompt, max_seq, meshes {name: (shape, names)})
# zamba2's 43 positions do not divide over 4 or 2 data ranks (chunks of 11
# and 22, the last short); mixtral's window of 32 is wrapped by its prompt
FAMILIES = {
    "zamba2": ("zamba2-2.7b", SSM.overrides("zamba2"), 24, 43, {
        "data 4 model 1": ((4, 1), ("data", "model")),
        "data 2 model 2": ((2, 2), ("data", "model"))}),
    "rwkv6": ("rwkv6-7b", SSM.overrides("rwkv6"), 24, 43, {
        "data 4 model 1": ((4, 1), ("data", "model")),
        "data 2 model 2": ((2, 2), ("data", "model"))}),
    "mixtral": ("mixtral-8x7b", dict(
        n_layers=2, d_model=48, d_ff=96, vocab_size=96, dtype="float32",
        param_dtype="float32", n_heads=8, d_head=8, n_kv_heads=2,
        n_experts=4, sliding_window=32, qkv_bias=True), 48, 80, {
        "pod 1 data 4 model 1": ((1, 4, 1), ("pod", "data", "model")),
        "pod 2 data 2 model 1": ((2, 2, 1), ("pod", "data", "model"))}),
}
# the cache leaf whose sequence is sharded, and the axis of its positions
CACHE = {"zamba2": (("attn_cache", "k"), 2), "mixtral": (("k",), 2)}


def port_cfg(family):
    from repro_torch.configs import get_config
    return get_config(FAMILIES[family][0]).with_overrides(
        **FAMILIES[family][1])


def _jax_cfg(family):
    from repro.configs import get_config as jax_get_config
    return jax_get_config(FAMILIES[family][0]).with_overrides(
        **FAMILIES[family][1])


def meshes(family):
    return FAMILIES[family][4]


def tp_of(family, name):
    return meshes(family)[name][0][-1]


def prompt(family):
    n = FAMILIES[family][2]
    vocab = FAMILIES[family][1]["vocab_size"]
    return np.random.default_rng(n).integers(0, vocab, (1, n)).astype(
        np.int32)


# ------------------------------------------------------------- the worker
def _cache_leaf(family, state):
    if family not in CACHE:
        return None
    t = state["cache"]
    for k in CACHE[family][0]:
        t = t[k]
    return t


def _greedy(model, params, family):
    """A prefill of the family's prompt from position 0 and ``STEPS``
    greedy decode steps, through the step factories a user calls
    (``launch.steps``): (the logits of every call (STEPS + 1, 1, V), the
    greedy tokens, the cache leaf's local tensor after the prefill (a
    copy) and at the end, and the final state)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.partitioning import local
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    state = model.init_decode_state(params, 1, FAMILIES[family][3])
    out, state = prefill(params, state, torch.from_numpy(prompt(family)))
    leaf = _cache_leaf(family, state)
    after_prefill = None if leaf is None else local(leaf).clone()
    logits, toks = [out], []
    for _ in range(STEPS):
        toks.append(int(out[0].argmax()))
        out, state = decode(params, state, torch.tensor([toks[-1]],
                                                        dtype=torch.int32))
        logits.append(out)
    toks.append(int(out[0].argmax()))
    end = None if leaf is None else local(leaf)
    return torch.stack(logits), toks, after_prefill, end, state


def _rows_of_whole(family, whole, sharded_leaf):
    """The rows of the unsharded cache leaf ``whole`` that the rank's
    shard of ``sharded_leaf`` holds: positions (slots) over "data", heads
    over "model"."""
    from repro_torch.models.partitioning import local_range
    axis = CACHE[family][1]
    lo, n = local_range(sharded_leaf, axis)
    h0, hn = local_range(sharded_leaf, axis + 1)
    return whole.narrow(axis, lo, n).narrow(axis + 1, h0, hn), (lo, n)


class _Spy:
    """Records the bytes of this rank's tensor each wrapped collective
    carries while active."""

    def __init__(self, names=("all_reduce", "all_gather")):
        import torch.distributed as dist
        self.dist, self.inner = dist, {n: getattr(dist, n) for n in names}
        self.calls = []

    def __enter__(self):
        def spy(n):
            def call(*a, **k):
                t = a[0] if n == "all_reduce" else a[1]
                self.calls.append((n, t.numel() * t.element_size()))
                return self.inner[n](*a, **k)
            return call
        for n in self.inner:
            setattr(self.dist, n, spy(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.inner.items():
            setattr(self.dist, n, f)


def _merge_bytes(report, label, model, params, family):
    """One decode step of the sharded model with ``SeqShard.merge``'s and
    the whole step's collectives recorded: the bytes each merge carries
    and the all-gathers of the step."""
    from repro_torch.models import partitioning
    state = model.init_decode_state(params, 1, FAMILIES[family][3])
    _, state = model.prefill(params, state, torch.from_numpy(
        prompt(family)))
    merges, inner = [], partitioning.SeqShard.merge

    def merge(self, out, lse, dtype=None):
        with _Spy(("all_reduce",)) as spy:
            got = inner(self, out, lse, dtype)
        merges.append([b for _, b in spy.calls])
        return got

    partitioning.SeqShard.merge = merge
    try:
        with _Spy() as step:
            model.decode_step(params, state, torch.tensor([1],
                                                          dtype=torch.int32))
    finally:
        partitioning.SeqShard.merge = inner
    report[f"merge bytes {label}"] = merges
    report[f"all_gathers {label}"] = sum(n == "all_gather"
                                         for n, _ in step.calls)


def _refused_before(report, family, name, mesh):
    """A zamba2 state placed as the port placed it before the long-decode
    rules were wired (the batch-1 rule replicating every "data"
    placement, the cache's sequence with it) against the state placed
    now, each through the attention layer's layout check."""
    from torch.distributed.tensor import Replicate
    from repro_torch.core.placement_bridge import decode_state_shardings
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import _cache_shards
    from repro_torch.models.partitioning import (Sharding, make_partitioner,
                                                 placed_full)
    from repro_torch.tree import flatten, map_with_path
    cfg, part = port_cfg(family), make_partitioner(mesh, seq_over_data=True)
    model = build_model(cfg, tp=tp_of(family, name), device="cpu",
                        part=part)
    meta = {"cache": model._zero_state(1, FAMILIES[family][3], True,
                                       "meta"), "pos": 0}
    names = tuple(mesh.mesh_dim_names)
    old = flatten(decode_state_shardings(meta, cfg, mesh))

    def before(path, leaf):
        sh = old[path]
        return placed_full(leaf.shape, 0, leaf.dtype, Sharding(mesh, tuple(
            Replicate() if n in ("pod", "data") else pl
            for n, pl in zip(names, sh.placements))))

    states = {"before": map_with_path(
        lambda p, v: before(p, v) if isinstance(v, torch.Tensor) else v,
        meta), "now": model.init_decode_state(None, 1, FAMILIES[family][3])}
    for label, state in states.items():
        view = {n: t[0] for n, t in state["cache"]["attn_cache"].items()}
        try:
            _cache_shards(view, part.for_batch(1), paged=False)
            report[f"refused {label}"] = False
        except ValueError:
            report[f"refused {label}"] = True


def _check(report, family, name, mesh, params):
    from repro_torch.models import partitioning
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import local, make_partitioner
    cfg, tp = port_cfg(family), tp_of(family, name)
    placed = SSM._placed(params, cfg, mesh)
    part = make_partitioner(mesh, seq_over_data=True)
    for uk in (False, True):
        label = f"{family} {name} kernel={uk}"
        plain = _greedy(build_model(cfg, tp=tp, use_kernel=uk,
                                    device="cpu"), params, family)
        model = build_model(cfg, tp=tp, use_kernel=uk, device="cpu",
                            part=part)
        got = _greedy(model, placed, family)
        report[f"logits {label} vs port"] = \
            (got[0] - plain[0]).abs().max().item()
        report[f"logits {label}"] = got[0].numpy().tolist()
        report[f"streams {label}"] = [got[1], plain[1]]
        if family in CACHE:
            leaf = _cache_leaf(family, got[4])
            whole_prefill, (lo, n) = _rows_of_whole(family, plain[2], leaf)
            whole_end, _ = _rows_of_whole(family, plain[3], leaf)
            report[f"cache {label}"] = {
                "local shape": list(local(leaf).shape), "lo": lo, "n": n,
                "prefill layer 0 equal": bool(torch.equal(
                    got[2][0], whole_prefill[0])),
                "end layer 0 equal": bool(torch.equal(got[3][0],
                                                      whole_end[0])),
                "end gap": (got[3] - whole_end).abs().max().item(),
                "prefill gap": (got[2] - whole_prefill).abs().max().item()}
        else:
            report[f"state {label}"] = {
                k: list(local(t).shape) for k, t in got[4]["cache"].items()}
        if uk:
            _merge_bytes(report, label, model, placed, family)
    if family not in CACHE:         # nothing is merged without a cache
        return
    # the planted fault: every rank keeps its own partial output
    inner = partitioning.SeqShard.merge
    partitioning.SeqShard.merge = \
        lambda self, out, lse, dtype=None: out.to(dtype or torch.float32)
    try:
        faulty = _greedy(build_model(cfg, tp=tp, use_kernel=True,
                                     device="cpu", part=part),
                         placed, family)
    finally:
        partitioning.SeqShard.merge = inner
    report[f"fault {family} {name}"] = (faulty[0] - plain[0]).abs().max() \
        .item()


def _worker(rank, port, out, families):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.weights import params_from_jax

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    out = Path(out)
    report = {}
    try:
        for family in families:
            params = params_from_jax(SSM.load_tree(out / f"{family}.npz"),
                                     "cpu")
            for i, (name, (shape, dims)) in enumerate(
                    meshes(family).items()):
                mesh = make_mesh(shape, dims, device_type="cpu")
                if family == "zamba2" and i == 0:
                    _refused_before(report, family, name, mesh)
                _check(report, family, name, mesh, params)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    (out / f"report_{rank}.json").write_text(json.dumps(report))


def _main(out, families):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, out, families), nprocs=WORLD, join=True)
    reports = [json.loads(Path(out, f"report_{r}.json").read_text())
               for r in range(WORLD)]
    keys = sorted({k for r in reports for k in r})
    print(json.dumps({k: [r.get(k) for r in reports] for k in keys}))


# ----------------------------------------------------- the parent's part
def write_weights(out, family):
    """The port's init from seed 0 with the family's seeded leaves (the
    recurrent families: ``torch_ssm_ranks.SEEDED``; mixtral: its QKV
    biases and router drawn from seed 7, identity expert maps), written
    for the ranks and returned as a numpy tree."""
    from repro_torch.models.api import build_model
    from repro_torch.models.moe import expert_identity
    cfg = port_cfg(family)
    params = build_model(cfg, device="cpu").init(
        # rpr: ignore[RPR001] -- the weights of one model, from seed 0
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    lay = params["layers"]
    if family == "mixtral":
        for n in ("bq", "bk", "bv"):
            lay["attn"][n] = torch.from_numpy(0.5 * rng.standard_normal(
                tuple(lay["attn"][n].shape))).float()
        lay["moe"]["router"] = torch.from_numpy(rng.standard_normal(
            tuple(lay["moe"]["router"].shape)).astype(np.float32)
            / np.sqrt(cfg.d_model))
        lay["moe"]["owner"], lay["moe"]["share"] = expert_identity(
            cfg.n_experts, cfg.n_layers)
    else:
        for leaf, draw in SSM.SEEDED[family].items():
            lay[leaf] = torch.from_numpy(draw(rng, tuple(lay[leaf].shape))
                                         .astype(np.float32))
    SSM.save_tree(out / f"{family}.npz", params)
    return SSM.load_tree(out / f"{family}.npz")


def reference_run(weights, family):
    """The JAX package's unsharded greedy run on the same weights and
    prompt: (logits (STEPS + 1, 1, V), greedy tokens)."""
    import jax
    import jax.numpy as jnp
    from repro.models.api import build_model as jax_build_model
    pj = jax.tree.map(jnp.asarray, weights)
    model = jax_build_model(_jax_cfg(family))
    prefill = jax.jit(model.prefill, donate_argnums=(1,))
    step = jax.jit(model.decode_step, donate_argnums=(1,))
    state = model.init_decode_state(pj, 1, FAMILIES[family][3])
    out, state = prefill(pj, state, jnp.asarray(prompt(family)))
    logits, toks = [out], []
    for _ in range(STEPS):
        nxt = jnp.argmax(logits[-1], -1).astype(jnp.int32)
        toks.append(nxt)
        out, state = step(pj, state, nxt)
        logits.append(out)
    toks.append(jnp.argmax(logits[-1], -1))
    return (np.asarray(jnp.stack(logits)),
            [int(t[0]) for t in np.asarray(jnp.stack(toks))])


def start_ranks(tmp_path_factory, families):
    """The ranks run ``families`` on their meshes (one subprocess, 240 s
    at most) while this process runs the reference.  Returns ({family:
    the reference's (logits, tokens)}, {report key: one value a rank})."""
    out = tmp_path_factory.mktemp("long_decode")
    weights = {f: write_weights(out, f) for f in families}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), str(REPO)]), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, __file__, str(out),
                             *families], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ref = {f: reference_run(weights[f], f) for f in families}
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    return ref, json.loads(stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2:])


# ------------------------------------------------ what the tests assert
def expected_shard(family, name):
    """(the local cache leaf's shape, [(lo, n) of each data rank]) on mesh
    ``name``: positions (slots) cut as ``torch.chunk`` cuts them over
    "data", KV rows over "model", the batch of 1 whole."""
    from repro_torch.models.layers import head_dims
    (*_, dp, tp), _ = meshes(family)[name]
    cfg = port_cfg(family)
    hd = head_dims(cfg, tp)
    T = cfg.sliding_window if family == "mixtral" else FAMILIES[family][3]
    chunk = -(-T // dp)
    spans = [(min(r * chunk, T), max(min(chunk, T - r * chunk), 0))
             for r in range(dp)]
    lead = [cfg.n_layers // cfg.shared_attn_every] if family == "zamba2" \
        else [cfg.n_layers]
    return [lead + [1, n, hd.KvE // tp, hd.dh] for _, n in spans], spans


def merge_bytes(family, name):
    """The bytes one layer's merge carries on a rank of mesh ``name`` at a
    decode step (one query a row, B 1): the LSE of each of its q heads
    (the max), then each head's weighted output (dh) beside its weight,
    in float32."""
    (*_, tp), _ = meshes(family)[name]
    from repro_torch.models.layers import head_dims
    hd = head_dims(port_cfg(family), tp)
    heads = hd.Hp // tp
    return [4 * heads, 4 * heads * (hd.dh + 1)]
