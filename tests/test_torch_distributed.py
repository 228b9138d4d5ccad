"""The port's several-device layout on a real mesh: four CPU ranks over
gloo, spawned once in a subprocess (its own timeout, 120 s).

On a (2, 2) ("data", "model") mesh and then a (1, 4) one, every rank
checks, and reports, that:
- its local shard of every parameter placed by
  ``placement_bridge.param_shardings`` is the slice its mesh coordinates
  select (cut here by hand from the spec, independently of ``place``);
- the sharded dense ``forward`` (parameters placed, ``part =
  make_partitioner(mesh)``, with and without the kernels' plain versions)
  gives, on every rank, the JAX package's logits on the same weights and
  tokens (computed in the parent process and handed to the ranks) and the
  unsharded port's, each within 1e-5 (float32);
- a checkpoint saved from the (2, 2) placement, synchronously and with
  ``save_async``, restores through ``ElasticMesh.resize`` and
  ``elastic_restore`` onto (1, 4) with the same full tensors, bit for
  bit;
- after a resize that drops rank 0, the ranks of the new mesh save
  without it: the rank at mesh coordinate (0, 0) writes, and the mesh's
  ranks alone meet at its barriers;
- ``ShardedPrefetcher(shardings=batch_shardings(...))`` hands each data
  rank its rows of the seeded batch.

Config: llama3-8b reduced to 2 layers, d 64, 8 heads of 8 over 2 KV heads
(tp 2: Kp 2, rep 1; tp 4: rep 2, the KV weights replicated), vocab 96.
The worker imports no JAX.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = 1e-5
OVERRIDES = dict(n_layers=2, d_model=64, d_ff=128, n_heads=8, d_head=8,
                 n_kv_heads=2, vocab_size=96, dtype="float32",
                 param_dtype="float32")


# ------------------------------------------------------------- the worker
def _cfg():
    from repro_torch.configs import get_config
    return get_config("llama3-8b").with_overrides(**OVERRIDES)


def _params(cfg):
    """The port's seeded tp-2 init: the same in the parent and the ranks."""
    from repro_torch.models.api import build_model
    return build_model(cfg, tp=2, device="cpu").init(
        torch.Generator().manual_seed(0))


def _tokens(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8))


def _expected_local(full, spec, mesh):
    """The slice of ``full`` a rank holds under ``spec``, by hand: tensor
    dimension d split evenly over the mesh dimensions its entry names,
    the first outermost."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    out = full
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n, idx = 1, 0
        for a in axes:
            m = names.index(a)
            idx = idx * mesh.size(m) + coord[m]
            n *= mesh.size(m)
        size = full.shape[d] // n
        assert size * n == full.shape[d], (spec, full.shape)
        out = out.narrow(d, idx * size, size)
    return out


def _check_placed(params, placed, cfg, mesh):
    """Every placed leaf's local shard is its hand-cut slice; returns the
    number of leaves that are sharded at all."""
    from repro_torch.core.placement_bridge import param_spec
    from repro_torch.tree import flatten
    tp = mesh.size(tuple(mesh.mesh_dim_names).index("model"))
    flat = flatten(placed)
    n_sharded = 0
    for path, full in flatten(params).items():
        spec = param_spec(list(path), full.dim(), cfg, tp, fsdp=False,
                          pod_ep=False, shape=tuple(full.shape),
                          n_devices=mesh.size())
        local = flat[path].to_local()
        want = _expected_local(full, spec, mesh)
        assert torch.equal(local, want), (path, spec)
        n_sharded += any(e is not None for e in spec)
    return n_sharded


def _placed(params, cfg, mesh):
    from repro_torch.core.placement_bridge import param_shardings
    from repro_torch.models.partitioning import place
    from repro_torch.tree import flatten, map_with_path
    sh = flatten(param_shardings(params, cfg, mesh))
    return map_with_path(lambda p, v: place(v, sh[p]), params)


def _full_equal(tree, params, shape):
    from repro_torch.tree import flatten
    got = flatten(tree)
    for path, leaf in flatten(params).items():
        assert tuple(got[path].device_mesh.mesh.shape) == shape, path
        assert torch.equal(got[path].full_tensor(), leaf), path


def _forward_gaps(report, label, cfg, tp, mesh, placed, tokens, plain,
                  ref):
    """The sharded forward's largest gap to the unsharded port and to the
    reference, with and without the kernels' plain versions."""
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner
    for use_kernel in (False, True):
        model = build_model(cfg, tp=tp, part=make_partitioner(mesh),
                            use_kernel=use_kernel, device="cpu")
        got = model.forward(placed, tokens)[0].full_tensor()
        for name, want in (("port", plain), ("reference", ref)):
            report[f"forward {label} kernel={use_kernel} vs {name}"] = \
                (got - want).abs().max().item()


def _worker(rank, port, out):
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.placement_bridge import (batch_shardings,
                                                   param_shardings)
    from repro_torch.data.pipeline import ShardedPrefetcher, SyntheticLM
    from repro_torch.launch.mesh import dp_degree, make_debug_mesh, tp_degree
    from repro_torch.models.api import build_model
    from repro_torch.runtime.elastic import ElasticMesh, elastic_restore

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    out = Path(out)
    ref = np.load(out / "ref.npz")
    report = {}
    try:
        cfg = _cfg()
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        assert (dp_degree(mesh), tp_degree(mesh)) == (2, 2)
        params = _params(cfg)
        placed = _placed(params, cfg, mesh)
        report["sharded leaves (2, 2)"] = _check_placed(params, placed, cfg,
                                                        mesh)
        tokens = torch.from_numpy(_tokens(cfg))
        want = build_model(cfg, tp=2, device="cpu").forward(params,
                                                           tokens)[0]
        _forward_gaps(report, "(2, 2)", cfg, 2, mesh, placed, tokens, want,
                      torch.from_numpy(ref["tp2"]))

        # save on (2, 2), synchronously and asynchronously; restore the
        # async one on (1, 4) through the elastic mesh
        ck = Checkpointer(out / "ckpt")
        ck.save(1, {"params": placed})
        ck.save_async(2, {"params": placed})
        ck.wait()
        manifests = [json.loads((out / "ckpt" / f"step_{s:08d}" /
                                 "manifest.json").read_text())["leaves"]
                     for s in (1, 2)]
        assert manifests[0] == manifests[1]
        em = ElasticMesh(range(WORLD), prefer_model=2, device_type="cpu")
        assert tuple(em.mesh.mesh.shape) == (2, 2)
        mesh4 = em.resize(range(WORLD), prefer_model=4).mesh
        assert tuple(mesh4.mesh.shape) == (1, 4)
        restored = elastic_restore(
            ck, 2, {"params": params},
            lambda m: {"params": param_shardings(params, cfg, m)},
            mesh4)["params"]
        _full_equal(restored, params, (1, 4))
        report["sharded leaves (1, 4)"] = _check_placed(params, restored,
                                                        cfg, mesh4)
        want4 = build_model(cfg, tp=4, device="cpu").forward(params,
                                                             tokens)[0]
        report["tp 4 vs tp 2 plain"] = (want4 - want).abs().max().item()
        _forward_gaps(report, "(1, 4)", cfg, 4, mesh4, restored, tokens,
                      want4, torch.from_numpy(ref["tp4"]))

        # a mesh without rank 0: ranks 1-3 save it, rank 1 writes
        mesh3 = em.resize([1, 2, 3], prefer_model=4).mesh
        assert tuple(mesh3.mesh.shape) == (3, 1)
        if rank > 0:
            ck3 = Checkpointer(out / "ckpt3")
            ck3.save(3, {"params": _placed(params, cfg, mesh3)})
            ck3.save_async(4, {"params": _placed(params, cfg, mesh3)})
            ck3.wait()
            report["writer of mesh (3, 1)"] = [
                r for r in mesh3.mesh.flatten().tolist()
                if r == rank and not any(mesh3.get_coordinate())]
        dist.barrier()
        ck3 = Checkpointer(out / "ckpt3")
        assert ck3.all_steps() == [3, 4]
        for s in (3, 4):
            got = json.loads((out / "ckpt3" / f"step_{s:08d}" /
                              "manifest.json").read_text())["leaves"]
            assert got == manifests[0], s
        report["mesh (3, 1) steps"] = ck3.all_steps()

        # the prefetcher: each data rank its rows
        src = SyntheticLM(cfg.vocab_size, 8, 4, seed=3)
        batch = next(iter(SyntheticLM(cfg.vocab_size, 8, 4, seed=3)))
        it = ShardedPrefetcher(iter(src), batch_shardings(batch, mesh))
        b = next(it)
        it.close()
        row = mesh.get_coordinate()[0]
        for k in ("tokens", "labels"):
            assert tuple(b[k].shape) == (4, 8)
            assert np.array_equal(b[k].to_local().numpy(),
                                  batch[k][2 * row:2 * row + 2]), k
        report["prefetch rows"] = [2 * row, 2 * row + 2]
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


# ------------------------------------------------------------------ test
def _reference_logits(out):
    """The JAX package's forward at tp 2 and tp 4 on the ranks' weights
    and tokens, written for the ranks to hold their logits against."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models.api import build_model as jax_build_model
    cfg = _cfg()
    cfg_j = jax_get_config("llama3-8b").with_overrides(**OVERRIDES)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _params(cfg))
    tokens = jnp.asarray(_tokens(cfg).astype(np.int32))
    logits = {f"tp{tp}": np.asarray(jax.jit(jax_build_model(
        cfg_j, tp=tp).forward)(params, tokens)[0]) for tp in (2, 4)}
    np.savez(out / "ref.npz", **logits)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    _reference_logits(out)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), str(REPO)]), "OMP_NUM_THREADS": "1"}
    run = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_each_rank_holds_its_slice_of_every_leaf(report):
    """Slices are checked leaf by leaf on every rank.  Sharded: the
    embedding, head, wq, wk, wv, wo and the three MLP weights at tp 2;
    at tp 4 the two KV weights are replicated (2 KV heads over 4)."""
    assert report["sharded leaves (2, 2)"] == [9] * WORLD
    assert report["sharded leaves (1, 4)"] == [7] * WORLD


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("mesh", ["(2, 2)", "(1, 4)"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_sharded_forward_equals_unsharded_logits(report, mesh, use_kernel,
                                                 against):
    """Every rank's gathered logits against the unsharded port's and the
    JAX package's on the same weights and tokens."""
    gaps = report[f"forward {mesh} kernel={use_kernel} vs {against}"]
    assert len(gaps) == WORLD and max(gaps) <= TOL, gaps


def test_checkpoint_restores_across_a_mesh_resize(report):
    """Bit-equal full tensors are checked on every rank, after a
    synchronous and an async save; the tp-4 model on the restored weights
    computes the tp-2 model's function."""
    assert max(report["tp 4 vs tp 2 plain"]) <= TOL


def test_a_mesh_without_rank_0_saves_through_its_own_writer(report):
    """Rank 1 sits at coordinate (0, 0) of the (3, 1) mesh over ranks 1-3
    and is its only writer; both saves are complete and equal to the
    (2, 2) mesh's."""
    assert report["writer of mesh (3, 1)"] == [None, [1], [], []]
    assert report["mesh (3, 1) steps"] == [[3, 4]] * WORLD


def test_prefetcher_gives_each_data_rank_its_rows(report):
    assert report["prefetch rows"] == [[0, 2], [0, 2], [2, 4], [2, 4]]


if __name__ == "__main__":
    _main(sys.argv[1])
