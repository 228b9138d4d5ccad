"""RWKV-6 on a DeviceMesh: each rank holds its WKV heads' columns of
``wr``/``wk``/``wv``/``wg``, its rows of ``wo``, its slice of the channel
mix's d_ff and its heads' shard of the WKV state; the recurrence runs in
place on the rank's heads, and the logits come back whole.

Four CPU ranks over gloo on ("data", "model") meshes (1, 4) and (2, 2),
spawned once in a subprocess beside the parent's reference runs
(``tests/torch_ssm_ranks.py`` says what each rank checks).  Lock-step
logits are held within 1e-5 of the unsharded port's and of the JAX
package's.  The cacheless forward's logits at every position are held to
RWKV-6's model-level 1e-4 (``tests/test_torch_rwkv6.py``'s
``TOL_LOGITS``): in a prompt's first tokens a head's WKV output has next
to no variance, and its group norm (eps 1e-5) magnifies any reordering of
a float32 sum a few hundred times — the unsharded port and the JAX
package differ there by up to 6e-5 as well.  The tests without ranks, at
the end, check the refusals and the state's placement.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tests import torch_ssm_ranks as R
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

FAMILY = "rwkv6"
TOL = {"port": 1e-5, "reference": 1e-5}
FORWARD_TOL = 1e-4
MESHES = tuple(R.MESHES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, FAMILY)


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_lockstep_logits_equal_unsharded(runs, mesh, uk, against):
    """Every rank's whole lock-step prefill and per-step decode logits,
    with and without the kernels' plain versions, against the unsharded
    port's and the JAX package's on the same weights."""
    gaps = runs[1][f"logits {mesh} kernel={uk} vs {against}"]
    assert len(gaps) == R.WORLD and max(gaps) <= TOL[against], gaps


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_forward_equals_unsharded(runs, mesh, uk, against):
    """The cacheless forward's whole logits at every position (module
    doc: the first positions are ill-conditioned)."""
    gaps = [g[against == "reference"]
            for g in runs[1][f"forward {mesh} kernel={uk}"]]
    assert len(gaps) == R.WORLD and max(gaps) <= FORWARD_TOL, gaps


@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_state_shards_are_local_and_written_in_place(runs, mesh, uk):
    """Each rank's token shifts are (L, B/dp, D) and its WKV state (L,
    B/dp, H/tp, dh, dh); every decode step wrote them in place."""
    assert runs[1][f"state {mesh} kernel={uk}"] == \
        [R.expected_state(FAMILY, mesh, R.T_MAX)] * R.WORLD
    assert runs[1][f"in place {mesh} kernel={uk}"] == [True] * R.WORLD


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_engine_streams_equal_unsharded(runs, mesh, against):
    """``make_engine("auto", part=...)`` picks the wave engine, as without
    a mesh, and every rank streams the unsharded port engine's and the
    JAX package's engine's greedy tokens under a straggler."""
    want = runs[0][against]
    assert len(want) == len(R.WAVE_PROMPTS)
    assert all(len(t) == R.WAVE_NEW for t in want.values())
    assert runs[1][f"streams {mesh}"] == [want] * R.WORLD
    assert runs[1][f"engine type {mesh}"] == ["WaveServingEngine"] * R.WORLD
    assert runs[0]["types"] == ["WaveServingEngine"] * 2


@pytest.mark.parametrize("mesh", MESHES)
def test_migration_logs_equal_and_nothing_is_sent(runs, mesh):
    """Every rank logs the unsharded engine's plans (and the JAX
    package's): head moves planned, none applied, with the reference's
    reason; no rank sends a row to another."""
    logs = runs[1][f"log {mesh}"]
    assert logs == [runs[0]["port log"]] * R.WORLD
    assert runs[0]["port log"] == runs[0]["reference log"]
    moved = [e for e in logs[0] if e[1]]
    assert moved and all(not e[3] and e[4] == R.REASONS[FAMILY]
                         for e in moved)
    assert runs[1][f"sent {mesh}"] == [[]] * R.WORLD


@pytest.mark.parametrize("mesh", MESHES)
def test_engine_state_shards_written_in_place(runs, mesh):
    """The engine's two waves each decode from the rank's state shards,
    written in place at every step."""
    assert runs[1][f"engine state {mesh}"] == \
        [[R.expected_state(FAMILY, mesh, R.WAVE["max_seq"])]] * R.WORLD
    assert runs[1][f"waves {mesh}"] == [2] * R.WORLD
    assert min(runs[1][f"decode steps {mesh}"]) >= 2 * (R.WAVE_NEW - 1)
    assert runs[1][f"moved storage {mesh}"] == [0] * R.WORLD


@pytest.mark.parametrize("mesh", MESHES)
def test_a_sharded_layer_moves_activations_not_weights(runs, mesh):
    """One layer on a decode step from a nonzero state: each rank's rows
    within 1e-6 of the unsharded layer's, and its collectives carry
    exactly the design's bytes (two partial outputs and the gate's
    columns) — at most three times the layer's activations and below a
    tenth of the rank's weight shard of the layer, which never travels."""
    want, act = R.layer_bytes(FAMILY, mesh)
    for gap, moved, calls, weights in runs[1][f"layer {mesh}"]:
        assert gap <= 1e-6
        assert moved == want and calls == 3
        assert moved <= 3 * act and moved < weights / 10, \
            (moved, act, weights)


# ------------------------------------------------- without ranks (CPU)
def test_a_model_degree_that_does_not_divide_the_heads_is_refused():
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import HeadShard, make_partitioner
    from tests.test_torch_sharding import StandInMesh
    cfg = R.port_cfg(FAMILY)
    part = make_partitioner(StandInMesh((1, 3), ("data", "model")))
    with pytest.raises(ValueError, match="divide the 4 WKV heads"):
        build_model(cfg, part=part, device="cpu")
    with pytest.raises(ValueError, match="does not divide the 4 heads"):
        HeadShard((0, 2), rank=1, ranks=3).heads(4)
    assert HeadShard((0, 2), rank=1, ranks=2).heads(4) == (2, 2)


@pytest.mark.parametrize("rank", range(4))
def test_head_shard_spans_cut_as_dtensor_does(rank):
    """A rank's span of an axis is its ``torch.chunk`` (DTensor's cut),
    uneven ones too (a vocabulary of 97 over 4)."""
    from repro_torch.models.partitioning import HeadShard
    for n in (97, 144, 280, 4):
        x = torch.arange(n)
        chunks = torch.chunk(x, 4)
        want = chunks[rank] if rank < len(chunks) else x[:0]
        lo, m = HeadShard((0, 1), rank=rank, ranks=4).span(n)
        assert torch.equal(x[lo:lo + m], want)


def test_rwkv_state_shardings_equal_reference():
    """The decode state's placements — WKV heads over "model", every
    leaf's batch rows over "data" — are the reference's, and the state is
    built as meta tensors for ``place_state`` to cut each rank's shard."""
    import jax
    from repro.core import placement_bridge as jbridge
    from repro.models.api import build_model as jax_build_model
    from repro_torch.core import placement_bridge as bridge
    from repro_torch.models import partitioning as part
    from repro_torch.models.api import build_model
    from repro_torch.tree import flatten
    from tests.test_torch_sharding import StandInMesh
    names = ("data", "model")
    cfg_j = R._jax_cfg(FAMILY)
    mj = jax_build_model(cfg_j)
    pj = jax.eval_shape(mj.init, jax.random.PRNGKey(0))
    ref = jax.eval_shape(lambda p: mj.init_decode_state(p, 4, 8), pj)
    want = jbridge.decode_state_shardings(ref, None,
                                          jax.make_mesh((1, 1), names))
    model = build_model(R.port_cfg(FAMILY), device="cpu")
    state = {"cache": model._zero_state(4, model.H, "meta"), "pos": 0}
    mesh = StandInMesh((2, 2), names)
    got = flatten(bridge.decode_state_shardings(state, None, mesh))
    paths = {tuple(jbridge._path_names(p)): tuple(sh.spec)
             for p, sh in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(paths) - {("pos",)} == set(got) - {("pos",)}
    for path, spec in paths.items():
        if path in got:
            assert got[path].placements == part.placements(mesh, spec), path
    assert all(t.device.type == "meta" for t in state["cache"].values())
    assert dataclasses.is_dataclass(part.HeadShard((0, 1)))
    assert np.all([s is not None for s in paths.values()])
