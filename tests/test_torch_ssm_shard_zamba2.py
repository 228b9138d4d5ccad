"""Zamba2 (zamba2-2.7b, the ``hybrid`` family) on a DeviceMesh: each rank
holds its columns of every Mamba-2 layer's ``w_in`` (cut evenly, blind to
the (z, x, B, C, dt) split), its rows of ``w_out``, its SSM heads' shard
of the SSM state and its channels' shard of the conv tail, and the shared
attention block's heads with their shard of its KV cache; the logits
come back whole.

Four CPU ranks over gloo on ("data", "model") meshes (1, 4) and (2, 2),
spawned once in a subprocess beside the parent's reference runs
(``tests/torch_ssm_ranks.py`` says what each rank checks).  The reduced
hybrid has 8 SSM heads of 16 and a state of 8, so that ``w_in``'s 280
columns and the conv's 144 channels split over 4 ranks across the
boundaries of their parts, as at full width.  Logits are held within
2e-5 of the unsharded port's and within 1e-4 of the JAX package's
(zamba2's model-level tolerance, ``tests/test_torch_zamba2.py``).  Each
sharded block is within 1.5e-6 of the unsharded one at outputs of
magnitude 4-5 (2-3 float32 ulps: the all-reduced partial sums of
``w_out``, of the shared block's ``wo`` and ``w_down`` and of the norm's
squares add in another order); six blocks (four Mamba-2 layers, two
shared-block applications) compound that to 1.0-1.3e-5 in logits of
magnitude 3.5, hence 2e-5.  The tests without ranks, at the end, show
that a gated RMSNorm taken over a rank's slice alone misses the whole
norm by far more than 1e-5, and check the refusals and the state's
placement.
"""
import numpy as np
import pytest
import torch

from tests import torch_ssm_ranks as R
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

FAMILY = "zamba2"
TOL = {"port": 2e-5, "reference": 1e-4}
MESHES = tuple(R.MESHES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, FAMILY)


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_lockstep_logits_equal_unsharded(runs, mesh, uk, against):
    """Every rank's whole lock-step prefill and per-step decode logits,
    with and without the kernels' plain versions (flash and the resident
    decode kernel in the shared block), against the unsharded port's and
    the JAX package's on the same weights."""
    gaps = runs[1][f"logits {mesh} kernel={uk} vs {against}"]
    assert len(gaps) == R.WORLD and max(gaps) <= TOL[against], gaps


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_forward_equals_unsharded(runs, mesh, uk, against):
    gaps = [g[against == "reference"]
            for g in runs[1][f"forward {mesh} kernel={uk}"]]
    assert len(gaps) == R.WORLD and max(gaps) <= TOL[against], gaps


@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_state_shards_are_local_and_written_in_place(runs, mesh, uk):
    """Each rank's SSM state is (G, g, B/dp, nh/tp, dh, ns), its conv tail
    (G, g, B/dp, cw-1, C/tp) and the shared block's cache (G, B/dp, T,
    KvE/tp, dh); every decode step wrote them in place."""
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
    package's): head moves planned, none applied (a hybrid state has no
    addressable KV cache); no rank sends a row to another."""
    logs = runs[1][f"log {mesh}"]
    assert logs == [runs[0]["port log"]] * R.WORLD
    assert runs[0]["port log"] == runs[0]["reference log"]
    moved = [e for e in logs[0] if e[1]]
    assert moved and all(not e[3] and e[4] == R.REASONS[FAMILY]
                         for e in moved)
    assert runs[1][f"sent {mesh}"] == [[]] * R.WORLD


@pytest.mark.parametrize("mesh", MESHES)
def test_engine_state_shards_written_in_place(runs, mesh):
    assert runs[1][f"engine state {mesh}"] == \
        [[R.expected_state(FAMILY, mesh, R.WAVE["max_seq"])]] * R.WORLD
    assert runs[1][f"waves {mesh}"] == [2] * R.WORLD
    assert min(runs[1][f"decode steps {mesh}"]) >= 2 * (R.WAVE_NEW - 1)
    assert runs[1][f"moved storage {mesh}"] == [0] * R.WORLD


@pytest.mark.parametrize("mesh", MESHES)
def test_a_sharded_layer_moves_activations_not_weights(runs, mesh):
    """One Mamba-2 layer on a decode step from a nonzero state: each
    rank's rows within 1e-6 of the unsharded layer's, and its collectives
    carry exactly the design's bytes (the projection's and the conv's
    columns gathered, the norm's sum of squares and the partial output
    summed) — at most five times the layer's activations and below a
    tenth of the rank's weight shard of the layer, which never travels."""
    want, act = R.layer_bytes(FAMILY, mesh)
    for gap, moved, calls, weights in runs[1][f"layer {mesh}"]:
        assert gap <= 1e-6
        assert moved == want and calls == 4
        assert moved <= 5 * act and moved < weights / 10, \
            (moved, act, weights)


# ------------------------------------------------- without ranks (CPU)
def _gated_case(seed=2, width=128, ranks=4):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.standard_normal((3, 5, width)).astype(
        np.float32))
    # channels of very different scales, as y * silu(z) has
    y = y * torch.from_numpy(np.exp(rng.uniform(-3, 1, width)).astype(
        np.float32))
    scale = torch.from_numpy(1 + 0.5 * rng.standard_normal(width).astype(
        np.float32))
    return y, scale, width // ranks


@pytest.mark.parametrize("over", ["all ranks", "one rank's slice"])
def test_gated_norm_over_one_slice_alone_fails(over):
    """The gated RMSNorm normalizes over the whole d_inner.  Each rank's
    slice normalized with the sum of squares summed over every slice (what
    the "model" all-reduce gives) equals the whole norm within 1e-5; the
    planted fault — each slice normalized over itself alone — does not."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.mamba2 import gated_rms_norm
    y, scale, n = _gated_case()
    width = y.shape[-1]
    want = rms_norm(y, scale, 1e-5)
    slices = [slice(r * n, (r + 1) * n) for r in range(width // n)]

    def all_ranks(t):
        return sum(y[..., s].float().square().sum(-1, keepdim=True)
                   for s in slices)

    if over == "all ranks":
        got = [gated_rms_norm(y[..., s], scale[s], 1e-5, width, all_ranks)
               for s in slices]
    else:
        got = [rms_norm(y[..., s], scale[s], 1e-5) for s in slices]
    gap = (torch.cat(got, dim=-1) - want).abs().max().item()
    assert (gap <= 1e-5) == (over == "all ranks"), gap


def test_a_model_degree_that_does_not_divide_the_heads_is_refused():
    """The "model" degree must divide the SSM heads (8 here), the shared
    block's padded query heads and its KV rows (the tp layout pads and
    replicates them to a multiple of tp: 3 fails on the SSM heads, 16 on
    them too)."""
    from repro_torch.models.api import build_model
    from repro_torch.models.partitioning import make_partitioner
    from tests.test_torch_sharding import StandInMesh
    cfg = R.port_cfg(FAMILY)
    for m in (3, 16):
        part = make_partitioner(StandInMesh((1, m), ("data", "model")))
        with pytest.raises(ValueError, match="must divide"):
            build_model(cfg, tp=m, part=part, device="cpu")
    part = make_partitioner(StandInMesh((1, 2), ("data", "model")))
    assert build_model(cfg, tp=2, part=part, device="cpu").part is part


def test_zamba2_state_shardings_equal_reference():
    """The decode state's placements — SSM heads and conv channels over
    "model", the shared block's KV rows over "model", batch rows over
    "data" — are the reference's."""
    import jax
    from repro.core import placement_bridge as jbridge
    from repro.models.api import build_model as jax_build_model
    from repro_torch.core import placement_bridge as bridge
    from repro_torch.models import partitioning as part
    from repro_torch.models.api import build_model
    from repro_torch.tree import flatten
    from tests.test_torch_sharding import StandInMesh
    names = ("data", "model")
    mj = jax_build_model(R._jax_cfg(FAMILY))
    pj = jax.eval_shape(mj.init, jax.random.PRNGKey(0))
    ref = jax.eval_shape(lambda p: mj.init_decode_state(p, 4, 8), pj)
    want = jbridge.decode_state_shardings(ref, None,
                                          jax.make_mesh((1, 1), names))
    model = build_model(R.port_cfg(FAMILY), device="cpu")
    state = {"cache": model._zero_state(4, 8, True, "meta"), "pos": 0}
    mesh = StandInMesh((2, 2), names)
    got = flatten(bridge.decode_state_shardings(state, None, mesh))
    paths = {tuple(jbridge._path_names(p)): tuple(sh.spec)
             for p, sh in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(paths) - {("pos",)} == set(got) - {("pos",)}
    assert ("cache", "mamba", "conv") in paths
    for path, spec in paths.items():
        if path in got:
            assert got[path].placements == part.placements(mesh, spec), path
