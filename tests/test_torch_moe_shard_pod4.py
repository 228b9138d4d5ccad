"""The ("pod", "data", "model") (4, 1, 1) mesh of
``tests/test_torch_moe_shard.py``: each rank holds one of the 4 experts'
rows whole (tp 1) and one batch row, so every expert migration row that
moves changes rank.  In a file of its own so that its four ranks run
beside that file's on another worker; the checks, the traffic and the
reference runs are that file's."""
import pytest

from tests import test_torch_moe_shard as base
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

MESHES = ("pod 4",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.start_ranks(tmp_path_factory, MESHES)


@pytest.mark.parametrize("mesh,S,uk,against", base.logit_cases(MESHES))
def test_sharded_ring_logits_equal_unsharded(runs, mesh, S, uk, against):
    base.test_sharded_ring_logits_equal_unsharded(runs, mesh, S, uk,
                                                  against)


@pytest.mark.parametrize("mesh", MESHES)
def test_lockstep_ring_shard_shape(runs, mesh):
    base.test_lockstep_ring_shard_shape(runs, mesh)


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("capacity", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_forward_equals_unsharded(runs, mesh, capacity, against):
    base.test_sharded_forward_equals_unsharded(runs, mesh, capacity, against)


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("kind", list(base.RUNS))
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_engine_streams_equal_unsharded(runs, mesh, kind, against):
    base.test_sharded_engine_streams_equal_unsharded(runs, mesh, kind,
                                                     against)


@pytest.mark.parametrize("kind", list(base.RUNS))
@pytest.mark.parametrize("mesh", MESHES)
def test_migration_logs_and_loads_equal_on_every_rank(runs, mesh, kind):
    base.test_migration_logs_and_loads_equal_on_every_rank(runs, mesh, kind)


@pytest.mark.parametrize("kind", list(base.RUNS))
@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_shards_written_in_place(runs, mesh, kind):
    base.test_each_rank_holds_its_shards_written_in_place(runs, mesh, kind)


@pytest.mark.parametrize("kind", list(base.RUNS))
@pytest.mark.parametrize("mesh", MESHES)
def test_migrations_send_only_the_rows_that_change_rank(runs, mesh, kind):
    base.test_migrations_send_only_the_rows_that_change_rank(runs, mesh,
                                                             kind)


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
@pytest.mark.parametrize("mesh", MESHES)
def test_a_sharded_layer_moves_activations_not_weights(runs, mesh,
                                                       dispatch):
    base.test_a_sharded_layer_moves_activations_not_weights(runs, mesh,
                                                            dispatch)
