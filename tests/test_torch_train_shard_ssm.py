"""RWKV-6's sharded train step: reduced rwkv6-7b on ("data", "model")
(2, 2) under the tp rules (fsdp, sequence parallelism, remat "full": its
time and channel mix on local tensors with Megatron's "f" and "g" around
each block's work over "model", the fsdp weights gathered layer by
layer) and under the zero3 layout (``head_shard`` reads the rules: every
rank computes every head of its quarter of the batch, every weight
gathered), held against the unsharded port and the JAX package's
``value_and_grad(model.loss)``.  Zamba2's are in
``tests/test_torch_train_shard_zamba2.py``.

Four CPU ranks over gloo in one subprocess (``tests/torch_train_ranks.py``;
bounds: its end).
"""
import pytest

from tests import torch_train_ranks as R
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

CASES = ("rwkv6 fsdp sp (2, 2)", "rwkv6 zero3 (2, 2)")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, CASES)


@pytest.mark.parametrize("what", R.WHAT)
@pytest.mark.parametrize("case", CASES)
def test_sharded_recurrent_train_step_equals_unsharded(runs, case, what):
    R.check_case(runs, case, what)


def test_zero3_head_shard_reads_the_rules():
    """Under the zero3 rules a recurrent layer splits no head: every rank
    holds them all and its batch rows over ("data", "model"); under the
    tp rules the heads lie over "model"."""
    from repro_torch.models.partitioning import head_shard, make_partitioner
    from tests.test_torch_sharding import StandInMesh

    class Rank3(StandInMesh):
        """The stand-in mesh as the rank at coordinate (1, 1) sees it,
        without process groups."""

        def get_coordinate(self):
            return [1, 1]

        def get_group(self, m):
            return None
    mesh = Rank3((2, 2), ("data", "model"))
    z = head_shard(make_partitioner(mesh, layout="zero3"), 8)
    assert (z.rank, z.ranks, z.model) == (0, 1, None)
    assert z.batch_axes == ("data", "model") and z.rows == (6, 2)
    assert z.fsdp == ("data", "model") and z.partial(True) == z.batch_axes
    t = head_shard(make_partitioner(mesh, fsdp=True), 8)
    assert (t.rank, t.ranks) == (1, 2)
    assert t.batch_axes == ("data",) and t.rows == (4, 4)
    assert t.fsdp == ("data",) and t.partial(True) == ("data", "model")
    assert t.partial(False) == ("data",)
