"""The MoE family's sharded train step: reduced mixtral-8x7b on ("pod",
"data", "model") (2, 1, 2) — experts over "pod", d_ff over "model",
fsdp over "data", sequence parallelism (the block's output leaving by a
reduce-scatter along the sequence), remat "full" — through
``launch.steps.train_cell`` with capacity dispatch (the reference's
training choice, ``dryrun.py:72``), with dense dispatch, and under the
zero3 layout (every expert gathered on every rank of a batch over all
three axes), held against the unsharded port and the JAX package's
``value_and_grad(model.loss)``: the loss (with 0.01 times the aux loss,
whose token means are summed over the token ranks), every gradient leaf
(router and expert stacks included), three clipped AdamW steps and the
placements.

Four CPU ranks over gloo in one subprocess (``tests/torch_train_ranks.py``;
most of its time is DTensor's first-call sharding propagation on the 3-D
mesh).  Bounds: ``torch_train_ranks``' end.
"""
import pytest

from tests import torch_train_ranks as R
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

CASES = ("mixtral capacity (2, 1, 2)", "mixtral dense (2, 1, 2)",
         "mixtral zero3 (2, 1, 2)")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, CASES)


@pytest.mark.parametrize("what", R.WHAT)
@pytest.mark.parametrize("case", CASES)
def test_sharded_moe_train_step_equals_unsharded(runs, case, what):
    R.check_case(runs, case, what)
