"""Zamba2's sharded train step: reduced zamba2-2.7b on ("data", "model")
(2, 2) under the tp rules (fsdp, sequence parallelism, remat "full" over
each supergroup: the Mamba-2 blocks on local tensors — ``w_in``'s and the
conv's column gathers feeding each rank's heads, reduce-scattered back;
the gated norm's sum of squares all-reduced both ways — and the shared
block through DTensor, its crossings with the local stream gathering the
sequence over "model") and under the zero3 layout, held against the
unsharded port and the JAX package's ``value_and_grad(model.loss)``.

Four CPU ranks over gloo in one subprocess (``tests/torch_train_ranks.py``;
bounds: its end — the gradients 5e-5 of each leaf's largest magnitude
against the unsharded port, 2.8e-5 measured).
"""
import pytest

from tests import torch_train_ranks as R
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

CASES = ("zamba2 fsdp sp (2, 2)", "zamba2 zero3 (2, 2)")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, CASES)


@pytest.mark.parametrize("what", R.WHAT)
@pytest.mark.parametrize("case", CASES)
def test_sharded_zamba2_train_step_equals_unsharded(runs, case, what):
    R.check_case(runs, case, what)
