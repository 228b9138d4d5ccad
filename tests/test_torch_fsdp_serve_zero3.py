"""The recurrent families' decode under the zero3 layout, which
``partitioning.head_shard`` reads from the rules: reduced rwkv6-7b and
zamba2-2.7b on ("data", "model") (2, 2), every weight stored over both
mesh dimensions (``param_shardings(fsdp=True, layout="zero3")``) and
gathered on use, run a lock-step prefill and 8 greedy decode steps on
``make_partitioner(mesh, fsdp=True, layout="zero3")`` — the heads over
nothing, the batch and the decode state over both dimensions
(``transformer.state_shardings``) — with every logit within 1e-5 of the
unsharded port's (zamba2 2e-5, as under fsdp; measured 4.1e-6 and
1.2e-5).

Four CPU ranks over gloo in one subprocess (``tests/torch_train_ranks.py``).
"""
import pytest

from tests import torch_train_ranks as R
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

CASES = tuple(c for c in R.SERVE if R.SERVE[c].get("layout") == "zero3")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, CASES)


@pytest.mark.parametrize("case", CASES)
def test_zero3_lockstep_logits_equal_unsharded(runs, case):
    R.check_serve(runs, case, "logits")


@pytest.mark.parametrize("case", CASES)
def test_zero3_weights_are_stored_over_every_axis(runs, case):
    """The rank's shard of a layer's matmul weight (``FSDP_LEAF``) holds
    a quarter of D (over "data" then "model") and its whole other
    axis."""
    R.check_serve(runs, case, "stored")
