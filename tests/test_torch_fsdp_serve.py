"""fsdp at inference: the reference's ``serve_needs_fsdp`` cells
(``dryrun.py:44-46``: models whose bf16 weights exceed a chip under pure
tp) store the weights over "data" too and gather them on use.  Reduced
llama3-8b, mixtral-8x7b (its ring cache wrapped: window 8, a prompt of
12 and 8 steps), rwkv6-7b and zamba2-2.7b (their layers on local
tensors, each weight gathered layer by layer) on ("data", "model")
(2, 2) with weights placed by ``param_shardings(fsdp=True)`` — each rank
holding a D/data slice of every matmul weight — run a lock-step prefill
and 8 greedy decode steps on ``make_partitioner(mesh, fsdp=True)``:
every logit within 1e-5 of the unsharded port's (zamba2 2e-5, its
sharded decode's bound in ``tests/test_torch_ssm_shard_zamba2.py``: six
blocks of 2-3 ulps each; 1.9e-5 measured here).  The zero3 layout's
decode: ``tests/test_torch_fsdp_serve_zero3.py``.

Four CPU ranks over gloo in one subprocess (``tests/torch_train_ranks.py``).
"""
import pytest

from tests import torch_train_ranks as R
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

CASES = tuple(c for c in R.SERVE if "layout" not in R.SERVE[c])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, CASES)


@pytest.mark.parametrize("case", CASES)
def test_fsdp_lockstep_logits_equal_unsharded(runs, case):
    R.check_serve(runs, case, "logits")


@pytest.mark.parametrize("case", CASES)
def test_fsdp_weights_are_stored_over_data(runs, case):
    """The rank's shard of a layer's matmul weight (``FSDP_LEAF``) holds
    half of D (over "data") and half of its other axis (over "model");
    the MoE's, every expert row (this mesh has no "pod")."""
    R.check_serve(runs, case, "stored")
