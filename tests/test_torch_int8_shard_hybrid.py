"""int8 weights on a DeviceMesh, the VLM and Zamba2: llama-3.2-vision on
(1, 4) and (2, 2) ("data", "model") meshes (its cross layers' image K/V
projected from int8 ``wk``/``wv`` shards), Zamba2 on (1, 4) and on (4, 1),
whose embedding and head run without a "model" group (int8 embedding,
head and shared block); lock-step logits against the unsharded port and
the JAX package, no collective inside ``wt``, and the planted fault of a
rank quantizing its own shard.  The ranks and the expectations are
``tests/torch_mem_ranks.py``'s (its doc); the dense, audio and MoE
families run in ``tests/test_torch_int8_shard.py``."""
import pytest

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_mem_ranks import (  # noqa: F401 (the shared tests)
    start_ranks, test_dequantizing_a_placed_leaf_takes_no_collective,
    test_int8_leaves_are_placed_as_param_spec_says,
    test_sharded_int8_lockstep_logits_equal_unsharded,
    test_the_planted_int8_fault_is_caught)

CASES = ("vlm (1, 4)", "vlm (2, 2)", "zamba2 (1, 4)", "zamba2 (4, 1)")
FAULT = "zamba2 (1, 4)"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return start_ranks(tmp_path_factory, "int8", CASES, FAULT)


@pytest.fixture(params=CASES)
def case(request):
    return request.param


@pytest.fixture(params=[(c, uk, a) for c in CASES for uk in (False, True)
                        for a in ("port", "reference")],
                ids=lambda r: f"{r[0]}-kernel={r[1]}-{r[2]}")
def logit_run(request):
    return request.param


@pytest.fixture
def fault():
    return FAULT
