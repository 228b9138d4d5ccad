"""int8 weights on a DeviceMesh, the dense, audio and MoE families: the
placed ``q8``/``sc`` leaves of llama3 and musicgen on a (2, 2) ("data",
"model") mesh, glm4 and qwen1.5 (padded) on (1, 4), and mixtral over
"pod" on a (2, 1, 2) ("pod", "data", "model") mesh, each holding its
shard of every int8 leaf; lock-step logits against the unsharded port and
the JAX package, mixtral's cacheless forward with dense and capacity
dispatch, no collective inside ``wt``, and the planted fault of a rank
quantizing its own shard.  The ranks and the expectations are
``tests/torch_mem_ranks.py``'s (its doc); the VLM and Zamba2 run beside
them in ``tests/test_torch_int8_shard_hybrid.py``."""
import pytest

from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_mem_ranks import (  # noqa: F401 (the shared tests)
    TOL, WORLD, start_ranks,
    test_dequantizing_a_placed_leaf_takes_no_collective,
    test_int8_leaves_are_placed_as_param_spec_says,
    test_sharded_int8_lockstep_logits_equal_unsharded,
    test_the_planted_int8_fault_is_caught)

CASES = ("llama (2, 2)", "glm4 (1, 4)", "qwen padded (1, 4)",
         "musicgen (2, 2)", "mixtral (2, 1, 2)")
FAULT = "llama (2, 2)"


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


@pytest.mark.parametrize("capacity", [False, True])
def test_sharded_int8_moe_forward_equals_unsharded(runs, capacity):
    """Mixtral's cacheless forward on int8 weights over "pod", dense and
    capacity dispatch: every rank's whole logits and aux loss against the
    unsharded port's and the JAX package's."""
    gaps = runs[1][f"forward mixtral (2, 1, 2) capacity={capacity}"]
    assert len(gaps) == WORLD
    assert all(max(g) <= TOL for g in gaps), gaps
