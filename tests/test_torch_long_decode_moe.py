"""Long-decode at batch 1 under the reference's ``seq_over_data`` rules
for mixtral: its sliding-window ring's slots sharded over "data" (each
rank holding a contiguous share of the 32 slots, the slot positions
replicated and written alike by every rank), the experts over "pod".
Four CPU ranks over gloo on ("pod", "data", "model") meshes (1, 4, 1) and
(2, 2, 1); a 48-token prompt wraps the window, then 16 greedy steps
(``tests/torch_long_ranks.py``).  With the batch whole over "pod" and
"data" the expert layer gathers no tokens: a decode step makes no
all-gather.  Bounds as ``tests/test_torch_long_decode.py``'s: logits within
1e-5 of the unsharded port's and the reference's, streams equal, layer 0's
ring rows bit for bit.
"""
import pytest

from tests import torch_long_ranks as R
from tests.test_torch_long_decode import (cases, check_cache, check_fault,
                                          check_logits, check_merge,
                                          check_streams)
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

FAMILIES = ("mixtral",)
MESHES = list(R.meshes("mixtral"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, FAMILIES)


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("family,mesh", cases(FAMILIES))
def test_sharded_ring_long_decode_logits_equal_unsharded(runs, family, mesh,
                                                         uk, against):
    check_logits(runs, family, mesh, uk, against)


@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("family,mesh", cases(FAMILIES))
def test_sharded_ring_streams_equal_unsharded(runs, family, mesh, uk):
    check_streams(runs, family, mesh, uk)


@pytest.mark.parametrize("uk", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_slots_of_the_ring(runs, mesh, uk):
    """Each rank's shard of the (L, 1, 32, KvE, dh) ring holds slots
    ``[lo, lo + n)`` (8 a rank over 4, 16 over 2), equal to those slots of
    the unsharded ring."""
    check_cache(runs, "mixtral", mesh, uk)


@pytest.mark.parametrize("mesh", MESHES)
def test_the_ring_merge_carries_an_lse_and_an_output_a_head(runs, mesh):
    check_merge(runs, "mixtral", mesh)


@pytest.mark.parametrize("mesh", MESHES)
def test_the_expert_layer_gathers_no_tokens(runs, mesh):
    assert runs[1][f"all_gathers mixtral {mesh} kernel=True"] == \
        [0] * R.WORLD


@pytest.mark.parametrize("mesh", MESHES)
def test_the_local_ring_output_without_the_merge_fails(runs, mesh):
    check_fault(runs, "mixtral", mesh)
