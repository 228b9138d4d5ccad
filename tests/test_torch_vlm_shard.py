"""llama-3.2-vision-11b on a DeviceMesh, 8 query heads over 4 KV heads:
each rank holds its heads' shard of every self and cross layer's weights,
of the self layers' KV cache (G, 4, B, T, KvE, dh) and of the image K/V
(G, B, I, KvE, dh), which it projects for its own batch rows and KV rows;
a cross layer attends over the rank's image K/V shard (the mean of V
patched over its heads where a row has no image) and reduces ``wo``'s
head-sharded contraction over "model"; a migration permutes the weights,
the cache and the image K/V in place, each rank sending only the rows
that change rank.

Four CPU ranks over gloo on ("data", "model") meshes (1, 4) (one KV row
a rank) and (2, 2), spawned once in a subprocess beside the parent's
reference runs; ``tests/test_torch_vlm_shard_rep2.py`` runs 8 heads over
2 (rep 2) and the int8 cache.  The tests are
``tests/torch_audio_vlm_ranks.py``'s (its doc says what each rank
checks); this file gives them its cases.  QKV biases are seeded and the
gates set (0.7, 0.5): the reference's init leaves them at zero, where a
cross layer adds nothing.  Lock-step logits are held within 1e-5 of the
unsharded port's and of the JAX package's; streams, logs, the shards and
the rows each migration sends are exact.  The planted fault — a cross
layer's output taken from the rank's own heads without the reduction
through ``wo`` — must move the logits far past that bound.
"""
import pytest

from tests import torch_audio_vlm_ranks as R
from tests.torch_audio_vlm_ranks import (  # noqa: F401 (the tests)
    test_engine_shards_keep_their_storage,
    test_migration_logs_equal_and_applied,
    test_migrations_send_only_the_rows_that_change_rank,
    test_shards_are_local_and_written_in_place,
    test_sharded_engine_streams_equal_unsharded,
    test_sharded_lockstep_logits_equal_unsharded,
    test_the_planted_fault_is_caught)
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

CASES = ("vlm kv 4 (1, 4)", "vlm kv 4 (2, 2)")
FAULT = "vlm kv 4 (1, 4)"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, CASES, FAULT)


@pytest.fixture(params=CASES)
def case(request):
    return request.param


@pytest.fixture(params=R.kernel_runs(CASES), ids=str)
def case_uk(request):
    return request.param


@pytest.fixture
def fault():
    return FAULT
