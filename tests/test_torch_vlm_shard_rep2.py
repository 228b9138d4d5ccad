"""llama-3.2-vision-11b on a DeviceMesh, 8 query heads over 2 KV heads,
each replicated twice at tp 4 (rep 2: two ranks hold a copy of each KV
head's cache rows and image K/V rows, and project them from the same
replicated ``wk``/``wv`` rows), with a float32 cache and an int8 one
(values and per-(token, head) scales sharded and permuted alike).  The
split-off half of ``tests/test_torch_vlm_shard.py`` (8 over 4 KV heads),
so that the two run on separate workers.

Four CPU ranks over gloo on a ("data", "model") (1, 4) mesh, spawned once
in a subprocess beside the parent's reference runs.  The tests are
``tests/torch_audio_vlm_ranks.py``'s (its doc says what each rank checks,
and why the int8 case's logits are held to ``INT8_TOL``); this file gives
them its cases.  The simulated network is seed 2's: seed 1's moves no
group of four query heads under the straggler.  The planted fault — a
cross layer's output taken from the rank's own heads without the
reduction through ``wo`` — is run at rep 2 too.
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

CASES = ("vlm kv 2 (1, 4)", "vlm kv 2 int8 (1, 4)")
FAULT = "vlm kv 2 (1, 4)"


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
