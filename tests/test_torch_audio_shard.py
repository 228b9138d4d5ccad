"""musicgen-large on a DeviceMesh: each rank holds its heads' columns of
``wq``/``wk``/``wv`` (and their biases), its rows of ``wo``, its d_ff
slice of the GELU MLP (``w_up``'s columns with ``b_up``, ``w_down``'s
rows) and its heads' shard of the KV cache; LayerNorm runs on the
replicated residual with its biases, ``b_down`` joins once, after the
reduction of ``h @ w_down`` over "model", and the logits come back whole.

Four CPU ranks over gloo on ("data", "model") meshes (1, 4) and (2, 2),
spawned once in a subprocess beside the parent's reference runs.  The
tests are ``tests/torch_audio_vlm_ranks.py``'s, shared with the VLM's
files (its doc says what each rank checks); this file gives them its
cases.  Every bias the reference's init leaves at zero is seeded nonzero.
Lock-step logits are held within 1e-5 of the unsharded port's and of the
JAX package's; streams, logs, the cache shards and the rows each
migration sends are exact.  The planted fault — ``b_down`` added on every
rank's partial sum — must move the logits far past that bound.
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

CASES = ("musicgen (1, 4)", "musicgen (2, 2)")
FAULT = "musicgen (1, 4)"


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
