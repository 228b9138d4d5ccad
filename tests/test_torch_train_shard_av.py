"""The audio and VLM families' sharded train steps: reduced
musicgen-large (LayerNorm, GELU with biases: ``b_down`` joins after the
reduction over "model") and llama-3.2-vision-11b (its image K/V
projected shard by shard under autograd, the cross layers' gradients
reaching ``wk``/``wv``; images of 8, 5, 8 and 3 valid rows) on ("data",
"model") (2, 2) with fsdp, sequence parallelism and remat "full", and
the VLM under the zero3 layout too (its image K/V placed by the rules:
batch rows over both axes, no head split), held against the unsharded
port and the JAX package's ``value_and_grad(model.loss)``.

Four CPU ranks over gloo in one subprocess (``tests/torch_train_ranks.py``).
Bounds: its end.
"""
import pytest

from tests import torch_train_ranks as R
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

CASES = ("musicgen fsdp sp (2, 2)", "vlm fsdp sp (2, 2)",
         "vlm zero3 (2, 2)")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, CASES)


@pytest.mark.parametrize("what", R.WHAT)
@pytest.mark.parametrize("case", CASES)
def test_sharded_av_train_step_equals_unsharded(runs, case, what):
    R.check_case(runs, case, what)
