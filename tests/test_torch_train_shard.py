"""The dense family's sharded train step on a DeviceMesh: the reference's
train cell (``launch/dryrun.py:55-118``) through ``launch.steps.
train_cell`` — fsdp, sequence parallelism, remat "full" on ("data",
"model") (2, 2); tensor parallelism alone on (1, 4); the zero3 layout on
(2, 2), its batch from ``ShardedPrefetcher`` over every mesh dimension —
held against the unsharded port and the JAX package's
``value_and_grad(model.loss)`` on the same weights, with the planted
backward faults and a resume across mesh shapes.

Four CPU ranks over gloo in one subprocess (``tests/torch_train_ranks.py``
says what each rank checks, and its end the float32 bounds: the loss
within 1e-5 of both; every gradient leaf within 1e-5 of its largest
magnitude of the unsharded port's and within 1e-4 of the reference's;
the params after three clipped AdamW steps within 1e-5 of the unsharded
port's).
"""
import pytest

from tests import torch_train_ranks as R
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

CASES = ("llama3 fsdp sp (2, 2)", "llama3 tp 4 (1, 4)",
         "llama3 zero3 (2, 2)")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.start_ranks(tmp_path_factory, CASES + ("fault", "resume"))


@pytest.mark.parametrize("what", R.WHAT)
@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_equals_unsharded(runs, case, what):
    """The loss, every gradient leaf, three steps' losses and params, and
    every gradient, moment and param placed as ``param_shardings``
    places them."""
    R.check_case(runs, case, what)


def test_zero3_batch_spans_every_mesh_dimension(runs):
    """The prefetcher places the zero3 batch's rows over ("data",
    "model") — both tokens and labels."""
    assert runs["batch placed llama3 zero3 (2, 2)"] == [
        [["S(0)", "S(0)"]] * 2] * R.WORLD


@pytest.mark.parametrize("fault", R.FAULTS)
def test_a_wrong_collective_backward_fails_the_gradient_check(runs, fault):
    """RWKV-6 on (2, 2): Megatron's "f" (a replicated input entering work
    split over "model") with an identity backward, or its "g" (a sum
    every rank then uses alike) with an all-reduce backward, moves the
    gradients far past the bound; the real backwards meet it."""
    assert min(runs[f"fault {fault}"]) > 100 * R.GRAD_TOL[None], runs
    assert max(runs["fault none"]) <= R.GRAD_TOL[None]


@pytest.mark.parametrize("name", R.COLLECTIVES)
def test_collective_backward_is_its_conventions_gradient(runs, name):
    """Each collective of ``models/partitioning.py`` under autograd, on the
    world's 4 ranks: the rank's gradient equals the gradient of the loss
    its mode defines — the sum of every rank's loss where the result feeds
    split work, the one loss every rank computes alike otherwise (gather:
    a reduce-scatter or the rank's chunk; a sum: an all-reduce or the
    identity; "f": an all-reduce; a reduce-scatter: an all-gather; a
    broadcast: a reduce to its source or the gradient kept there), uneven
    column chunks included."""
    gaps = runs[f"collective {name}"]
    assert len(gaps) == R.WORLD and max(gaps) <= 1e-6, gaps


def test_resume_onto_another_mesh_shape_continues_the_run(runs):
    """One step on (2, 2), a sharded save, ``elastic_restore`` onto
    (1, 4), two more steps: the losses and params of the unsharded port's
    three steps, the optimizer at step 3, every param placed for the new
    mesh."""
    for loss_gap, param_gap, step, laid in runs["resume"]:
        assert loss_gap <= R.LOSS_TOL and param_gap <= R.PARAM_TOL
        assert step == R.STEPS and laid


@pytest.mark.parametrize("arch", R.REDUCED_ARCHS)
def test_reduced_widths_equal_the_reference_tests(arch):
    """``repro_torch.configs.reduced`` — the widths the rank cases and
    ``chip_smoke.py``'s train phases share — is
    ``tests/conftest.reduced_config``, field for field."""
    import dataclasses

    from repro_torch.configs.reduced import reduced_config
    from tests.conftest import reduced_config as reference
    assert (dataclasses.asdict(reduced_config(arch))
            == dataclasses.asdict(reference(arch)))
