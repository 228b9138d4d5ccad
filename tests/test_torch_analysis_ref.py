"""The port's step-audit budgets held number for number against the JAX
package's live audit (``repro.analysis.hlo_audit.measure*``, which
compiles the reference engine's decode, prefill and insert jits once for
the module), and both packages' hot functions audited clean on the same
tree.  Split from ``tests/test_torch_analysis.py`` for its compile time.

Exact: ``dot_flops`` (the matmul FLOPs of one decode step of the audit
model), ``prefill_lowerings``, ``insert_lowerings`` (the paged setup's:
its page mounts) and ``full_cache_param_copies``.  ``aliased_outputs``
too: the reference counts the decode jit's input/output-aliased outputs,
the port the state leaves its eager step returns in their own storage,
and both name the same leaves — the K and V caches and the positions
(dense, 3); with the page table (paged, 4); with the router-load EWMA
(MoE, 4).  ``collective_ops`` is 0 in both on one device.  The bytes
differ by definition (the port's ``op_bytes`` is an unfused sum of each
dispatched op's operands and results, XLA's ``hbm_bytes`` a fused
count), so they are not compared.
"""
import pytest

from repro.analysis import hlo_audit, jaxpr_audit
from repro_torch.analysis import step_audit, trace_audit
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

SECTIONS = ("decode_step", "paged_decode_step", "moe_decode_step")
EXACT = ("dot_flops", "prefill_lowerings", "insert_lowerings",
         "full_cache_param_copies", "aliased_outputs", "collective_ops")


@pytest.fixture(scope="module")
def reference():
    return dict(zip(SECTIONS, (hlo_audit.measure(), hlo_audit.measure_paged(),
                               hlo_audit.measure_moe())))


@pytest.fixture(scope="module")
def port():
    return {name: fn("cpu") for name, fn in step_audit.SECTIONS}


@pytest.mark.parametrize("key", EXACT)
@pytest.mark.parametrize("section", SECTIONS)
def test_budgets_equal_the_reference(reference, port, section, key):
    assert port[section][key] == reference[section][key]


def test_dot_flops_are_the_committed_numbers(port):
    """The values both packages count today (the reference's committed
    ``baselines.json`` holds the same)."""
    assert [port[s]["dot_flops"] for s in SECTIONS] == \
        [458752.0, 458752.0, 1060864.0]
    assert [port[s]["prefill_lowerings"] for s in SECTIONS] == [4.0, 1.0, 4.0]


def test_both_packages_audit_their_hot_functions_clean():
    assert trace_audit.audit_hot_functions(device="cpu") == []
    assert jaxpr_audit.audit_hot_functions() == []
