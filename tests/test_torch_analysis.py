"""The port's hot-path auditor (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), and its own planted faults.

Three layers, as the reference's ``tests/test_analysis.py``:
  1. seeded violations fire — the reference's lint fixture through both
     linters (the rules they share give the same (code, line) pairs), the
     port's torch fixture ``tests/fixtures/rpr_torch/``, and faults planted
     in calls the dispatch-trace and step audits watch;
  2. the live port audits clean — its tree lints clean, its hot functions
     trace clean, the committed budgets pass, and the CLI exits 0;
  3. the ``ServingEngine(buckets=)`` repair the audit needs picks the
     reference engine's buckets and streams.
The budgets held number for number against the reference's live
``hlo_audit`` are in ``tests/test_torch_analysis_ref.py``.  Tolerances are
exact.
"""
import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.analysis import lints as ref_lints
from repro_torch.analysis import Finding, lints, step_audit, trace_audit
from repro_torch.analysis.__main__ import main as analysis_main
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_FIXTURE = REPO / "tests" / "fixtures" / "rpr" / "lint_violations.py"
TORCH_FIXTURE = REPO / "tests" / "fixtures" / "rpr_torch" / \
    "lint_violations.py"
SHARED_CODES = {"RPR000", "RPR003", "RPR004"}


def _pairs(findings, codes=None):
    return sorted((f.code, int(f.where.rsplit(":", 1)[1])) for f in findings
                  if codes is None or f.code in codes)


# ------------------------------------------------------------ RPR lint pass
def test_shared_rules_fire_where_the_reference_fires():
    """On the reference's own fixture the rules both linters keep give the
    same (code, line) pairs."""
    src = REF_FIXTURE.read_text()
    got = _pairs(lints.lint_source(src, str(REF_FIXTURE)), SHARED_CODES)
    want = _pairs(ref_lints.lint_source(src, str(REF_FIXTURE)),
                  SHARED_CODES)
    assert got == want
    assert {c for c, _ in got} == SHARED_CODES


# The reference's waiver cases (tests/test_analysis.py: reasoned waiver,
# wrong code, bare re-raise, env spread) and two more, each with its torch
# twin: `jax.random.PRNGKey(0)` becomes `torch.manual_seed(0)` on the same
# line, so the port's RPR001 stands where the reference's fires.
_LOOP = ("import jax\n"
         "def f(xs):\n"
         "    for x in xs:\n"
         "        k = jax.random.PRNGKey(0)"
         "  # rpr"  # the marker split: this file's own lines waive nothing
         ": ignore[{code}] -- {why}\n"
         "        yield k\n")
WAIVER_CASES = {
    "reasoned waiver suppresses": _LOOP.format(
        code="RPR001", why="test corpus needs a fixed key"),
    "wrong code does not suppress": _LOOP.format(
        code="RPR005", why="mismatched code"),
    "bare re-raise is not swallowing": ("def f(fn):\n"
                                        "    try:\n"
                                        "        return fn()\n"
                                        "    except Exception:\n"
                                        "        raise\n"),
    "env spread is clean": ("import os, subprocess\n"
                            "def f(cmd):\n"
                            "    return subprocess.run(cmd,"
                            " env={**os.environ, 'X': '1'})\n"),
    "reasonless waiver is reported": ("def f(fn):\n"
                                      "    try:\n"
                                      "        fn()\n"
                                      "    except Exception:  # rpr"
                                      ": ignore[RPR003]\n"
                                      "        return None\n"),
    "standalone waiver covers the next line": (
        "def f(fn):\n"
        "    try:\n"
        "        fn()\n"
        "    # rpr: ignore[RPR003] -- the case under test\n"
        "    except Exception:\n"
        "        return None\n"),
}


def _torch_twin(src: str) -> str:
    return src.replace("import jax\n", "import torch\n").replace(
        "jax.random.PRNGKey(0)", "torch.manual_seed(0)")


@pytest.mark.parametrize("case", sorted(WAIVER_CASES))
def test_waiver_cases_match_the_reference(case):
    src = WAIVER_CASES[case]
    want = _pairs(ref_lints.lint_source(src))
    assert _pairs(lints.lint_source(_torch_twin(src))) == want
    # and the shared rules agree on the untranslated source
    assert _pairs(lints.lint_source(src), SHARED_CODES) == \
        _pairs(ref_lints.lint_source(src), SHARED_CODES)


def test_torch_fixture_fires_every_planted_rule_where_planted():
    src = TORCH_FIXTURE.read_text()
    planted = sorted(
        (m.group(1), i) for i, line in enumerate(src.splitlines(), 1)
        for m in [re.search(r"# expect: (RPR\d+)", line)] if m)
    got = _pairs(lints.lint_source(src, str(TORCH_FIXTURE)))
    assert got == planted
    counts = {c: sum(1 for x, _ in got if x == c) for c, _ in got}
    assert counts == {"RPR000": 1, "RPR001": 2, "RPR003": 2, "RPR004": 3}


HOST_READ_IN_A_DECODE_LOOP = (
    "def drive(model, state, toks):\n"
    "    for _ in range(4):\n"
    "        logits, state = model.decode_step(state, toks)\n"
    "        toks = logits.argmax(-1).cpu()\n")


@pytest.mark.parametrize("path, fires", [
    ("src/repro_torch/serving/loop.py", True),
    ("chip_smoke.py", True),
    ("tests/fixtures/rpr_torch/lint_violations.py", True),
    ("tests/test_torch_engine.py", False),
    ("tests/torch_mem_ranks.py", False),
])
def test_rpr004_leaves_test_modules_out(path, fires):
    """A parity test's host read is the test itself: RPR004 reads every
    file but those directly in ``tests``, fixtures included."""
    got = _pairs(lints.lint_source(HOST_READ_IN_A_DECODE_LOOP, path))
    assert got == ([("RPR004", 4)] if fires else [])


def test_fixtures_are_excluded_from_every_directory_scan():
    tests = str(REPO / "tests")
    for scan in (lints.iter_python_files, ref_lints.iter_python_files):
        files = scan([tests])
        assert TORCH_FIXTURE not in files and REF_FIXTURE not in files
    assert TORCH_FIXTURE not in lints.iter_python_files(
        lints.default_lint_paths())
    assert lints.iter_python_files([str(TORCH_FIXTURE)]) == [TORCH_FIXTURE]


def test_port_tree_lints_clean():
    roots = lints.default_lint_paths()
    assert str(REPO / "src" / "repro_torch") in roots
    assert str(REPO / "chip_smoke.py") in roots
    assert lints.lint_paths() == []


def test_lints_import_no_torch():
    """The lint pass needs no device: its module imports the standard
    library and the package's ``Finding`` only."""
    src = (REPO / "src" / "repro_torch" / "analysis" / "lints.py"
           ).read_text()
    imports = re.findall(r"^\s*(?:import|from)\s+([\w.]+)", src, re.M)
    assert not [m for m in imports if m.split(".")[0] in ("torch", "numpy")]


# ------------------------------------------------- the dispatch-trace audit
BIG = 4096


def _codes(findings):
    return sorted(f.code for f in findings)


def test_jxp001_widening_of_a_cache_sized_tensor():
    cache = torch.zeros((2, 64, 4, 16), dtype=torch.bfloat16)
    found = trace_audit.audit_call(lambda c: c.float(), "f", cache,
                                   big_elems=BIG)
    assert _codes(found) == ["JXP001"]
    # type-promoting arithmetic widens the same way
    found = trace_audit.audit_call(
        lambda c: c + torch.ones((), dtype=torch.float32).expand(c.shape),
        "f", cache, big_elems=BIG)
    assert "JXP001" in _codes(found)


def test_jxp001_narrowing_and_small_casts_are_fine():
    big = torch.zeros((2, 64, 4, 16), dtype=torch.float32)
    assert trace_audit.audit_call(lambda c: c.to(torch.bfloat16), "f", big,
                                  big_elems=BIG) == []
    small = torch.zeros((2, 4, 16), dtype=torch.bfloat16)
    assert trace_audit.audit_call(lambda c: c.float(), "f", small,
                                  big_elems=BIG) == []


def test_jxp002_host_syncs():
    x = torch.arange(8.0)
    assert _codes(trace_audit.audit_call(lambda t: t.sum().item(), "f",
                                         x)) == ["JXP002"]
    assert _codes(trace_audit.audit_call(lambda t: t[t > 3], "f",
                                         x)) == ["JXP002"]
    assert "JXP002" in _codes(trace_audit.audit_call(
        lambda t: torch.nonzero(t), "f", x))
    # masked arithmetic keeps its shape: no sync
    assert trace_audit.audit_call(
        lambda t: torch.where(t > 3, t, 0.0).sum(), "f", x) == []


def test_hot_functions_trace_clean_on_the_cpu():
    assert trace_audit.audit_hot_functions(device="cpu") == []


def test_hot_functions_run_the_plain_resident_version_on_the_cpu():
    """The fourth hot call is the resident wrapper's dispatch; on CPU
    tensors it runs the plain version and launches nothing."""
    from repro_torch.kernels.decode_attention import \
        decode_attention_resident
    setup = step_audit.build_audit_setup(device="cpu")
    calls = {name: (fn, args)
             for name, fn, args in trace_audit.hot_calls(setup)}
    assert sorted(calls) == ["decode_attention_resident", "decode_step",
                             "insert_slot", "prefill_bucketed"]
    before = decode_attention_resident.launches
    fn, args = calls["decode_attention_resident"]
    out, ops = trace_audit.record(fn, *args)
    assert decode_attention_resident.launches == before
    assert out.shape == (2, 1, 4, 16) and ops


# ------------------------------------------------------ the step audit
@pytest.fixture(scope="module")
def dense():
    return step_audit.build_audit_setup(device="cpu")


def _run(setup, step):
    state = trace_audit.clone_tree(setup["state"])
    found, _, _ = step_audit.check_call("decode_step", step, state,
                                        setup["params"], setup["params"],
                                        state, setup["tokens"])
    return found


def test_decode_step_is_in_place_and_copies_nothing(dense):
    assert _run(dense, dense["model"].decode_step) == []


def test_hlo002_a_step_that_clones_the_cache(dense):
    m = dense["model"]

    def cloning(params, state, tokens):
        backup = {n: t.clone() for n, t in state["cache"].items()}
        out = m.decode_step(params, state, tokens)
        del backup
        return out

    assert _codes(_run(dense, cloning)) == ["HLO002", "HLO002"]


def test_hlo001_a_step_that_returns_a_fresh_cache(dense):
    m = dense["model"]

    def functional(params, state, tokens):
        logits, state = m.decode_step(params, state, tokens)
        state["cache"] = {n: t + 0 for n, t in state["cache"].items()}
        return logits, state

    found = _run(dense, functional)
    assert _codes(found) == ["HLO001", "HLO001"]
    assert {f.where for f in found} == {"decode_step/cache/k",
                                        "decode_step/cache/v"}


@pytest.mark.parametrize("entry", ["build_audit_setup",
                                   "audit_hot_functions", "audit_step"])
def test_audit_entry_points_want_the_gpu_unless_asked_for_the_cpu(entry):
    """The audit builds its model on the card unless asked for the CPU
    (``device="cpu"``, as every test here asks), raising without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None audits on it")
    fn = getattr(trace_audit if entry == "audit_hot_functions"
                 else step_audit, entry)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def test_step_audit_clean_on_the_cpu():
    assert step_audit.audit_step(device="cpu") == []


def test_prefill_ladder_is_bounded_by_the_buckets(dense):
    ladder = step_audit.prefill_ladder(dense)
    assert ladder == {"prefill_lowerings": 4, "n_buckets": 4,
                      "insert_lowerings": 1}
    # the ladder put the engine's state back as it found it
    assert not dense["state"]["pos"].any()


def test_budgets_fail_closed_on_missing_file(tmp_path):
    found = step_audit.audit_budgets(tmp_path / "absent.json", device="cpu")
    assert len(found) == 1 and found[0].code == "HLO004"
    assert "--update-baselines" in found[0].message


def test_budgets_fail_closed_on_missing_key(tmp_path):
    p = tmp_path / "partial.json"
    p.write_text(json.dumps({"decode_step": {"dot_flops": 1e12}}))
    found = step_audit.audit_budgets(p, device="cpu")
    assert found and all(f.code == "HLO004" for f in found)
    assert any("op_bytes" in f.where for f in found)


def test_budgets_catch_regression(tmp_path):
    p = tmp_path / "tight.json"
    p.write_text(json.dumps(
        {"decode_step": {k: 0.0 for k in step_audit.TOLERANCES}}))
    found = step_audit.audit_budgets(p, device="cpu")
    assert any(f.code == "HLO004" and "dot_flops" in f.where
               for f in found)


def test_committed_baselines_pass():
    assert step_audit.BASELINES_PATH.exists()
    doc = json.loads(step_audit.BASELINES_PATH.read_text())
    assert {"decode_step", "paged_decode_step", "moe_decode_step"} <= set(doc)
    assert step_audit.audit_budgets(device="cpu") == []


# ------------------------------------------------------------------- the CLI
def test_cli_lint_pass_clean_repo_exits_zero(capsys):
    assert analysis_main(["lint"]) == 0
    assert "lint: clean" in capsys.readouterr().out


def test_cli_all_passes_clean_on_the_cpu(capsys):
    assert analysis_main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert all(f"{p}: clean" in out for p in ("lint", "trace", "step"))


def test_cli_lint_pass_fixture_exits_nonzero(capsys):
    rc = analysis_main(["lint", "--paths", str(TORCH_FIXTURE)])
    assert rc == 1
    out = capsys.readouterr().out
    assert "RPR004" in out and "FAILED" in out


def test_cli_unknown_pass_rejected():
    with pytest.raises(SystemExit):
        analysis_main(["jaxpr"])


def test_cli_json_output_is_parseable(capsys):
    rc = analysis_main(["lint", "--json", "--paths", str(TORCH_FIXTURE)])
    assert rc == 1
    rows = json.loads(capsys.readouterr().out)
    assert {"code", "where", "message"} <= set(rows[0])


def test_finding_str():
    f = Finding("RPR001", "x.py:3", "seed reuse")
    assert str(f) == "RPR001 x.py:3: seed reuse"


# ------------------------------------------- the ServingEngine(buckets=) repair
AUDIT_BUCKETS = (8, 16, 32, 64)
PROMPT_LENS = (5, 12, 20, 40, 60, 3)


@pytest.fixture(scope="module")
def bucket_runs():
    import jax
    from repro.models.api import build_model as jax_build_model
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.weights import params_from_jax
    from tests.conftest import reduced_config

    cfg_j = reduced_config("llama3-8b", n_layers=2, n_kv_heads=2)
    cfg_t = get_config("llama3-8b").with_overrides(
        **dataclasses.asdict(cfg_j))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 97, size=n) for n in PROMPT_LENS]

    def drive(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=3)
        while eng.step():
            pass
        return {r.rid: r.out_tokens for r in eng.finished}

    kw = dict(n_slots=2, max_seq=64, lam=10 ** 9, seed=0,
              buckets=AUDIT_BUCKETS)
    ref = JaxEngine(cfg_j, **kw)
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build_model(cfg_j).init)(jax.random.PRNGKey(0)))
    port = ServingEngine(cfg_t, device="cpu",
                         params=params_from_jax(params, "cpu"), **kw)
    return ref, drive(ref), port, drive(port)


def test_buckets_choose_the_reference_bucket_for_every_length(bucket_runs):
    ref, _, port, _ = bucket_runs
    assert list(port.buckets) == list(ref.buckets) == list(AUDIT_BUCKETS)
    assert [port._bucket(n) for n in range(1, 65)] == \
        [ref._bucket(n) for n in range(1, 65)]


def test_buckets_streams_and_buckets_used_equal_reference(bucket_runs):
    ref, ref_streams, port, streams = bucket_runs
    assert len(streams) == len(PROMPT_LENS)
    assert streams == ref_streams
    assert port.prefill_buckets_used == ref.prefill_buckets_used \
        == set(AUDIT_BUCKETS)


def test_buckets_are_sorted_and_deduplicated():
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine, default_buckets
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
        vocab_size=50, dtype="float32", param_dtype="float32")
    eng = ServingEngine(cfg, n_slots=2, max_seq=64, device="cpu",
                        buckets=(64, 16, 8, 16, 32))
    assert eng.buckets == [8, 16, 32, 64]
    assert ServingEngine(cfg, n_slots=2, max_seq=64, device="cpu"
                         ).buckets == default_buckets(64)
