"""Repo-invariant AST lints of the port (RPR0xx) — stdlib only, no torch
import.  Counterpart of the JAX package's ``analysis/lints.py``, with the
same codes, ``Finding`` records and waiver syntax, its rules rewritten for
eager PyTorch code:

RPR000  A waiver without a reason (as the reference).
RPR001  Per-step or counter seeding: ``torch.manual_seed(...)``,
        ``torch.cuda.manual_seed*(...)`` or ``<Generator>.manual_seed(...)``
        inside a ``for``/``while`` body (the same, or a correlated
        loop-index, stream every iteration), or seeded off a mutable
        counter attribute whose name does not say ``seed``
        (``gen.manual_seed(self.decode_steps)`` — the reference's sampler
        collision, in torch).  Seed one generator once and draw
        from it.
RPR003  A broad ``except``/``except Exception`` that swallows the fault:
        the handler neither binds the exception nor uses it (as the
        reference).
RPR004  A host round trip on a per-step value — ``.item()``,
        ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray`` or
        ``float()``/``int()`` of a computed value — inside a loop of a
        function that drives the hot path: one that calls a ``*_jit`` or
        ``jit`` callable (as the reference), or ``decode_step``,
        ``prefill``, ``prefill_bucketed``, ``insert_slot`` or ``step``.  On
        a CUDA tensor each is a device sync per iteration.  Test modules
        (files directly in a ``tests`` directory) are out of its scope: a
        parity test's host read is the test itself.  The reference's
        linter still runs its own RPR004 over them.

The reference's other two rules are about JAX and are left out: RPR002
(a child process's ``env=`` that drops ``JAX_PLATFORMS``) and RPR005
(``jax.jit`` of a state-carrying function without ``donate_argnums``).
The reference's linter already runs them over the whole tree, this
package's files included; the port's counterpart of RPR005 is the step
audit's HLO001 and HLO002 (``step_audit``), which check the state's
storage itself.

Waivers: end the offending line (or the line above) with
``# rpr: ignore[RPR00N] -- reason``.  The reason is mandatory; a
reasonless waiver is itself reported (RPR000).  ``[RPR00N]`` may list
several comma-separated codes; omitting it waives every code on that
line.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, List, Sequence

from repro_torch.analysis import Finding

# calls that make a function drive the hot path (RPR004's scope)
HOT_CALLS = {"decode_step", "prefill", "prefill_bucketed", "insert_slot",
             "step"}
# method calls that bring a tensor's value to the host
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
HOST_ROUNDTRIP_NAMES = {"float", "int"}
SEEDING_CALLS = {"manual_seed", "manual_seed_all"}
SEEDISH = re.compile(r"seed", re.I)
_WAIVER_RE = re.compile(
    r"#\s*rpr:\s*ignore(?:\[(?P<codes>[A-Z0-9,\s]+)\])?"
    r"(?:\s*(?:--|—|:)\s*(?P<reason>\S.*))?")

# paths never linted: seeded-violation fixtures + VCS/venv noise
EXCLUDED_PARTS = {"fixtures", ".git", ".venv", "__pycache__",
                  "node_modules", ".claude"}

REPO_ROOT = Path(__file__).resolve().parents[3]
# the port's own files, relative to the root of the checkout (globs)
DEFAULT_LINT_PATHS = ("src/repro_torch", "chip_smoke.py",
                      "tests/test_torch_*.py", "tests/torch_*.py",
                      "scripts/port_*.py")


def default_lint_paths(root: Path = REPO_ROOT) -> List[str]:
    """The port's lint roots under ``root``, globs expanded."""
    out: List[str] = []
    for pattern in DEFAULT_LINT_PATHS:
        out.extend(str(p) for p in sorted(root.glob(pattern)))
    return out


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.manual_seed' for Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        return ""
    return ".".join(reversed(parts))


def _tail(node: ast.AST) -> str:
    """The last name of a call target: 'manual_seed' of
    ``torch.Generator().manual_seed`` as of ``torch.manual_seed``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


class _Waivers:
    def __init__(self, source: str):
        self.by_line = {}
        self.findings: List[Finding] = []
        lines = source.splitlines()
        for i, line in enumerate(lines, start=1):
            m = _WAIVER_RE.search(line)
            if not m:
                continue
            codes = frozenset(
                c.strip() for c in (m.group("codes") or "").split(",")
                if c.strip()) or None           # None = waive any code
            self._add(i, codes)
            if line.lstrip().startswith("#"):
                # standalone waiver comment (possibly a multi-line block):
                # it covers the first code line below it
                j = i
                while j < len(lines) and \
                        (not lines[j].strip()
                         or lines[j].lstrip().startswith("#")):
                    j += 1
                self._add(j + 1, codes)
            if not (m.group("reason") or "").strip():
                self.findings.append(Finding(
                    "RPR000", f"{{path}}:{i}",
                    "waiver without a reason — write "
                    "`# rpr: ignore[CODE] -- why this hit is intended`"))

    def _add(self, line: int, codes):
        prev = self.by_line.get(line, frozenset())
        if codes is None or prev is None:
            self.by_line[line] = None
        else:
            self.by_line[line] = prev | codes

    def covers(self, line: int, code: str) -> bool:
        codes = self.by_line.get(line, False)
        return codes is not False and (codes is None or code in codes)


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.findings: List[Finding] = []
        self.waivers = _Waivers(source)
        self.loop_depth = 0
        # per function: does it drive the hot path (RPR004's scope)?
        self._fn_stack: List[bool] = []
        self.host_reads = Path(path).parent.name != "tests"

    def _emit(self, code: str, node: ast.AST, msg: str):
        line = getattr(node, "lineno", 0)
        if self.waivers.covers(line, code):
            return
        self.findings.append(Finding(code, f"{self.path}:{line}", msg))

    # --------------------------------------------------------------- scopes
    def _visit_fn(self, node):
        drives = False
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                t = _tail(n.func)
                if t.endswith("_jit") or t == "jit" or t in HOT_CALLS:
                    drives = True
                    break
        self._fn_stack.append(drives)
        saved, self.loop_depth = self.loop_depth, 0
        self.generic_visit(node)
        self.loop_depth = saved
        self._fn_stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _visit_loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop

    # ---------------------------------------------------------------- rules
    def visit_Call(self, node: ast.Call):
        self._rule_seeding(node)
        if self.host_reads:
            self._rule_host_roundtrip(node)
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        self._rule_swallowed_except(node)
        self.generic_visit(node)

    # RPR001 ---------------------------------------------------------------
    def _rule_seeding(self, node: ast.Call):
        if _tail(node.func) not in SEEDING_CALLS:
            return
        what = _dotted(node.func) or f"….{_tail(node.func)}"
        if self.loop_depth > 0:
            self._emit("RPR001", node,
                       f"{what}(...) inside a loop — the same (or a "
                       "correlated loop-index) random stream every "
                       "iteration; seed one generator once and draw from "
                       "it")
            return
        for arg in node.args:
            attrs = [n.attr for n in ast.walk(arg)
                     if isinstance(n, ast.Attribute)]
            if attrs and not any(SEEDISH.search(a) for a in attrs):
                self._emit("RPR001", node,
                           f"{what}({ast.unparse(arg)}) seeds off mutable "
                           "state — a counter revisits values across call "
                           "sites (the reference's sampler collision); "
                           "seed once from a seed-derived value")

    # RPR003 ---------------------------------------------------------------
    def _rule_swallowed_except(self, node: ast.ExceptHandler):
        broad = node.type is None or _tail(node.type) in (
            "Exception", "BaseException")
        if not broad:
            return
        # a pure re-raise handler propagates the fault — nothing swallowed
        if len(node.body) == 1 and isinstance(node.body[0], ast.Raise) \
                and node.body[0].exc is None:
            return
        if node.name is None:
            self._emit("RPR003", node,
                       "broad except without binding the exception — the "
                       "fault's type/message cannot reach any log "
                       "(applied/reason, monitor events); bind `as e` "
                       "and record it")
            return
        used = any(isinstance(n, ast.Name) and n.id == node.name
                   for stmt in node.body for n in ast.walk(stmt))
        if not used:
            self._emit("RPR003", node,
                       f"broad except binds `{node.name}` but never uses "
                       "it — record the exception type/message before "
                       "continuing")

    # RPR004 ---------------------------------------------------------------
    def _rule_host_roundtrip(self, node: ast.Call):
        if self.loop_depth == 0 or not (self._fn_stack and
                                        self._fn_stack[-1]):
            return
        t = _tail(node.func)
        hit = None
        if t in HOST_METHODS and isinstance(node.func, ast.Attribute):
            hit = f".{t}()"
        elif _dotted(node.func) in ("np.asarray", "numpy.asarray",
                                    "onp.asarray"):
            hit = "np.asarray"
        elif isinstance(node.func, ast.Name) and t in HOST_ROUNDTRIP_NAMES:
            # float()/int() of a literal or len() is host-side anyway;
            # flag conversions of computed/indexed values only
            if node.args and not isinstance(node.args[0], ast.Constant) \
                    and not (isinstance(node.args[0], ast.Call)
                             and _tail(node.args[0].func) == "len"):
                hit = f"{t}()"
        if hit:
            self._emit("RPR004", node,
                       f"{hit} inside the stepping loop of a function "
                       "that drives the hot path — on a CUDA tensor a "
                       "device sync per iteration; keep the value on the "
                       "device or hoist the transfer out of the loop")


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("RPR999", f"{path}:{e.lineno}",
                        f"syntax error stops linting: {e.msg}")]
    linter = _FileLinter(path, source)
    linter.visit(tree)
    out = linter.findings + [
        Finding(f.code, f.where.format(path=path), f.message)
        for f in linter.waivers.findings]
    return sorted(out, key=lambda f: (f.where, f.code))


def iter_python_files(roots: Sequence[str]) -> List[Path]:
    files: List[Path] = []
    for root in roots:
        p = Path(root)
        if p.is_file() and p.suffix == ".py":
            files.append(p)
            continue
        for f in sorted(p.rglob("*.py")):
            if not EXCLUDED_PARTS.intersection(f.parts):
                files.append(f)
    return files


def lint_paths(roots: Iterable[str] = None) -> List[Finding]:
    """Every finding under ``roots`` (default: the port's own files,
    ``default_lint_paths``)."""
    findings: List[Finding] = []
    roots = default_lint_paths() if roots is None else list(roots)
    for f in iter_python_files(roots):
        findings.extend(lint_source(f.read_text(), str(f)))
    return findings
