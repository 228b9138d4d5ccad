"""Step audit of the port's serving hot path (HLO0xx findings) —
counterpart of the JAX package's ``analysis/hlo_audit.py``, which reads
the compiled HLO of the engine's jitted decode.  The port runs eagerly, so
the audit runs the engine's own model calls once each and watches the
state's storage and the ops they dispatch (``trace_audit.OpRecorder``):

HLO001  A cache not updated in place: a cache leaf of the state (K/V
        values, int8 scales, a VLM's image K/V, a paged store) whose
        storage ``data_ptr()`` differs after ``decode_step``,
        ``insert_slot`` or a paged prefill chunk.  A step that returns a
        fresh cache holds two full caches at once — the memory Algorithm 1
        partitions.  On the card the step's rise of
        ``torch.cuda.max_memory_allocated`` must also stay under the
        cache's bytes (``memory_rise``), the reference's own threshold.
HLO002  A full-cache copy: a dispatched ``clone``, ``copy_``, ``_to_copy``
        or ``contiguous`` that reads a cache leaf or a parameter and
        allocates at least the cache's bytes — the state duplicated
        instead of written in place.
HLO003  The shape ladder: distinct prefill traces (the sequence of
        dispatched ops with their shapes and dtypes) over prompts of every
        length from 1 to ``max_seq`` must number ``len(buckets)``; the
        paged engine's chunked prefill, over (row, start, length)
        variations, one; ``insert_slot`` (the paged engine's page mount)
        one for both slots.  A shape of its own per prompt would defeat
        CUDA graphs and every shape-keyed cache on the card.
HLO004  The budgets: ``measure``, ``measure_paged`` and ``measure_moe``
        against the committed ``baselines.json`` with the reference's
        tolerances, fail-closed on a missing file or key.  ``dot_flops``
        counts the step's matmul FLOPs (``FlopCounterMode``);
        ``collective_ops`` the c10d ops it dispatches (0 on one rank);
        ``prefill_lowerings`` and ``insert_lowerings`` the traces above;
        ``full_cache_param_copies`` HLO002's copies; ``aliased_outputs``
        the state leaves the step returns in their own storage; and
        ``op_bytes``, in place of XLA's ``hbm_bytes``, the sum of each
        dispatched op's operand and result bytes (views excluded): an
        unfused upper bound of the step's memory traffic, not XLA's count.

The setups take the reference's configs and engine arguments exactly
(``hlo_audit.py:51-131``) and are built on the plain path
(``use_kernel=False``), as the reference audits its ``jnp`` path; they
are memoized per device.  The plain path's counts do not depend on the
device, but for ``op_bytes``: the CPU's ``F.one_hot`` (the MoE combine's
owner map, ``models/moe.py``) checks its indices' range with a min, a
max and two scalar reads that the card's does not dispatch, 192 B of the
MoE step's 2.1 MB.  One ``baselines.json`` gates the CPU and the card,
``op_bytes`` at its tolerance.  Refresh
the budgets after an intended change:
``PYTHONPATH=src python -m repro_torch.analysis step --update-baselines
--device cpu``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.analysis import Finding
from repro_torch.analysis.trace_audit import (OpRecord, clone_tree,
                                              record)
from repro_torch.device import resolve_device
from repro_torch.tree import flatten

BASELINES_PATH = Path(__file__).with_name("baselines.json")
REFRESH_CMD = ("PYTHONPATH=src python -m repro_torch.analysis step "
               "--update-baselines --device cpu")
# relative headroom before a drift fails (the reference's, with op_bytes
# taking hbm_bytes' share): FLOPs are fixed by the model, the op bytes
# move with torch's decompositions
TOLERANCES = {"dot_flops": 0.10, "op_bytes": 0.30, "collective_ops": 0.0,
              "prefill_lowerings": 0.0, "full_cache_param_copies": 0.0}
COPY_OPS = {"clone", "copy_", "_to_copy", "contiguous", "copy"}
COLLECTIVE_NAMESPACES = {"c10d", "_c10d_functional", "c10d_functional",
                         "_c10d_functional_autograd"}

AUDIT_BUCKETS = (8, 16, 32, 64)
_CACHE: Dict[Any, dict] = {}


def _key(name: str, device) -> tuple:
    return name, str(resolve_device(device))


def build_audit_setup(device=None) -> dict:
    """The shared audit fixture: the reference's audit-tiny dense model
    served by ``ServingEngine`` (2 slots, max_seq 64, buckets 8-64) and
    the decode, prefill and insert arguments (memoized per device)."""
    key = _key("setup", device)
    if key in _CACHE:
        return _CACHE[key]
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serving.engine import ServingEngine

    dev = resolve_device(device)
    cfg = ModelConfig(
        name="audit-tiny", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab_size=256,
        rope_theta=10_000.0, norm_eps=1e-5)
    eng = ServingEngine(cfg, n_slots=2, max_seq=64, lam=16, seed=0,
                        buckets=AUDIT_BUCKETS, device=dev)
    m, params = eng.model, eng.params
    Lb = AUDIT_BUCKETS[1]
    setup = {
        "cfg": cfg, "engine": eng, "model": m, "params": params,
        "state": eng.state,
        "tokens": torch.zeros((2,), dtype=torch.int32, device=dev),
        "buckets": AUDIT_BUCKETS,
        "bucket_state": m.init_decode_state(params, 1, Lb, per_slot=True),
        "bucket_tokens": torch.zeros((1, Lb), dtype=torch.int32,
                                     device=dev),
        "bucket_lengths": torch.tensor([Lb // 2], dtype=torch.int32,
                                       device=dev),
        "sub_state": m.init_decode_state(params, 1, Lb, per_slot=True),
    }
    _CACHE[key] = setup
    return setup


def build_paged_audit_setup(device=None) -> dict:
    """The paged twin: the same audit-tiny config through the paged engine
    (pages of 8), its chunk tokens and a page-table row (memoized)."""
    key = _key("paged_setup", device)
    if key in _CACHE:
        return _CACHE[key]
    from repro_torch.serving.engine import ServingEngine

    dev = resolve_device(device)
    cfg = build_audit_setup(device)["cfg"]
    eng = ServingEngine(cfg, n_slots=2, max_seq=64, lam=16, seed=0,
                        paged=True, page_size=8, device=dev)
    setup = {
        "cfg": cfg, "engine": eng, "model": eng.model,
        "params": eng.params, "state": eng.state,
        "tokens": torch.zeros((2,), dtype=torch.int32, device=dev),
        "chunk_tokens": torch.zeros((1, eng.prefill_chunk),
                                    dtype=torch.int32, device=dev),
        "page_row": np.zeros((eng.pages_per_slot,), np.int32),
    }
    _CACHE[key] = setup
    return setup


def build_moe_audit_setup(device=None) -> dict:
    """The MoE twin: a reduced mixtral (4 experts, top-2, window 128 above
    max_seq 64 so the cache stays linear, float32) under the same engine
    arguments (memoized)."""
    key = _key("moe_setup", device)
    if key in _CACHE:
        return _CACHE[key]
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine

    dev = resolve_device(device)
    cfg = get_config("mixtral-8x7b").with_overrides(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256, n_experts=4, sliding_window=128,
        dtype="float32", param_dtype="float32")
    eng = ServingEngine(cfg, n_slots=2, max_seq=64, lam=16, seed=0,
                        buckets=AUDIT_BUCKETS, device=dev)
    m = eng.model
    setup = {
        "cfg": cfg, "engine": eng, "model": m, "params": eng.params,
        "state": eng.state,
        "tokens": torch.zeros((2,), dtype=torch.int32, device=dev),
        "buckets": AUDIT_BUCKETS,
        "sub_state": m.init_decode_state(eng.params, 1, AUDIT_BUCKETS[1],
                                         per_slot=True),
    }
    _CACHE[key] = setup
    return setup


# --------------------------------------------------------------- the state
def _leaves(tree, prefix=()) -> List[Tuple[str, torch.Tensor]]:
    """("a/b/c", tensor) of every tensor leaf, in ``tree.flatten``'s
    order."""
    return [("/".join(p), t) for p, t in flatten(tree, prefix).items()
            if isinstance(t, torch.Tensor)]


def cache_leaves(state) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every cache buffer of a decode state: the K/V
    values and int8 scales (a paged store's too), a ring's positions, and
    a VLM's image K/V."""
    return _leaves(state.get("cache", {}), ("cache",)) \
        + _leaves(state.get("img_kv", {}), ("img_kv",))


def cache_bytes_of(state) -> int:
    """The reference's cache bytes: the K buffer's (values only)."""
    k = state["cache"]["k"]
    return k.numel() * k.element_size()


def _ptrs(pairs) -> Dict[str, int]:
    return {p: t.untyped_storage().data_ptr() for p, t in pairs}


def cache_ptrs(state) -> Dict[str, int]:
    """{path: storage pointer} of every cache leaf of ``state``."""
    return _ptrs(cache_leaves(state))


def check_in_place(name: str, before: Dict[str, int], state
                   ) -> List[Finding]:
    """HLO001: every cache leaf of ``state`` still in the storage it had
    (``before``: ``_ptrs`` of ``cache_leaves`` before the call)."""
    after = cache_ptrs(state)
    return [Finding(
        "HLO001", f"{name}/{p}",
        f"cache leaf `{p}` moved to new storage over the call — the state "
        f"is not updated in place, so the step holds a second cache while "
        f"it runs; write the buffer in place")
        for p, ptr in before.items() if after.get(p) != ptr]


def full_cache_copies(ops: List[OpRecord], sources: set, cache_bytes: int
                      ) -> List[OpRecord]:
    """HLO002's ops: a copy that reads a storage of ``sources`` (cache
    leaves, parameters) and writes at least ``cache_bytes`` into storage
    none of its inputs holds."""
    out = []
    for op in ops:
        if op.name not in COPY_OPS:
            continue
        if not any(i.storage in sources for i in op.inputs):
            continue
        held = {i.storage for i in op.inputs}
        if any(o.nbytes >= cache_bytes and o.storage not in held
               for o in op.outputs):
            out.append(op)
    return out


def copy_findings(name: str, ops: List[OpRecord], sources: set,
                  cache_bytes: int) -> List[Finding]:
    """HLO002's findings over one call's ops."""
    return [Finding(
        "HLO002", f"{name}/{op.func}",
        f"full-cache copy ({max(o.nbytes for o in op.outputs)} B) of a "
        f"cache leaf or parameter — the state is duplicated instead of "
        f"updated in place")
        for op in full_cache_copies(ops, sources, cache_bytes)]


def storages(*trees) -> set:
    """The storage pointers of every tensor of ``trees``."""
    return {t.untyped_storage().data_ptr() for tree in trees
            for _, t in _leaves(tree)}


def check_call(name: str, fn: Callable, state, params, *args
               ) -> Tuple[List[Finding], List[OpRecord], Any]:
    """Run ``fn(*args)`` once — ``state`` is the decode state it writes —
    and check HLO001 and HLO002.  Returns (findings, ops, result)."""
    before = cache_ptrs(state)
    sources = storages(state, params)
    out, ops = record(fn, *args)
    new_state = out[1] if isinstance(out, tuple) else out
    findings = check_in_place(name, before, new_state)
    findings += copy_findings(name, ops, sources, cache_bytes_of(state))
    return findings, ops, out


def memory_rise(fn: Callable, *args) -> int:
    """Bytes ``torch.cuda.max_memory_allocated`` rises by over one call of
    ``fn(*args)`` on the card (the call's transients and anything it
    leaves allocated)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


# ----------------------------------------------------------------- ladders
def trace_key(ops: List[OpRecord]) -> int:
    """One "lowering": the dispatched ops with their shapes and dtypes."""
    return hash(tuple((op.func, tuple((i.shape, i.dtype) for i in op.inputs))
                      for op in ops))


def _restore(dst, src):
    """Copy ``src``'s tensors into ``dst``'s, in place."""
    for (_, d), (_, s) in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


def prefill_ladder(setup: dict) -> Dict[str, int]:
    """Distinct prefill traces over prompts of every length 1..max_seq,
    each through the engine's own admission prefill (``_prefill_dense``:
    the bucketed prefill and its insert), and distinct ``insert_slot``
    traces for slots 0 and 1.  The engine's state is put back after
    (memoized in the setup)."""
    if "_ladder" in setup:
        return setup["_ladder"]
    from repro_torch.serving.engine import Request
    eng, m = setup["engine"], setup["model"]
    inner = m.prefill_bucketed
    seen = set()

    def traced(*a):
        out, ops = record(inner, *a)
        seen.add(trace_key(ops))
        return out

    saved = clone_tree(eng.state)
    m.prefill_bucketed = traced
    try:
        rng = np.random.default_rng(0)
        for n in range(1, eng.max_seq + 1):
            req = Request(0, rng.integers(0, setup["cfg"].vocab_size, n
                                          ).astype(np.int32), 1)
            eng._prefill_dense(0, req)
    finally:
        del m.prefill_bucketed
        _restore(eng.state, saved)
    inserts = set()
    for slot in (0, 1):
        _, ops = record(m.insert_slot, clone_tree(setup["state"]),
                        clone_tree(setup["sub_state"]), slot)
        inserts.add(trace_key(ops))
    setup["_ladder"] = {"prefill_lowerings": len(seen),
                        "n_buckets": len(setup["buckets"]),
                        "insert_lowerings": len(inserts)}
    return setup["_ladder"]


def paged_ladder(setup: dict) -> Dict[str, int]:
    """Distinct chunk-prefill traces over the reference's (row, start,
    length) variations, and distinct page-mount traces for rows 0 and 1
    (memoized in the setup)."""
    if "_ladder" in setup:
        return setup["_ladder"]
    m, params = setup["model"], setup["params"]
    seen = set()
    for row, start, length in ((0, 0, 3), (1, 8, 8), (0, 16, 1)):
        _, ops = record(m.prefill_paged, params, clone_tree(setup["state"]),
                        setup["chunk_tokens"], row, start, length)
        seen.add(trace_key(ops))
    mounts = set()
    for row in (0, 1):
        _, ops = record(m.mount_slot_pages, clone_tree(setup["state"]), row,
                        setup["page_row"], 0)
        mounts.add(trace_key(ops))
    setup["_ladder"] = {"prefill_lowerings": len(seen),
                        "mount_lowerings": len(mounts)}
    return setup["_ladder"]


# ----------------------------------------------------------------- budgets
def _decode_numbers(setup: dict) -> Dict[str, float]:
    """dot_flops, collective_ops, full_cache_param_copies, aliased_outputs
    and op_bytes of one decode step over a copy of the setup's state."""
    from torch.utils.flop_counter import FlopCounterMode
    m, params = setup["model"], setup["params"]
    state = clone_tree(setup["state"])
    leaves = _ptrs(_leaves(state))
    sources = storages(state, params)
    with FlopCounterMode(display=False) as flops:
        (_, new_state), ops = record(m.decode_step, params, state,
                                     setup["tokens"])
    kept = _ptrs(_leaves(new_state))
    return {
        "dot_flops": float(flops.get_total_flops()),
        "collective_ops": float(sum(op.namespace in COLLECTIVE_NAMESPACES
                                    for op in ops)),
        "full_cache_param_copies": float(len(full_cache_copies(
            ops, sources, cache_bytes_of(state)))),
        "aliased_outputs": float(sum(kept.get(p) == ptr
                                     for p, ptr in leaves.items())),
        "op_bytes": float(sum(sum(t.nbytes for t in op.inputs + op.outputs)
                              for op in ops if not op.is_view)),
    }


def measure(device=None) -> Dict[str, float]:
    """The budget-able numbers of the dense decode hot path."""
    s = build_audit_setup(device)
    ladder = prefill_ladder(s)
    return {**_decode_numbers(s),
            "prefill_lowerings": float(ladder["prefill_lowerings"]),
            "insert_lowerings": float(ladder["insert_lowerings"])}


def measure_paged(device=None) -> Dict[str, float]:
    """The same keys for the paged decode (page-gather decode, chunked
    prefill, page mount)."""
    s = build_paged_audit_setup(device)
    ladder = paged_ladder(s)
    return {**_decode_numbers(s),
            "prefill_lowerings": float(ladder["prefill_lowerings"]),
            "insert_lowerings": float(ladder["mount_lowerings"])}


def measure_moe(device=None) -> Dict[str, float]:
    """The same keys for the MoE decode (router, expert products, the
    physical combine and the router-load EWMA)."""
    s = build_moe_audit_setup(device)
    ladder = prefill_ladder(s)
    return {**_decode_numbers(s),
            "prefill_lowerings": float(ladder["prefill_lowerings"]),
            "insert_lowerings": float(ladder["insert_lowerings"])}


SECTIONS = (("decode_step", measure), ("paged_decode_step", measure_paged),
            ("moe_decode_step", measure_moe))


def update_baselines(path: Path = BASELINES_PATH, device=None
                     ) -> Dict[str, Dict[str, float]]:
    vals = {section: fn(device) for section, fn in SECTIONS}
    payload = {
        "_meta": {
            "model": "audit-tiny (2L, d64, 4h, B2, T64); paged: pages of "
                     "8; moe: reduced mixtral, 4 experts, float32",
            "refresh": REFRESH_CMD,
            "note": "budgets for the plain decode hot path; counts gate "
                    "exactly, dot_flops/op_bytes at TOLERANCES; op_bytes is "
                    "the unfused sum of each dispatched op's operand and "
                    "result bytes, not XLA's hbm_bytes",
        },
        **vals,
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return vals


def audit_budgets(path: Path = BASELINES_PATH, device=None
                  ) -> List[Finding]:
    """HLO004: fail-closed comparison against the committed budget."""
    if not path.exists():
        return [Finding("HLO004", str(path),
                        f"budget file missing — the gate cannot pass "
                        f"without one; run `{REFRESH_CMD}`")]
    doc = json.loads(path.read_text())
    findings: List[Finding] = []
    for section, fn in SECTIONS:
        vals = fn(device)
        base = doc.get(section, {})
        for key, tol in TOLERANCES.items():
            if key not in base:
                findings.append(Finding(
                    "HLO004", f"baselines.json/{section}/{key}",
                    f"no committed budget for `{key}` (fresh value "
                    f"{vals[key]:g}) — fail-closed; run `{REFRESH_CMD}`"))
                continue
            b, v = float(base[key]), float(vals[key])
            limit = b * (1.0 + tol) if b > 0 else b
            if v > limit:
                findings.append(Finding(
                    "HLO004", f"{section}/{key}",
                    f"{key} regressed: {v:g} > budget {b:g} (+{tol:.0%} "
                    f"headroom) — an unpriced cost crept into the decode "
                    f"hot path; fix it or refresh via `{REFRESH_CMD}`"))
    return findings


def _ladder_findings(where: str, ladder: Dict[str, int], *,
                     prefill_limit: int, insert_key: str) -> List[Finding]:
    out = []
    if ladder["prefill_lowerings"] > prefill_limit:
        out.append(Finding(
            "HLO003", f"{where}/prefill",
            f"{ladder['prefill_lowerings']} distinct prefill traces for "
            f"{prefill_limit} allowed — the buckets no longer bound the "
            f"shapes a prompt brings"))
    if ladder[insert_key] != 1:
        out.append(Finding(
            "HLO003", f"{where}/{insert_key}",
            f"{ladder[insert_key]} distinct traces for two slots — the "
            f"slot must not change any shape"))
    return out


def audit_step(device=None) -> List[Finding]:
    """Every step check on the plain hot path of the three setups: HLO001
    and HLO002 on their decode steps, the dense insert and a paged chunk
    prefill; HLO003's ladders; on the card each decode step's memory rise
    under its cache's bytes; HLO004's budgets."""
    findings: List[Finding] = []
    dense = build_audit_setup(device)
    paged = build_paged_audit_setup(device)
    moe = build_moe_audit_setup(device)
    for where, s in (("decode_step", dense), ("paged_decode_step", paged),
                     ("moe_decode_step", moe)):
        state = clone_tree(s["state"])
        found, _, _ = check_call(where, s["model"].decode_step, state,
                                 s["params"], s["params"], state,
                                 s["tokens"])
        findings += found
        if resolve_device(device).type == "cuda":
            state = clone_tree(s["state"])
            rise = memory_rise(s["model"].decode_step, s["params"], state,
                               s["tokens"])
            if rise >= cache_bytes_of(state):
                findings.append(Finding(
                    "HLO001", f"{where}/max_memory_allocated",
                    f"one step raised the allocated peak by {rise} B, at "
                    f"least the cache's {cache_bytes_of(state)} B — the "
                    f"step holds a second cache"))
    state = clone_tree(dense["state"])
    found, _, _ = check_call("insert_slot", dense["model"].insert_slot,
                             state, dense["params"], state,
                             clone_tree(dense["sub_state"]), 1)
    findings += found
    state = clone_tree(paged["state"])
    found, _, _ = check_call("prefill_paged", paged["model"].prefill_paged,
                             state, paged["params"], paged["params"], state,
                             paged["chunk_tokens"], 1, 8, 8)
    findings += found
    findings += _ladder_findings("dense", prefill_ladder(dense),
                                 prefill_limit=len(AUDIT_BUCKETS),
                                 insert_key="insert_lowerings")
    findings += _ladder_findings("paged", paged_ladder(paged),
                                 prefill_limit=1,
                                 insert_key="mount_lowerings")
    findings += _ladder_findings("moe", prefill_ladder(moe),
                                 prefill_limit=len(AUDIT_BUCKETS),
                                 insert_key="insert_lowerings")
    findings += audit_budgets(device=device)
    return findings
