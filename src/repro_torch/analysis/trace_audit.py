"""Dispatch-trace audit of the port's serving hot path (JXP0xx findings)
— counterpart of the JAX package's ``analysis/jaxpr_audit.py``.

Eager PyTorch has no jaxpr to walk, so the audit watches what one call of
a hot function dispatches: ``OpRecorder``, a ``TorchDispatchMode``,
records every aten op with its input and output tensors (shape, dtype,
bytes, storage), and ``audit_ops`` reads the record:

JXP001  A widening cast of a cache-sized tensor: an op (``_to_copy``, a
        ``copy_`` into a wider buffer, type-promoting arithmetic) whose
        floating or int8 input of at least ``big_elems`` elements comes out
        as a floating tensor of a wider type and at least as many
        elements.  A widened K/V cache is the memory Algorithm 1 budgets:
        a float32 copy of a bf16 (int8) cache doubles (quadruples) a
        layer's resident bytes.
JXP002  A host sync inside the function: ``aten._local_scalar_dense`` (the
        op behind ``.item()``, ``int()``, ``float()`` and ``bool()`` of a
        tensor), ``equal``/``is_nonzero``, a copy between host and device
        memory (assigning a Python number to an item of a CUDA tensor is
        one), or an op whose output shape depends on the data (``nonzero``,
        ``masked_select``, ``unique``, indexing with a boolean mask) — each
        waits for the device once per decode step.
JXP003  (a closure-captured constant baked into a jaxpr) has no eager
        counterpart: an eager call reads its tensors where they live, so
        nothing is baked into a trace.  The audit emits no JXP003.

The dispatch mode sees ATen ops only.  A kernel launched through ctypes
(``kernels/decode_attention.py``'s ``_launch``) is invisible to it: on the
card the mode sees the ops around the launch (the output's and the
partials' allocations, the int32 casts of lengths and rows), and a sync
inside the wrapper shows only as a failed CUDA-graph capture or under
``torch.cuda.set_sync_debug_mode("error")`` (``chip_smoke.phase_audit``).

``audit_hot_functions(device=)`` builds the shared audit setup
(``step_audit.build_audit_setup``) and traces ``decode_step``,
``prefill_bucketed``, ``insert_slot`` and the resident decode kernel's
dispatch ``kernels.ops.decode_attention_resident_bshd`` over the identity
rows — on the CPU its plain version, on the card the CUDA wrapper.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import Finding
from repro_torch.tree import map_with_path

# ops whose output shape depends on the data: the host waits for the count
DATA_DEPENDENT_OPS = {"nonzero", "nonzero_static", "masked_select",
                      "unique", "_unique", "_unique2", "unique_dim",
                      "unique_consecutive", "argwhere"}
# ops that return a host value read from the device
HOST_VALUE_OPS = {"_local_scalar_dense", "equal", "is_nonzero"}
INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}
# ops that copy between host and device memory
TRANSFER_OPS = {"_to_copy", "copy_", "_copy_from", "_copy_from_and_resize"}
WIDENABLE = {torch.float16, torch.bfloat16, torch.float32, torch.int8,
             torch.uint8}
DEFAULT_BIG_ELEMS = 8192


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: str
    nbytes: int
    storage: int              # the storage's data pointer (0: none)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class OpRecord:
    name: str                  # the overload packet's name, e.g. "_to_copy"
    func: str                  # the full overload, e.g. "aten._to_copy.default"
    namespace: str             # "aten", "c10d", ...
    is_view: bool              # the output aliases an input, nothing moves
    inputs: Tuple[TensorInfo, ...]
    outputs: Tuple[TensorInfo, ...]
    bool_index: bool           # an index op given a boolean mask


def _info(t: torch.Tensor) -> TensorInfo:
    try:
        storage = t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        storage = 0            # a tensor without storage (meta, sparse)
    return TensorInfo(tuple(t.shape), t.dtype, t.device.type,
                      t.numel() * t.element_size(), storage)


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched while it is active (``ops``).
    Nothing is changed: each op runs as it would without the mode."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        bool_index = False
        if name in INDEX_OPS and len(args) > 1:
            bool_index = any(t.dtype == torch.bool
                             for t in _tensors(args[1]))
        self.ops.append(OpRecord(
            name, str(func), func.namespace, func.is_view,
            tuple(_info(t) for t in _tensors((args, kwargs))),
            tuple(_info(t) for t in _tensors(out)), bool_index))
        return out


def record(fn: Callable, *args, **kwargs) -> Tuple[Any, List[OpRecord]]:
    """Run ``fn(*args, **kwargs)`` once under an ``OpRecorder``; returns
    (its result, the ops it dispatched)."""
    with OpRecorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.ops


def _widens(op: OpRecord, big_elems: int) -> Optional[Tuple[TensorInfo,
                                                             TensorInfo]]:
    """(input, output) of a widening of a cache-sized input, else None."""
    for i in op.inputs:
        if i.dtype not in WIDENABLE or i.numel < big_elems:
            continue
        for o in op.outputs:
            if o.dtype.is_floating_point and o.numel >= i.numel \
                    and o.dtype.itemsize > i.dtype.itemsize:
                return i, o
    return None


def audit_ops(ops: Sequence[OpRecord], name: str, *,
              big_elems: int = DEFAULT_BIG_ELEMS) -> List[Finding]:
    """JXP001 and JXP002 over one call's dispatched ops."""
    findings: List[Finding] = []
    for op in ops:
        widened = _widens(op, big_elems)
        if widened is not None:
            i, o = widened
            findings.append(Finding(
                "JXP001", f"{name}/{op.func}",
                f"widening {i.dtype}{list(i.shape)} -> {o.dtype} on a "
                f"cache-sized tensor ({i.numel} elems): a widened resident "
                f"buffer is exactly the memory the placement algorithm "
                f"budgets — keep the cache in its own type"))
        sync = None
        if op.name in HOST_VALUE_OPS:
            sync = f"`{op.func}` reads a value to the host"
        elif op.name in DATA_DEPENDENT_OPS:
            sync = f"`{op.func}`'s output shape depends on the data"
        elif op.bool_index:
            sync = f"`{op.func}` with a boolean mask sizes its output " \
                   f"from the data"
        elif op.name in TRANSFER_OPS and op.outputs:
            src = {i.device for i in op.inputs}
            dst = op.outputs[0].device
            if dst == "cpu" and src - {"cpu"}:
                sync = f"`{op.func}` copies device memory to the host"
            elif dst != "cpu" and "cpu" in src:
                sync = f"`{op.func}` copies host memory to the device " \
                       f"(a pageable copy waits for the host)"
        if sync:
            findings.append(Finding(
                "JXP002", f"{name}/{op.func}",
                f"host sync inside the hot function: {sync} — a host round "
                f"trip per decode step that no bench row attributes; keep "
                f"it on the device or move it out of the step"))
    return findings


def audit_call(fn: Callable, name: str, *args, big_elems: int =
               DEFAULT_BIG_ELEMS, **kwargs) -> List[Finding]:
    """Trace one call of ``fn`` and audit what it dispatched."""
    _, ops = record(fn, *args, **kwargs)
    return audit_ops(ops, name, big_elems=big_elems)


def big_elems_of(cache_k: torch.Tensor) -> int:
    """The reference's "cache-sized" for a model: half of one layer's K
    rows, at least 1024 elements."""
    n = 1
    for s in cache_k.shape[1:]:
        n *= s
    return max(n // 2, 1024)


def clone_tree(tree):
    """A copy of a state tree, its tensors cloned: an audited call writes
    its state in place, and the shared setup must stay as it was built."""
    return map_with_path(
        lambda _, t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def hot_calls(setup: dict) -> Iterable[Tuple[str, Callable, tuple]]:
    """(name, function, arguments) of the four hot functions on an audit
    setup, each over its own copy of the state."""
    from repro_torch.kernels import ops
    m, params = setup["model"], setup["params"]
    state = clone_tree(setup["state"])
    yield "decode_step", m.decode_step, (params, state, setup["tokens"])
    yield "prefill_bucketed", m.prefill_bucketed, (
        params, clone_tree(setup["bucket_state"]), setup["bucket_tokens"],
        setup["bucket_lengths"])
    yield "insert_slot", m.insert_slot, (
        clone_tree(setup["state"]), clone_tree(setup["sub_state"]), 0)
    k = setup["state"]["cache"]["k"]
    B, T, KvE, dh = k.shape[1:]
    H = setup["cfg"].n_heads
    gen = torch.Generator(device=k.device).manual_seed(0)
    q = torch.randn((B, 1, H, dh), generator=gen, device=k.device
                    ).to(k.dtype)
    kv = torch.randn((2, B, T, KvE, dh), generator=gen, device=k.device
                     ).to(k.dtype)
    lengths = torch.full((B,), T, dtype=torch.int32, device=k.device)
    rows = torch.arange(H, dtype=torch.int32, device=k.device)
    yield "decode_attention_resident", ops.decode_attention_resident_bshd, (
        q, kv[0], kv[1], lengths, rows)


def audit_hot_functions(*, device=None, big_elems: Optional[int] = None
                        ) -> List[Finding]:
    """Trace the four serving hot functions on the shared audit setup,
    built on ``device`` (None: the card)."""
    from repro_torch.analysis.step_audit import build_audit_setup
    setup = build_audit_setup(device=device)
    big = big_elems or big_elems_of(setup["state"]["cache"]["k"])
    findings: List[Finding] = []
    for name, fn, args in hot_calls(setup):
        findings += audit_call(fn, name, *args, big_elems=big)
    return findings
