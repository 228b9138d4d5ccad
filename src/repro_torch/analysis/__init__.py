"""Hot-path auditor of the port — counterpart of the JAX package's
``analysis/`` package.

The paper serves under tight edge memory and latency budgets, so this
package makes the cost of the port's serving hot path a checked artifact,
as the reference does for its compiled path:

``lints``
    AST lints (RPR0xx codes, stdlib only, no torch import): per-step
    ``manual_seed`` and counter seeds, swallowed broad ``except``
    handlers, and host round trips (``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``np.asarray``, ``float()``/``int()`` of a computed
    value) inside the stepping loop of a function that drives the hot
    path.  Waive a true-but-intended hit inline with
    ``# rpr: ignore[CODE] -- reason``.

``trace_audit``
    The counterpart of ``jaxpr_audit``: eager PyTorch has no jaxpr, so a
    ``TorchDispatchMode`` records every aten op one call of a hot function
    dispatches (``decode_step``, ``prefill_bucketed``, ``insert_slot``, the
    resident decode kernel's wrapper) and the audit reads them for
    widening casts of cache-sized tensors (JXP001) and host syncs
    (JXP002).

``step_audit``
    The counterpart of ``hlo_audit``: on the engine's own decode, prefill
    and insert calls it checks that every cache leaf is updated in place
    (HLO001), that no op copies a cache or a parameter (HLO002), that the
    prefill shapes stay bounded by the buckets (HLO003), and holds the
    step's matmul FLOPs, op bytes and counts to the committed
    ``baselines.json`` (HLO004).

CLI: ``python -m repro_torch.analysis [lint|trace|step ...]`` exits
non-zero on any unwaived finding.  The finding codes are the reference's,
so a finding maps to its counterpart.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One auditor hit.  ``code`` families: RPR0xx (AST lints), JXP0xx
    (the dispatch-trace audit), HLO0xx (the step audit)."""
    code: str
    where: str            # "path:line" or "function/op" locator
    message: str

    def __str__(self) -> str:
        return f"{self.code} {self.where}: {self.message}"


__all__ = ["Finding"]
