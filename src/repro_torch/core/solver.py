"""Exact solvers for the small-scale evaluation (paper §V.C).

``exact_myopic``  — exhaustive search over all |V|^|B| placements at one
interval, minimizing D_T(τ) + D_mig(τ) under the memory constraint: the
optimal *myopic* decision the heuristic approximates.  Enumerable only up
to ``MAX_MYOPIC_PLACEMENTS`` (= 10^6) placements; larger instances —
which per-layer block graphs reach quickly, |B| = n_layers·(h+2) — raise
``ValueError`` instead of hanging combinatorially.

``exact_horizon`` — full-horizon DP over (interval, placement) when a priori
resource knowledge is assumed (§III.G), used only for very small instances;
the state space is |V|^|B| per stage and each stage is O(states²), so the
cap is the tighter ``MAX_HORIZON_STATES`` (= 4096 states).

``objective="bottleneck"`` is the parity hook for the bottleneck-targeted
placement search (``ResourceAwarePolicy(search="bottleneck")``): instead of
the scalar delay objective, placements are compared on the lexicographic
pair ``(min(B, D_T) + D_mig, D_T + D_mig)`` where B is the busiest
resource's per-token busy time (``delay.pipeline_bottleneck``) — minimize
the steady-state bottleneck first, break exact ties on the paper's myopic
objective.  Lexicographic pairs form a totally ordered group under
component-wise addition, so the horizon DP's Bellman recursion stays
valid.  The returned value is the primary (bottleneck) component.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.blocks import Block, CostModel
from repro_torch.core.delay import (inference_delay, memory_feasible,
                              migration_delay, pipeline_bottleneck,
                              pipelined_total_delay)
from repro_torch.core.network import DeviceNetwork

MAX_MYOPIC_PLACEMENTS = 1_000_000
MAX_HORIZON_STATES = 4096

OBJECTIVES = ("delay", "bottleneck")


def _check_enumerable(n_blocks: int, n_devices: int, limit: int, who: str):
    """Refuse instances whose |V|^|B| enumeration exceeds ``limit``."""
    if n_devices ** n_blocks > limit:
        raise ValueError(
            f"{who}: |V|^|B| = {n_devices}^{n_blocks} placements exceed the "
            f"enumerable limit of {limit}. Exact solvers only cover small "
            f"layer counts — per-layer graphs have |B| = n_layers*(h+2); "
            f"use ResourceAwareAssigner for larger instances.")


def _check_objective(objective: str, who: str):
    if objective not in OBJECTIVES:
        raise ValueError(f"{who}: objective must be one of {OBJECTIVES}, "
                         f"got {objective!r}")


def _all_placements(n_blocks: int, devices):
    """Enumerate placements over an explicit device-id list — the active
    view, so a shrunk/grown device set reuses the same enumeration.  An
    int is accepted as shorthand for ``range(devices)``."""
    if isinstance(devices, (int, np.integer)):
        devices = range(int(devices))
    for combo in itertools.product(devices, repeat=n_blocks):
        yield np.array(combo, dtype=int)


def _bottleneck_value(prev, place, blocks, cost, net, tau, *,
                      strict_eq6: bool) -> Tuple[float, float]:
    """(min(B, D_T) + D_mig, D_T + D_mig): bottleneck-first, tie-broken by
    the paper's myopic objective."""
    d_t = inference_delay(place, blocks, cost, net, tau,
                          strict_eq6=strict_eq6)
    b = min(pipeline_bottleneck(place, blocks, cost, net, tau,
                                strict_eq6=strict_eq6), d_t)
    d_mig = migration_delay(prev, place, blocks, cost, net, tau)
    return (b + d_mig, d_t + d_mig)


def exact_myopic(blocks: Sequence[Block], cost: CostModel,
                 net: DeviceNetwork, tau: int,
                 prev: Optional[np.ndarray] = None,
                 *, strict_eq6: bool = False, pipeline_k: int = 1,
                 objective: str = "delay"
                 ) -> Tuple[Optional[np.ndarray], float]:
    """``pipeline_k`` > 1 minimizes D_pipe(K) + D_mig (the steady-state
    pipelined objective); the default is the paper's D_T + D_mig.
    ``objective="bottleneck"`` minimizes the busiest resource instead
    (module docstring) and returns its busy time (+ D_mig) as the value."""
    _check_objective(objective, "exact_myopic")
    _check_enumerable(len(blocks), net.n_active, MAX_MYOPIC_PLACEMENTS,
                      "exact_myopic")
    best, best_val = None, None
    for place in _all_placements(len(blocks), list(net.active_ids)):
        if not memory_feasible(place, blocks, cost, net, tau):
            continue
        if objective == "bottleneck":
            val: tuple = _bottleneck_value(prev, place, blocks, cost, net,
                                           tau, strict_eq6=strict_eq6)
        else:
            val = (pipelined_total_delay(prev, place, blocks, cost, net, tau,
                                         k=pipeline_k,
                                         strict_eq6=strict_eq6),)
        if best_val is None or val < best_val:
            best, best_val = place.copy(), val
    if best is None:
        return None, np.inf
    return best, float(best_val[0])


def exact_horizon(blocks: Sequence[Block], cost: CostModel,
                  nets: List[DeviceNetwork], *, strict_eq6: bool = False,
                  pipeline_k: int = 1, objective: str = "delay"
                  ) -> Tuple[List[np.ndarray], float]:
    """DP over intervals 1..T given per-interval resource snapshots.
    ``pipeline_k`` > 1 prices each stage at D_pipe(K) + D_mig;
    ``objective="bottleneck"`` prices it at the lexicographic bottleneck
    pair instead (sums of pairs compare lexicographically, so the Bellman
    recursion is unchanged)."""
    _check_objective(objective, "exact_horizon")
    _check_enumerable(len(blocks), nets[0].n_active, MAX_HORIZON_STATES,
                      "exact_horizon")

    def stage_val(prev, place, net, tau) -> tuple:
        if objective == "bottleneck":
            return _bottleneck_value(prev, place, blocks, cost, net, tau,
                                     strict_eq6=strict_eq6)
        return (pipelined_total_delay(prev, place, blocks, cost, net, tau,
                                      k=pipeline_k, strict_eq6=strict_eq6),)

    def add(a: tuple, b: tuple) -> tuple:
        return tuple(x + y for x, y in zip(a, b))

    states = [p for p in _all_placements(len(blocks),
                                         list(nets[0].active_ids))]
    n = len(states)
    # stage 1: no migration cost
    val: List[Optional[tuple]] = [None] * n
    parent = np.full((len(nets), n), -1, dtype=int)
    for s, p in enumerate(states):
        if memory_feasible(p, blocks, cost, nets[0], 1):
            val[s] = stage_val(None, p, nets[0], 1)
    for t in range(1, len(nets)):
        tau = t + 1
        new_val: List[Optional[tuple]] = [None] * n
        for s, p in enumerate(states):
            if not memory_feasible(p, blocks, cost, nets[t], tau):
                continue
            for s0, p0 in enumerate(states):
                if val[s0] is None:
                    continue
                v = add(val[s0], stage_val(p0, p, nets[t], tau))
                if new_val[s] is None or v < new_val[s]:
                    new_val[s] = v
                    parent[t, s] = s0
        val = new_val
    reachable = [s for s in range(n) if val[s] is not None]
    if not reachable:
        # no memory-feasible placement at the final stage: the horizon is
        # infeasible — report it as such instead of a garbage path
        return [], float("inf")
    s = min(reachable, key=lambda s: val[s])
    best_total = float(val[s][0])
    path = [states[s]]
    for t in range(len(nets) - 1, 0, -1):
        s = int(parent[t, s])
        path.append(states[s])
    path.reverse()
    return path, best_total
