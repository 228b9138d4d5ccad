"""Discrete-event simulator for token-by-token distributed inference
(paper §V.B): a controller gathers device/link state each interval τ, runs a
placement policy, applies migrations, and advances one generated token
(λ = 1 — the paper's worst-case migration stress).

Memory-overload semantics: a placement that over-runs M_j(τ) (static
policies under K/V growth) does not crash — the device *thrashes*: overflow
bytes are swapped at ``swap_bw`` (default 1 GB/s) once per interval, added
to that device's completion time.  This is the physical mechanism behind
EdgeShard/Galaxy's blow-up in the paper's Fig. 3/4.

Metrics per step: inference delay, migration delay, overload stall,
cumulative latency, per-device & total memory, #migrations — exactly the
quantities in Fig. 3 (latency vs n) and Fig. 4 (memory vs n).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.baselines import Policy
from repro_torch.core.blocks import Block, CostModel
from repro_torch.core.delay import (inference_delay, memory_usage,
                              migration_delay, pipeline_bottleneck,
                              pipelined_inference_delay)
from repro_torch.core.network import DeviceNetwork


@dataclasses.dataclass
class StepRecord:
    tau: int
    d_inf: float
    d_mig: float
    d_overload: float
    cumulative: float
    mem_total: float
    mem_max_device: float
    n_migrations: int
    infeasible: bool
    # busiest-resource busy time (pipelined runs only, else 0): the
    # steady-state interval the bottleneck-targeted search minimizes —
    # lets benchmarks attribute a policy's throughput to B vs D_T.
    d_bneck: float = 0.0


@dataclasses.dataclass
class SimResult:
    policy: str
    steps: List[StepRecord]

    @property
    def total_latency(self) -> float:
        return self.steps[-1].cumulative if self.steps else np.inf

    @property
    def per_step_latency(self) -> np.ndarray:
        return np.array([s.d_inf + s.d_mig + s.d_overload for s in self.steps])

    @property
    def mem_total_series(self) -> np.ndarray:
        return np.array([s.mem_total for s in self.steps])

    @property
    def mem_max_series(self) -> np.ndarray:
        return np.array([s.mem_max_device for s in self.steps])

    @property
    def migrations(self) -> int:
        return sum(s.n_migrations for s in self.steps)

    @property
    def bottleneck_series(self) -> np.ndarray:
        """Per-step busiest-resource busy time (pipelined runs)."""
        return np.array([s.d_bneck for s in self.steps])


def overload_stall(place: np.ndarray, blocks: Sequence[Block],
                   cost: CostModel, net: DeviceNetwork, tau: int,
                   swap_bw: float = 1e9) -> float:
    use = memory_usage(place, blocks, cost, net, tau)
    overflow = np.maximum(use - net.mem_usable(), 0.0)
    return float(overflow.max() / swap_bw) if overflow.size else 0.0


def simulate(policy: Policy, blocks: Sequence[Block], cost: CostModel,
             net: DeviceNetwork, n_tokens: int, *,
             fluctuate: bool = True, swap_bw: float = 1e9,
             strict_eq6: bool = False, seed: Optional[int] = None,
             pipeline_k: int = 1,
             events: Optional[Sequence] = None) -> SimResult:
    """``pipeline_k`` > 1 prices each step at the amortized per-token
    pipelined delay D_pipe(K) — K tokens of different requests in flight
    over layer-disjoint stages — instead of the sequential D_T.
    ``pipeline_k=1`` is unchanged bit-for-bit.

    ``events`` injects device churn mid-run: an iterable of ``(tau, fn)``
    pairs; each ``fn(net)`` runs before the policy places at that
    interval (e.g. ``lambda net: net.fail(3)``)."""
    net = net.copy()
    if seed is not None:
        net.rng = np.random.default_rng(seed)
    by_tau: Dict[int, list] = {}
    for ev_tau, fn in (events or ()):
        by_tau.setdefault(int(ev_tau), []).append(fn)
    prev: Optional[np.ndarray] = None
    cumulative = 0.0
    records: List[StepRecord] = []
    for tau in range(1, n_tokens + 1):
        if fluctuate and tau > 1:
            net.step_background_load()
        for fn in by_tau.get(tau, ()):
            fn(net)
        place = policy.place(net, tau, prev)
        infeasible = place is None
        d_bneck = 0.0
        if infeasible:
            place = prev if prev is not None else \
                np.zeros(len(blocks), dtype=int)
        if hasattr(policy, "step_delay") and \
                getattr(policy, "aggregate_semantics", True):
            # aggregate pipeline baselines (EdgeShard/Galaxy on the
            # single-layer column model) carry their own delay and memory
            # semantics (baselines._PipelinePolicy); on a per-layer block
            # graph they emit real placements and fall through to the
            # unified per-layer delay model below
            d_mig = 0.0
            d_inf = policy.step_delay(net, tau)
            use = policy.device_memory(net, tau)
            overflow = np.maximum(use - net.mem_usable(), 0.0)
            d_ovl = float(overflow.max() / swap_bw)
            n_mig = 0
        else:
            d_mig = migration_delay(prev, place, blocks, cost, net, tau)
            if pipeline_k > 1:
                d_inf = pipelined_inference_delay(place, blocks, cost, net,
                                                  tau, k=pipeline_k,
                                                  strict_eq6=strict_eq6)
                d_bneck = pipeline_bottleneck(place, blocks, cost, net, tau,
                                              strict_eq6=strict_eq6)
            else:
                d_inf = inference_delay(place, blocks, cost, net, tau,
                                        strict_eq6=strict_eq6)
            d_ovl = overload_stall(place, blocks, cost, net, tau, swap_bw)
            n_mig = 0 if prev is None else int((prev != place).sum())
            use = memory_usage(place, blocks, cost, net, tau)
        cumulative += d_inf + d_mig + d_ovl
        records.append(StepRecord(
            tau=tau, d_inf=d_inf, d_mig=d_mig, d_overload=d_ovl,
            cumulative=cumulative, mem_total=float(use.sum()),
            mem_max_device=float(use.max()), n_migrations=n_mig,
            infeasible=infeasible, d_bneck=d_bneck))
        prev = place
    return SimResult(policy=policy.name, steps=records)


def compare_policies(policies: Dict[str, Policy], blocks, cost, net,
                     n_tokens: int, **kw) -> Dict[str, SimResult]:
    return {name: simulate(pol, blocks, cost, net, n_tokens, **kw)
            for name, pol in policies.items()}
