"""Interval controller — the paper's §III.G loop, host-side.

Step-time telemetry (``runtime.fault_tolerance``) estimates C_j(τ),
KV-cache growth gives m_i(τ), and the network model gives R_{j,k};
Algorithm 1's placement becomes one head permutation per layer
(``placement_bridge``), which the serving engine applies to the cache and
the weights between decode steps — in the λ-interval slack, exactly where
the paper schedules migrations.

With MoE archs whose experts tile the devices the block graph carries one
block per (layer, expert), priced by the observed router loads; each plan
then also holds one expert-row permutation per layer, which the engine
applies to the stacked expert weights.

Copy of the JAX package's ``core/controller.py``: the ``"rescoring"``
search (Algorithm 1, refine, payback filter) and, with ``pipeline_k > 1``,
the ``"bottleneck"`` search of ``baselines.ResourceAwarePolicy``.  Plans
are identical to the reference controller's on the same network and cost
model.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.algorithm import ResourceAwareAssigner
from repro_torch.core.baselines import ResourceAwarePolicy
from repro_torch.core.blocks import Block, CostModel, make_blocks
from repro_torch.core.delay import (migration_delay, pipelined_inference_delay,
                                    revert_unpaying_migrations)
from repro_torch.core.network import DeviceNetwork
from repro_torch.core.placement_bridge import (migration_pairs_layers,
                                               placement_to_expert_perms,
                                               placement_to_perms)


@dataclasses.dataclass
class ControllerConfig:
    lam: int = 32                 # tokens per interval (λ)
    deadline: float = 0.2         # per-token latency budget (scoring)
    min_gain: float = 0.0         # extra migration-filter margin
    heads_per_slot: int = 2
    # KV-group size (GQA: Hp // KvE query heads per KV head).  > 1 makes
    # every emitted permutation group-consistent, so grouped caches/weights
    # can physically migrate (placement_bridge.kv_group_perms).
    group_size: int = 1
    # decode tokens in flight across layer-disjoint stages; > 1 switches
    # the migration-filter objective to D_pipe(K) + D_mig and the engine
    # scales its interval cadence by K (λ stays token-denominated while a
    # scheduler step advances only 1/K of the slots).
    pipeline_k: int = 1
    # placement search mode: "rescoring" is Algorithm 1, refine, filter;
    # "bottleneck" (with pipeline_k > 1) adds the bottleneck-targeted
    # search — stage-balanced chain seed + layer-chain moves aimed at the
    # argmax resource, migrations amortized over ``amortize`` intervals
    # (baselines.ResourceAwarePolicy docstring).
    search: str = "rescoring"
    amortize: int = 16
    # physical expert rows per mesh slot (MoE archs).  0 = derive from the
    # cost model: expert_slots // n_devices (expert rows, like heads, tile
    # the mesh).  Only consulted when the cost model carries experts.
    experts_per_slot: int = 0


class IntervalController:
    """Runs Algorithm 1 every λ generated tokens and emits migration plans."""

    def __init__(self, n_heads: int, cost: CostModel, net: DeviceNetwork,
                 cfg: ControllerConfig = ControllerConfig()):
        # unknown modes fail here, at construction: a typo must not
        # silently serve the rescoring planner the caller opted out of
        if cfg.search not in ResourceAwarePolicy.SEARCH_MODES:
            raise ValueError(
                f"ControllerConfig.search must be one of "
                f"{ResourceAwarePolicy.SEARCH_MODES}, got {cfg.search!r}")
        self.n_layers = cost.n_layers if cost.layer_mode == "graph" else 1
        self.blocks: List[Block] = make_blocks(n_heads, self.n_layers,
                                               cost.n_experts,
                                               cost.expert_replicas)
        self.cost = cost
        self.net = net
        self.cfg = cfg
        self.has_experts = cost.n_experts >= 2
        self.experts_per_slot = cfg.experts_per_slot
        if self.has_experts and not self.experts_per_slot:
            self.experts_per_slot = max(1, cost.expert_slots // net.n_devices)
        # the feasibility budget is the WHOLE interval: λ tokens at the
        # per-token deadline
        self.assigner = ResourceAwareAssigner(self.blocks, cost,
                                              deadline=cfg.deadline * cfg.lam)
        # bottleneck mode: plans come from the full policy (assign →
        # refine → filter → bottleneck search); "rescoring", and
        # "bottleneck" at pipeline_k=1, stay the assigner path below
        self._policy = None
        if cfg.search == "bottleneck" and cfg.pipeline_k > 1:
            self._policy = self._make_policy()
        self.place: Optional[np.ndarray] = None
        self.perms: Optional[np.ndarray] = None   # (n_layers, slots·hps)
        # (n_layers, slots·eps) physical expert-row layout (MoE archs)
        self.expert_perms: Optional[np.ndarray] = None
        self.tau = 0

    def _make_policy(self) -> ResourceAwarePolicy:
        return ResourceAwarePolicy(
            self.blocks, self.cost,
            deadline=self.cfg.deadline * self.cfg.lam,
            pipeline_k=self.cfg.pipeline_k, search="bottleneck",
            amortize=self.cfg.amortize, min_gain=self.cfg.min_gain)

    def head_counts(self) -> np.ndarray:
        """Heads per device in the current placement, summed over
        layers."""
        heads = [b.index for b in self.blocks if b.kind == "head"]
        return np.bincount(np.asarray(self.place)[heads],
                           minlength=self.net.n_devices)

    # ------------------------------------------------------------ observe
    def observe_monitor(self, monitor, peak_flops):
        """Per-slot step-time EWMAs from a ``HeartbeatMonitor`` become the
        C_j(τ) estimates Algorithm 1 reads (slot j is device j); an
        inactive device observes zero whatever its telemetry says."""
        obs = np.asarray(monitor.availability(peak_flops), float)
        self.net.compute_avail = np.where(self.net.active, obs, 0.0)

    def update_expert_loads(self, loads):
        """Feed observed router loads (rows: per layer, one entry per
        physical expert slot, each row summing to ~1) into the expert cost
        model; the assigner (and the bottleneck policy) are rebuilt around
        the new ``CostModel`` so the next ``step_interval`` prices expert
        compute by the live gate frequencies."""
        if not self.has_experts:
            return
        self.cost = self.cost.with_expert_loads(loads)
        self.assigner = ResourceAwareAssigner(
            self.blocks, self.cost,
            deadline=self.cfg.deadline * self.cfg.lam)
        if self._policy is not None:
            self._policy = self._make_policy()

    # ------------------------------------------------------------- decide
    def step_interval(self, tau: Optional[int] = None,
                      arrival_rate: Optional[float] = None,
                      queue_depth: Optional[int] = None) -> dict:
        """One controller interval: assign, diff, plan migrations.

        ``tau`` anchors the cost model to the actual decode stream (the
        engine passes the mean slot occupancy); ``arrival_rate`` and
        ``queue_depth`` are the engine's observed load, recorded into the
        plan."""
        self.tau = max(1, int(tau)) if tau is not None else self.tau + 1
        prev = self.place
        k = self.cfg.pipeline_k
        if self._policy is not None:
            # the policy already refines, filters (with min_gain) and runs
            # the bottleneck-targeted search
            place = self._policy.place(self.net, self.tau, prev)
            stats = self._policy.last_stats
            if place is None:
                place = prev if prev is not None else \
                    np.zeros(len(self.blocks), dtype=int)
        else:
            place, stats = self.assigner.assign(self.net, self.tau, prev)
            if place is None:
                place = prev if prev is not None else \
                    np.zeros(len(self.blocks), dtype=int)
            # objective filter: keep migrations only if they pay (§III.G)
            place = revert_unpaying_migrations(prev, place, self.blocks,
                                               self.cost, self.net, self.tau,
                                               k=k,
                                               min_gain=self.cfg.min_gain)
        n_slots = self.net.n_devices
        new_perms = placement_to_perms(place, self.blocks, n_slots,
                                       self.cfg.heads_per_slot,
                                       self.cfg.group_size)
        pairs = [] if self.perms is None else \
            migration_pairs_layers(self.perms, new_perms,
                                   self.cfg.heads_per_slot)
        new_eperms = None
        epairs: List[tuple] = []
        if self.has_experts:
            new_eperms = placement_to_expert_perms(
                place, self.blocks, n_slots, self.experts_per_slot,
                self.cost.expert_replicas)
            if self.expert_perms is not None:
                epairs = migration_pairs_layers(self.expert_perms, new_eperms,
                                                self.experts_per_slot)
        d_mig = migration_delay(prev, place, self.blocks, self.cost,
                                self.net, self.tau)
        plan = {"tau": self.tau, "place": place,
                "perms": new_perms, "prev_perms": self.perms,
                "migrations": pairs,
                "expert_perms": new_eperms,
                "prev_expert_perms": self.expert_perms,
                "expert_migrations": epairs,
                "d_mig_est": d_mig,
                "d_pipe_est": pipelined_inference_delay(
                    place, self.blocks, self.cost, self.net, self.tau, k=k),
                "arrival_rate": arrival_rate,
                "queue_depth": queue_depth,
                "infeasible": stats.infeasible}
        self.place, self.perms = place, new_perms
        if new_eperms is not None:
            self.expert_perms = new_eperms
        return plan
