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
from repro_torch.core.placement_bridge import (apply_head_perm,
                                               apply_layer_head_perms,
                                               migration_pairs_layers,
                                               placement_to_expert_perms,
                                               placement_to_perms,
                                               relative_perms)


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
        self.history: List[dict] = []

    def _make_policy(self) -> ResourceAwarePolicy:
        return ResourceAwarePolicy(
            self.blocks, self.cost,
            deadline=self.cfg.deadline * self.cfg.lam,
            pipeline_k=self.cfg.pipeline_k, search="bottleneck",
            amortize=self.cfg.amortize, min_gain=self.cfg.min_gain)

    @property
    def perm(self) -> Optional[np.ndarray]:
        """Layer-0 permutation (single-layer callers)."""
        return None if self.perms is None else self.perms[0]

    def head_counts(self, place: Optional[np.ndarray] = None) -> np.ndarray:
        """Heads per device in ``place`` (default: the current placement),
        summed over layers."""
        place = self.place if place is None else place
        heads = [b.index for b in self.blocks if b.kind == "head"]
        return np.bincount(np.asarray(place)[heads],
                           minlength=self.net.n_devices)

    # ------------------------------------------------------------ observe
    def observe(self, compute_avail: Optional[np.ndarray] = None,
                mem_avail: Optional[np.ndarray] = None):
        """Feed observed instantaneous availability.  ``mem_avail`` lands
        in the network's availability field; the hardware ``mem_capacity``
        is never overwritten by an observation."""
        if compute_avail is not None:
            obs = np.asarray(compute_avail, float)
            # an inactive device has zero availability whatever the
            # (possibly stale) telemetry claims
            self.net.compute_avail = np.where(self.net.active, obs, 0.0)
        if mem_avail is not None:
            self.net.mem_avail = np.asarray(mem_avail, float)

    def observe_monitor(self, monitor, peak_flops=None):
        """Per-slot step-time EWMAs from a ``HeartbeatMonitor`` become the
        C_j(τ) estimates Algorithm 1 reads (slot j is device j; dead slots
        estimate to zero).  ``peak_flops`` defaults to the network's
        ``compute_max``."""
        peak = self.net.compute_max if peak_flops is None else peak_flops
        self.observe(compute_avail=monitor.availability(peak))

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
                "perm": new_perms[0],
                "prev_perm": None if self.perms is None else self.perms[0],
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
        self.history.append({"tau": self.tau, "n_migrations": len(pairs),
                             "n_expert_migrations": len(epairs),
                             "d_mig_est": d_mig,
                             "arrival_rate": arrival_rate,
                             "queue_depth": queue_depth,
                             "infeasible": stats.infeasible})
        return plan

    # ------------------------------------------------------------- churn
    def handle_failure(self, device: int,
                       tau: Optional[int] = None) -> dict:
        """Death event -> evacuation plan: mark ``device`` failed and
        re-place at once.  The assigner cannot place on an inactive device
        and the payback filter never reverts a block onto one, so the
        evacuation is mandatory, not priced; surviving blocks keep their
        stickiness.  Raises when the plan still places a block on the dead
        device (the survivors cannot hold the model)."""
        self.net.fail(device)
        plan = self.step_interval(tau=tau)
        if np.any(np.asarray(plan["place"]) == device):
            raise RuntimeError(
                f"evacuation infeasible: surviving devices cannot hold "
                f"device {device}'s blocks (n_active={self.net.n_active})")
        plan["evacuation"] = True
        plan["failed_device"] = int(device)
        self.history[-1]["evacuation"] = True
        self.history[-1]["failed_device"] = int(device)
        return plan

    def handle_rejoin(self, device: int,
                      tau: Optional[int] = None) -> dict:
        """A failed device comes back (fresh, no resident state) ->
        expansion plan.  Expansion is optional: blocks move onto the
        rejoined device only where the move pays under the usual filter."""
        self.net.rejoin(device)
        plan = self.step_interval(tau=tau)
        plan["expansion"] = True
        plan["rejoined_device"] = int(device)
        self.history[-1]["expansion"] = True
        self.history[-1]["rejoined_device"] = int(device)
        return plan

    # ---------------------------------------------------------------- act
    def apply_to_cache(self, cache_k, cache_v, plan, head_axis: int = 3,
                       layer_axis: int = 0):
        """Execute ``plan`` on a layer-stacked head-expanded KV cache
        (torch tensors): per-layer gathers by the relative permutations
        (the new layout in terms of current positions).  The cache's
        ``layer_axis`` must cover the controller's ``n_layers`` (a
        single-layer plan applies to every layer).  Returns new tensors."""
        prev_perms = plan.get("prev_perms")
        if prev_perms is None or not plan["migrations"]:
            return cache_k, cache_v
        rel = relative_perms(prev_perms, plan["perms"])
        gs = self.cfg.group_size
        if rel.shape[0] == 1:
            return apply_head_perm(cache_k, cache_v, rel[0], head_axis,
                                   group_size=gs)
        # the port's per-layer gather takes the layers on the leading axis
        nd = cache_k.ndim
        la, ha = layer_axis % nd, head_axis % nd
        if la == ha:
            raise ValueError("layer_axis and head_axis name the same axis")
        moved = [la] + [a for a in range(nd) if a != la]
        k, v = apply_layer_head_perms(
            cache_k.permute(moved), cache_v.permute(moved), rel,
            head_axis=moved.index(ha), group_size=gs)
        back = [moved.index(a) for a in range(nd)]
        return k.permute(back), v.permute(back)
