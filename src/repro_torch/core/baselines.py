"""Baseline partitioning policies (paper §V.A).

Greedy / Round-Robin / Static / Dynamic are the paper's simple baselines;
EdgeShard [1] and Galaxy [3] are the state-of-the-art comparisons. All share
the ``Policy`` interface: ``place(net, tau, prev) -> placement | None``.

EdgeShard  — layer-wise static sharding: each decoder *layer* is one block.
  With the paper's single-layer model the whole layer (all heads + proj +
  ffn) lands on one device, chosen once for the full horizon by maximizing
  (memory headroom x compute): no adaptation, no K/V-growth handling.

Galaxy     — static hybrid tensor+sequence parallelism: heads and ffn are
  split evenly over all devices once (round-robin over the sorted-by-compute
  device list); proj is co-located with the fastest device. Models Galaxy's
  tensor-parallel sharding of each shard's matmuls; static during decoding.

On a **per-layer block graph** (``layer_mode="graph"`` / multi-layer
``make_blocks``) the layer-range baselines place *actual* per-layer blocks
instead of aggregate math: EdgeShard maps its contiguous layer shards to
real placements (every block of a stage's layers on the stage device);
Galaxy spreads each stage's heads over its TP island.  Both are then
priced by the unified per-layer Eq.-6 delay model — the comparison
isolates the placement policy, exactly like the paper's simulator.
``ColumnCoPartitionPolicy`` exposes the old column lift as a policy on the
same graph, so per-layer head placement can be compared against column
co-partitioning under identical delay semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.algorithm import ResourceAwareAssigner
from repro_torch.core.blocks import (Block, CostModel, graph_of,
                               make_blocks, replicate_placement)
from repro_torch.core.network import DeviceNetwork


class Policy:
    name = "base"

    def __init__(self, blocks: Sequence[Block], cost: CostModel, **kw):
        self.blocks = list(blocks)
        self.cost = cost

    def place(self, net: DeviceNetwork, tau: int,
              prev: Optional[np.ndarray]) -> Optional[np.ndarray]:
        raise NotImplementedError


class ResourceAwarePolicy(Policy):
    """Algorithm 1 + the objective refinement the paper's controller step
    requires (§III.G: "minimizes D_T(τ) + D_mig(τ)"): each proposed block
    migration is kept only if it lowers the myopic objective — migrations
    whose delay exceeds their latency gain are reverted. Disable with
    ``migration_filter=False`` for the ablation.

    On per-layer block graphs a bounded best-improvement pass over the same
    objective follows (``refine_passes``, default 1 when the block list is
    multi-layer): Algorithm 1's load-aware score spreads same-kind blocks
    to balance *utilization*, but the layer-composed critical path is a
    *sum* of per-layer terms, so e.g. every layer's ffn belongs on the
    fastest feasible device — a move the score never proposes and the
    refinement finds.  Each refinement move must already pay for its own
    migration delay (it minimizes D_T + D_mig), the inherent anti-thrash
    term.

    ``pipeline_k`` > 1 switches the refinement/filter objective to
    D_pipe(K) + D_mig (delay.py's pipelined model): the policy then
    optimizes steady-state pipelined throughput — spreading layers over
    disjoint device sets to shrink the bottleneck resource — instead of
    the single-token critical path.  ``pipeline_k=1`` is the paper
    objective bit-for-bit.

    ``search="bottleneck"`` (with ``pipeline_k`` > 1) adds the
    bottleneck-targeted placement search on top: the Algorithm-1 + refine
    + filter result is further improved by ``algorithm.refine_bottleneck``
    (layer-chain moves interleaved with the per-block sweep, aimed at the
    argmax resource of ``resource_busy_times``, migrations amortized over
    ``amortize`` intervals instead of the myopic one-interval payback that
    left straggler rescues permanently refused), and compared against a
    refined ``stage_balanced_chain`` seed.  The returned placement's
    D_pipe(K) is never worse than the ``search="rescoring"`` result on the
    same inputs (refinement is monotone and the chain candidate is only
    adopted when it wins), and ``pipeline_k=1`` stays bit-for-bit the
    paper algorithm — the search only ever runs on the pipelined
    objective, where D_T + D_mig is the tie-break."""
    name = "resource-aware"

    SEARCH_MODES = ("rescoring", "bottleneck")

    def __init__(self, blocks, cost, *, deadline: float = 5.0,
                 migration_filter: bool = True,
                 refine_passes: Optional[int] = None,
                 pipeline_k: int = 1, search: str = "rescoring",
                 amortize: int = 16, chain_seed: bool = True,
                 search_rounds: int = 4, min_gain: float = 0.0, **kw):
        super().__init__(blocks, cost)
        if search not in self.SEARCH_MODES:
            raise ValueError(f"search must be one of {self.SEARCH_MODES}, "
                             f"got {search!r}")
        self.assigner = ResourceAwareAssigner(blocks, cost,
                                              deadline=deadline, **kw)
        self.migration_filter = migration_filter
        self.pipeline_k = pipeline_k
        self.search = search
        self.amortize = amortize
        self.chain_seed = chain_seed
        self.search_rounds = search_rounds
        self.min_gain = min_gain
        # chain re-seed memo: the ``prev`` placement the chain candidate
        # last LOST against.  While the incumbent is unchanged the seed
        # is deterministic in (blocks, cost) and the race re-runs to the
        # same verdict, so the whole seed+refine pass is skipped.
        self._chain_lost_to = None
        self.chain_reseeds = 0
        self.chain_reseed_skips = 0
        multi = graph_of(self.blocks).n_layers > 1
        self.refine_passes = (1 if multi else 0) \
            if refine_passes is None else refine_passes

    def _objective(self, prev, place, net, tau) -> float:
        """D_T + D_mig, or D_pipe(K) + D_mig when pipeline-aware."""
        from repro_torch.core.delay import pipelined_total_delay
        return pipelined_total_delay(prev, place, self.blocks, self.cost,
                                     net, tau, k=self.pipeline_k)

    def _refine(self, prev, place, net, tau):
        """Best-improvement local search on the objective (memory-feasible
        single-block moves), at most ``refine_passes`` sweeps."""
        from repro_torch.core.delay import memory_usage
        cur = place.copy()
        cur_val = self._objective(prev, cur, net, tau)
        mem = self.cost.memory_vector(self.blocks, tau)
        use = memory_usage(cur, self.blocks, self.cost, net, tau)
        for _ in range(self.refine_passes):
            improved = False
            for i in range(len(self.blocks)):
                src = int(cur[i])
                best_j, best_val = src, cur_val
                for j in net.active_ids:
                    if j == src or use[j] + mem[i] > net.mem_avail[j]:
                        continue
                    cur[i] = j
                    val = self._objective(prev, cur, net, tau)
                    if val < best_val - 1e-12:
                        best_j, best_val = j, val
                cur[i] = best_j
                if best_j != src:
                    use[src] -= mem[i]
                    use[best_j] += mem[i]
                    cur_val = best_val
                    improved = True
            if not improved:
                break
        return cur

    def place(self, net, tau, prev):
        placement, stats = self.assigner.assign(net, tau, prev)
        self.last_stats = stats
        if placement is None:
            return placement
        if self.refine_passes > 0:
            placement = self._refine(prev, placement, net, tau)
        if prev is not None and self.migration_filter:
            from repro_torch.core.delay import revert_unpaying_migrations
            placement = revert_unpaying_migrations(
                prev, placement, self.blocks, self.cost, net, tau,
                k=self.pipeline_k, min_gain=self.min_gain)
        if self.search == "bottleneck" and self.pipeline_k > 1:
            placement = self._bottleneck_search(prev, placement, net, tau)
        return placement

    def _bottleneck_search(self, prev, base, net, tau):
        """The bottleneck-targeted search pass: refine the rescoring result
        toward the steady-state objective, race it against a refined
        stage-balanced chain seed, keep whichever wins on the amortized
        objective WITHOUT ever giving up the base result's D_pipe(K)."""
        from repro_torch.core.algorithm import (_pipe_value, refine_bottleneck,
                                          stage_balanced_chain)
        k = self.pipeline_k
        cand = refine_bottleneck(prev, base, self.blocks, self.cost, net,
                                 tau, k=k, amortize=self.amortize,
                                 rounds=self.search_rounds)
        if not self.chain_seed:
            return cand
        if self._chain_lost_to is not None and prev is not None and \
                np.array_equal(prev, self._chain_lost_to):
            self.chain_reseed_skips += 1
            return cand
        self.chain_reseeds += 1
        seed = stage_balanced_chain(self.blocks, self.cost, net, tau,
                                    pipeline_k=k)
        if seed is None:
            return cand
        alt = refine_bottleneck(prev, seed, self.blocks, self.cost, net,
                                tau, k=k, amortize=self.amortize,
                                rounds=self.search_rounds)
        c_pipe, _, c_mig = _pipe_value(prev, cand, self.blocks, self.cost,
                                       net, tau, k)
        a_pipe, _, a_mig = _pipe_value(prev, alt, self.blocks, self.cost,
                                       net, tau, k)
        # adopt the chain only when it beats the base-derived candidate on
        # the amortized objective AND does not worsen D_pipe(K) — the
        # never-worse-than-rescoring guarantee survives either way
        if a_pipe <= c_pipe + 1e-15 and \
                self.amortize * a_pipe + a_mig < self.amortize * c_pipe + c_mig:
            self._chain_lost_to = None
            return alt
        self._chain_lost_to = None if prev is None else \
            np.asarray(prev).copy()
        return cand


class BottleneckAwarePolicy(ResourceAwarePolicy):
    """``ResourceAwarePolicy(search="bottleneck")`` under its own policy
    name, so benchmarks/simulators can A/B the bottleneck-targeted search
    against the ``pipeline_k``-rescoring default by name.  With
    ``pipeline_k=1`` it degenerates to the paper algorithm bit-for-bit
    (the search only exists on the pipelined objective)."""
    name = "bottleneck-aware"

    def __init__(self, blocks, cost, **kw):
        kw.setdefault("search", "bottleneck")
        super().__init__(blocks, cost, **kw)


class GreedyPolicy(Policy):
    """Sort blocks by descending demand; place on the first feasible device
    without re-checking feasibility in subsequent steps (§V.A)."""
    name = "greedy"

    def place(self, net, tau, prev):
        mem = self.cost.memory_vector(self.blocks, tau)
        order = np.argsort(-mem)
        place = np.zeros(len(self.blocks), dtype=int)
        for i in order:
            placed = False
            for j in net.active_ids:
                if mem[i] <= net.mem_avail[j]:
                    place[i] = int(j)     # no aggregate re-check: greedy
                    placed = True
                    break
            if not placed:
                place[i] = int(np.argmax(net.mem_usable()))
        return place


class RoundRobinPolicy(Policy):
    """Cyclic assignment ignoring resource requirements (§V.A)."""
    name = "round-robin"

    def place(self, net, tau, prev):
        act = net.active_ids
        return act[np.arange(len(self.blocks)) % len(act)]


class StaticPolicy(Policy):
    """One initial resource-aware assignment, never migrated (§V.A)."""
    name = "static"

    def __init__(self, blocks, cost, **kw):
        super().__init__(blocks, cost)
        self._inner = ResourceAwarePolicy(blocks, cost, **kw)
        self._frozen: Optional[np.ndarray] = None

    def place(self, net, tau, prev):
        if self._frozen is None:
            self._frozen = self._inner.place(net, tau, None)
        return self._frozen


class DynamicLayerPolicy(Policy):
    """Re-checks each interval but treats the layer as ONE block (§V.A):
    the entire layer migrates to the single best device."""
    name = "dynamic-layer"

    def place(self, net, tau, prev):
        mem_total = self.cost.memory_vector(self.blocks, tau).sum()
        comp_total = self.cost.compute_vector(self.blocks, tau).sum()
        best, best_t = None, np.inf
        for j in net.active_ids:
            j = int(j)
            if mem_total > net.mem_avail[j]:
                continue
            t = comp_total / net.compute_avail[j]
            if prev is not None and int(prev[0]) != j:
                # whole-layer migration over the slowest involved link
                t += mem_total / net.bandwidth[int(prev[0]), j]
            if t < best_t:
                best, best_t = j, t
        if best is None:
            best = int(np.argmax(net.mem_usable()))
        return np.full(len(self.blocks), best, dtype=int)


class _PipelinePolicy(Policy):
    """Shared machinery for the layer-sharding SOTA baselines.

    Both EdgeShard [1] and Galaxy [3] shard the model by *contiguous layer
    groups*; a single decode token flows through the stages sequentially —
    pipeline parallelism has no intra-token parallelism, which is exactly
    the weakness the paper exploits.  Subclasses set the stage structure.

    Two evaluation modes, keyed off the block list:

    - aggregate (single-layer column blocks): the stage structure cannot
      be expressed as a block placement, so this class provides its own
      per-step pipeline delay (``step_delay``) and per-device memory
      (``device_memory``) hooks the simulator consumes, plus the
      swap-stall overload semantics shared with Eq. 6-based policies.

    - per-layer graph (multi-layer ``make_blocks``): ``place`` returns the
      stage structure as an *actual* per-layer block placement
      (``aggregate_semantics`` is False) and the simulator prices it with
      the unified per-layer Eq.-6 delay model like every other policy.

    Per-layer costs are Table-I sums over one layer's blocks.
    """
    stages: list  # list of (device_list, n_layers_in_stage)

    def __init__(self, blocks, cost, **kw):
        super().__init__(blocks, cost)
        self._graph = graph_of(self.blocks)
        self.aggregate_semantics = self._graph.n_layers == 1
        self._layer_cost = dataclasses.replace(cost, n_layers=1)
        self._layer_blocks = self._graph.layer_blocks(0)
        self.stages = []
        # graph-mode block placement, computed ONCE with the stages: these
        # baselines are static during decoding, so the intra-stage layout
        # must not chase compute_avail fluctuations (that would charge the
        # static baseline spurious migration delay)
        self._frozen_place: Optional[np.ndarray] = None

    # stage layout --------------------------------------------------------
    def _stage_layers(self):
        """Consecutive layer ranges per stage: [(devs, [layers...])]."""
        out, nxt = [], 0
        for devs, n in self.stages:
            out.append((devs, list(range(nxt, nxt + n))))
            nxt += n
        return out

    def _graph_placement(self, net: DeviceNetwork) -> np.ndarray:
        """Materialize the stage structure as a per-layer block placement
        (graph mode only).  Subclasses refine intra-stage placement."""
        place = np.zeros(len(self.blocks), dtype=int)
        for devs, layer_ids in self._stage_layers():
            for l in layer_ids:
                for b in self._graph.layer_blocks(l):
                    place[b.index] = devs[0]
        return place

    # one layer's aggregate compute / memory ------------------------------
    def _layer_compute(self, tau: int) -> float:
        return float(sum(self._layer_cost.compute(b, tau)
                         for b in self._layer_blocks))

    def _layer_memory(self, tau: int) -> float:
        return float(sum(self._layer_cost.memory(b, tau)
                         for b in self._layer_blocks))

    def _boundary_bytes(self, tau: int) -> float:
        return self._layer_cost.proj_to_ffn_bytes(tau)  # activations D·b(·L)

    # simulator hooks ------------------------------------------------------
    def device_memory(self, net: DeviceNetwork, tau: int) -> np.ndarray:
        use = np.zeros(net.n_devices)
        per_layer = self._layer_memory(tau)
        for devs, n_layers in self.stages:
            share = per_layer * n_layers / len(devs)
            for j in devs:
                use[j] += share
        return use

    def step_delay(self, net: DeviceNetwork, tau: int) -> float:
        """Sequential pipeline traversal of one token."""
        t = 0.0
        per_layer = self._layer_compute(tau)
        prev_exit = net.controller
        for devs, n_layers in self.stages:
            # TP within the stage: compute split over members, bounded by the
            # slowest member; per-layer TP sync of 2 all-gathers of D·b over
            # the weakest intra-stage link (Galaxy's tensor parallelism).
            slowest = min(net.compute_avail[j] for j in devs)
            t += n_layers * per_layer / (len(devs) * slowest)
            if len(devs) > 1:
                intra = min(net.bandwidth[a, b] for a in devs for b in devs
                            if a != b)
                t += n_layers * 2 * self._boundary_bytes(tau) / intra
            entry = devs[0]
            if entry != prev_exit:
                t += self._boundary_bytes(tau) / net.bandwidth[prev_exit, entry]
            prev_exit = devs[-1]
        return t


class EdgeShardPolicy(_PipelinePolicy):
    """EdgeShard [1]: static layer-wise shards, one device per stage, layer
    counts proportional to device compute; device subset chosen once at τ=1
    to fit the τ=1 footprint (no K/V-growth adaptation — the paper's
    criticism)."""
    name = "edgeshard"

    def place(self, net, tau, prev):
        if not self.stages:
            L = self.cost.n_layers
            act = net.active_ids
            order = [int(j) for j in act[np.argsort(-net.compute_avail[act])]]
            mem_l1 = self._layer_memory(1)
            # smallest fast subset whose τ=1 memory fits
            chosen: list = []
            for j in order:
                chosen.append(j)
                cap = sum(net.mem_avail[k] for k in chosen)
                if cap >= L * mem_l1 and len(chosen) >= 2:
                    break
            speeds = np.array([net.compute_avail[j] for j in chosen])
            shares = np.maximum(1, np.round(L * speeds / speeds.sum())).astype(int)
            while shares.sum() > L:
                shares[np.argmax(shares)] -= 1
            while shares.sum() < L:
                shares[np.argmax(speeds)] += 1
            self.stages = [([j], int(s)) for j, s in zip(chosen, shares)]
        if not self.aggregate_semantics:
            # per-layer graph: the layer shards ARE a block placement —
            # every block of a stage's layers on the stage device
            if self._frozen_place is None:
                self._frozen_place = self._graph_placement(net)
            return self._frozen_place.copy()
        # representative block-level placement (metrics only): everything on
        # the first stage's device
        return np.full(len(self.blocks), self.stages[0][0][0], dtype=int)


class GalaxyPolicy(_PipelinePolicy):
    """Galaxy [3]: hybrid pipeline + tensor parallelism — devices grouped
    into TP islands of size ``tp``; contiguous layer shards proportional to
    island compute; static during decoding."""
    name = "galaxy"

    def __init__(self, blocks, cost, *, tp: int = 4, **kw):
        super().__init__(blocks, cost, **kw)
        self.tp = tp

    def place(self, net, tau, prev):
        if not self.stages:
            L = self.cost.n_layers
            act = net.active_ids
            order = [int(j) for j in act[np.argsort(-net.compute_avail[act])]]
            groups = [order[i:i + self.tp] for i in
                      range(0, len(order) - self.tp + 1, self.tp)]
            if not groups:
                groups = [order]
            agg = np.array([sum(net.compute_avail[j] for j in g)
                            for g in groups])
            shares = np.maximum(0, np.round(L * agg / agg.sum())).astype(int)
            while shares.sum() > L:
                shares[np.argmax(shares)] -= 1
            while shares.sum() < L:
                shares[np.argmax(agg)] += 1
            self.stages = [(g, int(s)) for g, s in zip(groups, shares) if s > 0]
        if not self.aggregate_semantics:
            # hybrid TP+PP as real blocks: each stage's heads round-robin
            # over its island, proj/ffn on the island's fastest member —
            # frozen with the stages (static during decoding)
            if self._frozen_place is None:
                place = np.zeros(len(self.blocks), dtype=int)
                for devs, layer_ids in self._stage_layers():
                    fastest = max(devs, key=lambda j: net.compute_avail[j])
                    for l in layer_ids:
                        for i, h in enumerate(self._graph.heads[l]):
                            place[h.index] = devs[i % len(devs)]
                        place[self._graph.proj[l].index] = fastest
                        for ob in self._graph.out_blocks(l):
                            place[ob.index] = fastest
                self._frozen_place = place
            return self._frozen_place.copy()
        return np.full(len(self.blocks), self.stages[0][0][0], dtype=int)


class ColumnCoPartitionPolicy(Policy):
    """The old ``layer_mode="columns"`` lift expressed as a policy over the
    per-layer block graph: Algorithm 1 runs on the single-layer column
    blocks (costs aggregated over all layers), and the resulting column
    placement is replicated to every layer — head i of *every* layer on one
    device, one shared proj/ffn device.  Evaluated under the same per-layer
    delay model as every other graph policy, this is the control arm the
    per-layer ``ResourceAwarePolicy`` must beat on heterogeneous-bandwidth
    networks (it cannot adapt placement per layer or shorten inter-layer
    hops)."""
    name = "column-copartition"

    def __init__(self, blocks, cost, **kw):
        super().__init__(blocks, cost)
        g = graph_of(self.blocks)
        self._n_per_layer = len(g.layer_blocks(0))
        col_cost = dataclasses.replace(cost, layer_mode="columns")
        self._col_blocks = make_blocks(cost.n_heads, 1, cost.n_experts,
                                       cost.expert_replicas)
        self._inner = ResourceAwarePolicy(self._col_blocks, col_cost, **kw)

    def place(self, net, tau, prev):
        # prev is column-replicated by construction: layer 0's slice is the
        # column placement
        prev_col = None if prev is None else \
            np.asarray(prev[:self._n_per_layer], dtype=int)
        col = self._inner.place(net, tau, prev_col)
        self.last_stats = getattr(self._inner, "last_stats", None)
        if col is None:
            return None
        return replicate_placement(col, self.blocks)


class LookaheadPolicy(ResourceAwarePolicy):
    """Beyond-paper: the paper's stated future work (§VI — "incorporate
    limited foresight ... predict resource availability ahead of time").

    Per-device EWMA + trend forecast of C_j over the next ``horizon``
    intervals; Algorithm 1 runs against the forecast *average* (placements
    stop chasing transient dips), and the migration filter amortizes the
    one-time migration cost over the horizon (a move pays if
    horizon·ΔD_T > D_mig instead of 1·ΔD_T > D_mig).
    """
    name = "lookahead"

    def __init__(self, blocks, cost, *, horizon: int = 8, ewma: float = 0.5,
                 **kw):
        super().__init__(blocks, cost, **kw)
        self.horizon = horizon
        self.ewma = ewma
        self._level: Optional[np.ndarray] = None
        self._trend: Optional[np.ndarray] = None

    def _forecast(self, net: DeviceNetwork) -> np.ndarray:
        obs = net.compute_avail.astype(float)
        if self._level is not None and len(self._level) != len(obs):
            self._level = None  # device joined: restart the forecast state
        if self._level is None:
            self._level = obs.copy()
            self._trend = np.zeros_like(obs)
        else:
            prev = self._level.copy()
            self._level = self.ewma * obs + (1 - self.ewma) * \
                (self._level + self._trend)
            self._trend = 0.3 * (self._level - prev) + 0.7 * self._trend
        # mean forecast over the horizon, clipped to physical bounds
        steps = np.arange(1, self.horizon + 1).mean()
        pred = self._level + steps * self._trend
        pred = np.clip(pred, 0.05 * net.compute_max, net.compute_max)
        # the clip floor must not resurrect an inactive device's forecast
        return np.where(net.active, pred, 0.0)

    def place(self, net, tau, prev):
        pred_net = net.copy()
        pred_net.compute_avail = self._forecast(net)
        placement, stats = self.assigner.assign(pred_net, tau, prev)
        self.last_stats = stats
        if placement is None or prev is None or not self.migration_filter:
            return placement
        from repro_torch.core.delay import (inference_delay, memory_feasible,
                                      migration_delay)
        current = placement.copy()

        def amortized(pl):
            # horizon intervals of inference + one migration
            return self.horizon * inference_delay(
                pl, self.blocks, self.cost, pred_net, tau) + \
                migration_delay(prev, pl, self.blocks, self.cost,
                                pred_net, tau)

        cur_val = amortized(current)
        for i in np.flatnonzero(current != prev):
            trial = current.copy()
            trial[i] = prev[i]
            if not memory_feasible(trial, self.blocks, self.cost, net, tau):
                continue
            val = amortized(trial)
            if val <= cur_val:
                current, cur_val = trial, val
        return current


ALL_POLICIES = {
    p.name: p for p in (ResourceAwarePolicy, BottleneckAwarePolicy,
                        GreedyPolicy, RoundRobinPolicy,
                        StaticPolicy, DynamicLayerPolicy, EdgeShardPolicy,
                        GalaxyPolicy, ColumnCoPartitionPolicy,
                        LookaheadPolicy)
}
