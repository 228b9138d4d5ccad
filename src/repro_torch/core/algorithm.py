"""Algorithm 1 — Resource-Aware LLM block assignment at interval τ (paper §IV).

Faithful to the pseudocode:
  1-3  reset counters, start T_max timer, gather {M_j, C_j, R_jk}
  4    sort blocks by descending demand (memory; compute tie-break)
  5-22 per block: score all devices, take argmin; tentative assign; if the
       device's *aggregate* memory/compute over-runs, undo and call
       ResolveResourceOverload; count migrations against U = |B|·|V|
  23-29 global constraint check; BacktrackForResourceViolations
  30   return the assignment (or INFEASIBLE)

Compute feasibility of a device at τ means: summed block processing time
fits the interval deadline (C_j(τ)·deadline FLOPs) — see scoring.py for why
the deadline normalization is needed.

Beyond the pseudocode we also implement the objective-aware tie-break the
text requires ("minimize D_T + D_mig"): when several devices score within
``tie_tol`` of the best, prefer the one with the lowest marginal
(migration + inference) delay contribution.  Disable with
``objective_tiebreak=False`` for the ablation (tests cover both).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.blocks import Block, CostModel, graph_of
from repro_torch.core.delay import total_delay
from repro_torch.core.network import DeviceNetwork
from repro_torch.core.scoring import score

INFEASIBLE = None


@dataclasses.dataclass
class AlgoStats:
    migrations: int = 0
    backtracks: int = 0
    elapsed: float = 0.0
    infeasible: bool = False
    score_evals: int = 0


class ResourceAwareAssigner:
    """The paper's myopic per-interval assignment policy."""

    def __init__(self, blocks: Sequence[Block], cost: CostModel,
                 *, deadline: float = 5.0, t_max: float = 10.0,
                 objective_tiebreak: bool = True, tie_tol: float = 0.15,
                 hysteresis: float = 0.9):
        self.blocks = list(blocks)
        self.cost = cost
        self.deadline = deadline
        self.t_max = t_max
        self.objective_tiebreak = objective_tiebreak
        self.tie_tol = tie_tol
        # "at most one migration per head per interval to avoid back-and-forth
        # overhead" (§III.D(a)): a block only leaves its device for a >=
        # (1-hysteresis) score improvement — the anti-thrash discount.
        self.hysteresis = hysteresis

    # ------------------------------------------------------------------ API
    def assign(self, net: DeviceNetwork, tau: int,
               prev: Optional[np.ndarray] = None
               ) -> tuple[Optional[np.ndarray], AlgoStats]:
        stats = AlgoStats()
        t0 = time.monotonic()
        B, V = len(self.blocks), net.n_devices
        U = B * V
        mem = self.cost.memory_vector(self.blocks, tau)
        comp = self.cost.compute_vector(self.blocks, tau)

        # line 4: descending by memory demand (compute tie-break)
        order = sorted(range(B), key=lambda i: (-mem[i], -comp[i]))

        place = np.full(B, -1, dtype=int)
        mem_used = np.zeros(V)
        comp_used = np.zeros(V)

        def assigned_ok(j) -> bool:
            return (net.is_active(j) and
                    mem_used[j] <= net.mem_avail[j] and
                    comp_used[j] <= net.compute_avail[j] * self.deadline)

        def do_place(i, j):
            place[i] = j
            mem_used[j] += mem[i]
            comp_used[j] += comp[i]

        def undo_place(i):
            j = place[i]
            if j >= 0:
                mem_used[j] -= mem[i]
                comp_used[j] -= comp[i]
                place[i] = -1

        def device_order(i: int) -> tuple[List[int], np.ndarray]:
            """Returns (candidate order, raw load-aware scores).  The same
            load-aware scores drive both the sort and the caller's
            feasibility check — one scoring convention (hysteresis and the
            objective tie-break only perturb the *order*, never the raw
            scores the feasibility test reads)."""
            bl = self.blocks[i]
            # Load-aware scores: free memory and queued compute on j are
            # subtracted/added (Algorithm 1 line 10's aggregate check, folded
            # into the score so the argmin spreads load instead of stacking
            # everything on the roomiest device).  Counterpart devices for
            # the comm factor come from the controller's best current
            # knowledge: this round's tentative placement overlaid on prev
            # (-1 = still unknown), so even the first interval sees the
            # links its already-placed proj/ffn/neighbor-layer blocks use.
            view = place if prev is None else np.where(place >= 0, place, prev)
            raw = np.array([
                score(bl, j, self.blocks, view, self.cost, net, tau,
                      deadline=self.deadline, mem_used=mem_used,
                      compute_used=comp_used) for j in range(V)])
            stats.score_evals += V
            scores = raw.copy()
            if prev is not None:
                scores[prev[i]] *= self.hysteresis  # anti-thrash stickiness
            order = list(np.argsort(scores, kind="stable"))
            if self.objective_tiebreak and prev is not None:
                best = scores[order[0]]
                ties = [j for j in order
                        if scores[j] <= best * (1 + self.tie_tol) + 1e-12][:6]
                if len(ties) > 1:
                    def marginal(j):
                        trial = place.copy()
                        trial[i] = j
                        filled = trial.copy()
                        filled[filled < 0] = prev[filled < 0] if prev is not None else 0
                        return total_delay(prev, filled, self.blocks,
                                           self.cost, net, tau)
                    ties.sort(key=marginal)
                    rest = [j for j in order if j not in ties]
                    order = ties + rest
            return order, raw

        # lines 5-22 -----------------------------------------------------
        for i in order:
            if time.monotonic() - t0 > self.t_max:
                return self._fail(stats, t0)
            cand, cand_scores = device_order(i)
            placed = False
            for j in cand:
                if cand_scores[j] > 1.0:
                    # Infeasible under the SAME load-aware convention the
                    # candidate list is sorted by.  Skip rather than break:
                    # hysteresis and the objective tie-break perturb the
                    # order, so a feasible device can follow an infeasible
                    # one (the old load-blind `break` here silently skipped
                    # such devices).
                    continue
                do_place(i, j)
                if assigned_ok(j):
                    placed = True
                    if prev is not None and prev[i] != j:
                        stats.migrations += 1
                        if stats.migrations > U:
                            return self._fail(stats, t0)
                    break
                # line 10-14: revert + try to free capacity
                undo_place(i)
                if self._resolve_overload(i, j, place, mem_used, comp_used,
                                          mem, comp, net, stats, U):
                    do_place(i, j)
                    placed = True
                    break
                stats.migrations += 1
                if stats.migrations > U:
                    return self._fail(stats, t0)
            if not placed:
                # lines 18-21: no device feasible for i alone
                if not self._resolve_overload(i, None, place, mem_used,
                                              comp_used, mem, comp, net,
                                              stats, U):
                    return self._fail(stats, t0)
                # retry on the freshly freed device set (permissive: the
                # desperate path takes any ACTIVE device the aggregate
                # check OKs — liveness is enforced even here, since this
                # path skips the per-block score filter)
                cand, _ = device_order(i)
                for j in cand:
                    if not net.is_active(j):
                        continue
                    do_place(i, j)
                    if assigned_ok(j):
                        placed = True
                        break
                    undo_place(i)
                if not placed:
                    return self._fail(stats, t0)

        # lines 23-29 ------------------------------------------------------
        guard = 0
        while not self._all_ok(place, mem_used, comp_used, net):
            if guard > U or time.monotonic() - t0 > self.t_max:
                return self._fail(stats, t0)
            if not self._backtrack(place, mem_used, comp_used, mem, comp,
                                   net, stats):
                return self._fail(stats, t0)
            stats.backtracks += 1
            guard += 1

        stats.elapsed = time.monotonic() - t0
        return place, stats

    # ------------------------------------------------------------- helpers
    def _fail(self, stats: AlgoStats, t0) -> tuple[None, AlgoStats]:
        stats.infeasible = True
        stats.elapsed = time.monotonic() - t0
        return INFEASIBLE, stats

    def _all_ok(self, place, mem_used, comp_used, net) -> bool:
        if (place < 0).any():
            return False
        return bool(np.all(mem_used <= net.mem_avail + 1e-9) and
                    np.all(comp_used <= net.compute_avail * self.deadline
                           + 1e-9))

    def _resolve_overload(self, i: int, target: Optional[int], place,
                          mem_used, comp_used, mem, comp, net,
                          stats: AlgoStats, U: int) -> bool:
        """ResolveResourceOverload (§IV.B1): migrate already-placed blocks
        away from the overloaded device (smallest sufficient set, smallest
        blocks first) onto devices with headroom."""
        need_mem = mem[i]
        need_comp = comp[i]
        devices = [target] if target is not None else \
            list(np.argsort(mem_used))  # try least-loaded device first
        for j in devices:
            if j is None or not net.is_active(j):
                continue
            movable = [k for k in range(len(place)) if place[k] == j and k != i]
            movable.sort(key=lambda k: mem[k])
            moved: List[tuple[int, int]] = []
            for k in movable:
                if (mem_used[j] + need_mem <= net.mem_avail[j] and
                        comp_used[j] + need_comp
                        <= net.compute_avail[j] * self.deadline):
                    break
                dest = self._find_room(k, j, place, mem_used, comp_used,
                                       mem, comp, net)
                if dest is None:
                    continue
                place[k] = dest
                mem_used[j] -= mem[k]
                comp_used[j] -= comp[k]
                mem_used[dest] += mem[k]
                comp_used[dest] += comp[k]
                moved.append((k, j))
                stats.migrations += 1
                if stats.migrations > U:
                    return False
            if (mem_used[j] + need_mem <= net.mem_avail[j] and
                    comp_used[j] + need_comp
                    <= net.compute_avail[j] * self.deadline):
                return True
            # undo this device's moves and try the next candidate
            for k, src in reversed(moved):
                dest = place[k]
                place[k] = src
                mem_used[dest] -= mem[k]
                comp_used[dest] -= comp[k]
                mem_used[src] += mem[k]
                comp_used[src] += comp[k]
        return False

    def _find_room(self, k: int, avoid: int, place, mem_used, comp_used,
                   mem, comp, net) -> Optional[int]:
        best, best_slack = None, -np.inf
        for j in net.active_ids:
            if j == avoid:
                continue
            if (mem_used[j] + mem[k] <= net.mem_avail[j] and
                    comp_used[j] + comp[k]
                    <= net.compute_avail[j] * self.deadline):
                slack = (net.mem_avail[j] - mem_used[j] - mem[k]) \
                    / net.mem_avail[j]
                if slack > best_slack:
                    best, best_slack = j, slack
        return best

    def _backtrack(self, place, mem_used, comp_used, mem, comp, net,
                   stats: AlgoStats) -> bool:
        """BacktrackForResourceViolations (§IV.B2): remove a minimal set of
        blocks from each violated device (largest first) and re-place them."""
        progressed = False
        for j in range(net.n_devices):
            while (mem_used[j] > net.mem_avail[j] + 1e-9 or
                   comp_used[j] > net.compute_avail[j] * self.deadline + 1e-9):
                on_j = [k for k in range(len(place)) if place[k] == j]
                if not on_j:
                    break
                k = max(on_j, key=lambda t: mem[t])
                dest = self._find_room(k, j, place, mem_used, comp_used,
                                       mem, comp, net)
                if dest is None:
                    return False
                place[k] = dest
                mem_used[j] -= mem[k]
                comp_used[j] -= comp[k]
                mem_used[dest] += mem[k]
                comp_used[dest] += comp[k]
                progressed = True
        return progressed


# ---------------------------------------------------------------------------
# Bottleneck-targeted pipeline placement search (beyond Algorithm 1)
# ---------------------------------------------------------------------------
#
# Algorithm 1 minimizes the myopic single-token objective D_T + D_mig; on
# multi-device edge topologies the pipelined steady state is bounded by the
# busiest single RESOURCE instead (delay.resource_busy_times).  The two
# functions below are the search primitives ResourceAwarePolicy's
# ``search="bottleneck"`` mode composes:
#
#  - ``stage_balanced_chain``: an EdgeShard-style layer→device chain seed
#    whose contiguous layer runs are weighted by per-device compute AND the
#    inter-stage link bytes — the layer-disjoint stage structure Algorithm
#    1's per-block argmin never proposes.
#  - ``refine_bottleneck``: local search that relieves the argmax resource
#    with layer-chain moves (a whole layer relocated as one move,
#    preferentially along fast links) interleaved with the per-block
#    best-improvement sweep, accepting a move only when it strictly lowers
#    D_pipe(k) and its migration bytes amortize over ``amortize`` intervals
#    (the myopic one-interval payback is exactly why rescue migrations
#    never applied under fluctuating load).  Exact D_pipe ties break on
#    D_T + D_mig, the paper objective.


def _pipe_value(prev, place, blocks, cost, net, tau, k: int):
    """(D_pipe(k), D_T + D_mig, D_mig) — the lexicographic search key plus
    the migration component the amortization gate prices separately."""
    from repro_torch.core.delay import (inference_delay, migration_delay,
                                  pipeline_bottleneck)
    d_t = inference_delay(place, blocks, cost, net, tau)
    b = min(pipeline_bottleneck(place, blocks, cost, net, tau), d_t)
    d_pipe = (d_t + (k - 1) * b) / k
    d_mig = migration_delay(prev, place, blocks, cost, net, tau)
    return float(d_pipe), float(d_t + d_mig), float(d_mig)


def stage_balanced_chain(blocks: Sequence[Block], cost: CostModel,
                         net: DeviceNetwork, tau: int, *,
                         pipeline_k: int = 2,
                         rebalance_passes: int = 16) -> Optional[np.ndarray]:
    """Stage-balanced layer→device chain: every block of a contiguous
    layer run on one device, runs sized so no stage's (compute + incoming
    inter-stage transfer) time sticks out.

    Device order is a greedy fast-link path (from every start, keep the
    unvisited device with the fastest link from the current chain end);
    layer shares start proportional to compute_avail and a boundary-layer
    rebalance then walks single layers off the max-time stage.  Candidate
    chains are scored by (D_pipe(pipeline_k), D_T); only memory-feasible
    chains are returned, ``None`` when no start yields one (tiny-memory
    devices)."""
    from repro_torch.core.delay import memory_feasible
    g = graph_of(blocks)
    L = g.n_layers
    act = [int(j) for j in net.active_ids]  # chains only over live devices
    layer_comp = float(sum(cost.compute(b, tau) for b in g.layer_blocks(0)))
    # expert graphs: per-layer compute varies with the router load, so
    # stage compute is a prefix-sum range, not shares[s] x one layer
    # (dense graphs keep the original scalar arithmetic bit-for-bit)
    has_experts = any(g.experts[l] for l in range(L))
    if has_experts:
        comp_cum = np.concatenate(
            [[0.0], np.cumsum([sum(cost.compute(b, tau)
                                   for b in g.layer_blocks(l))
                               for l in range(L)])])
    boundary = cost.interlayer_bytes(tau)

    def chain_placement(devs: List[int], shares: np.ndarray) -> np.ndarray:
        place = np.empty(len(blocks), dtype=int)
        nxt = 0
        for dev, n in zip(devs, shares):
            for _ in range(int(n)):
                for b in g.layer_blocks(nxt):
                    place[b.index] = dev
                nxt += 1
        return place

    def stage_time(devs, shares, s: int) -> float:
        if has_experts:
            start = int(np.sum(shares[:s]))
            comp = comp_cum[start + int(shares[s])] - comp_cum[start]
            t = comp / net.compute_avail[devs[s]]
        else:
            t = shares[s] * layer_comp / net.compute_avail[devs[s]]
        # incoming edge comes from the nearest PRECEDING stage that still
        # holds layers (a rebalanced-to-zero stage is not on the chain)
        src = net.controller
        for p in range(s - 1, -1, -1):
            if shares[p] > 0:
                src = devs[p]
                break
        if src != devs[s]:
            t += boundary / net.bandwidth[src, devs[s]]
        return t

    best: Optional[tuple] = None
    for start in act:
        order, left = [start], set(act) - {start}
        while left:
            nxt = max(left, key=lambda j: net.bandwidth[order[-1], j])
            order.append(nxt)
            left.remove(nxt)
        n = len(order)
        speeds = net.compute_avail[order]
        shares = np.maximum(0, np.round(L * speeds / speeds.sum())).astype(int)
        while shares.sum() > L:
            shares[int(np.argmax(shares))] -= 1
        while shares.sum() < L:
            shares[int(np.argmax(speeds * (shares > 0)))] += 1
        # walk boundary layers off the worst stage onto a chain neighbor
        for _ in range(rebalance_passes):
            used = [s for s in range(n) if shares[s] > 0]
            times = {s: stage_time(order, shares, s) for s in used}
            worst = max(used, key=lambda s: times[s])
            moved = False
            for nb in (worst - 1, worst + 1):
                if not (0 <= nb < n):
                    continue
                trial = shares.copy()
                trial[worst] -= 1
                trial[nb] += 1
                t_used = [s for s in range(n) if trial[s] > 0]
                t_worst = max(stage_time(order, trial, s) for s in t_used)
                if t_worst < times[worst] - 1e-15:
                    shares, moved = trial, True
                    break
            if not moved:
                break
        chain = [(d, int(n)) for d, n in zip(order, shares) if n > 0]
        place = chain_placement([d for d, _ in chain],
                                np.array([n for _, n in chain]))
        if not memory_feasible(place, blocks, cost, net, tau):
            continue
        key = _pipe_value(None, place, blocks, cost, net, tau, pipeline_k)[:2]
        if best is None or key < best[0]:
            best = (key, place)
    return None if best is None else best[1]


def refine_bottleneck(prev: Optional[np.ndarray], place: np.ndarray,
                      blocks: Sequence[Block], cost: CostModel,
                      net: DeviceNetwork, tau: int, *, k: int,
                      amortize: int = 16, rounds: int = 4) -> np.ndarray:
    """Bottleneck-targeted local search: shrink D_pipe(k) by relieving the
    argmax resource of ``resource_busy_times``.

    Each round reads ``bottleneck_attribution``, then tries (a) layer-chain
    moves — every layer with a block on the bottleneck resource relocated
    whole to each feasible device — interleaved with (b) the per-block
    best-improvement sweep scoped to blocks resident on (or transferring
    over) that resource.  A move is accepted only when it strictly lowers
    D_pipe(k) AND the migration delay it adds pays back within ``amortize``
    intervals (``amortize · gain > added D_mig``) — the amortized version
    of §III.G's filter, without which a straggler's rescue migration never
    pays at λ=1 and the placement stays wedged.  Among equal-D_pipe moves
    the lower D_T + D_mig wins (the paper objective as tie-break).

    Monotone: the returned placement's D_pipe(k) is never worse than
    ``place``'s, so callers keep the rescoring policy's guarantees."""
    from repro_torch.core.delay import bottleneck_attribution, memory_usage
    g = graph_of(blocks)
    act = [int(j) for j in net.active_ids]  # moves only target live devices
    mem = cost.memory_vector(blocks, tau)
    cur = np.asarray(place, dtype=int).copy()
    cur_pipe, cur_tie, cur_mig = _pipe_value(prev, cur, blocks, cost, net,
                                             tau, k)
    use = memory_usage(cur, blocks, cost, net, tau)

    def try_move(idxs: List[int], j: int, best: Optional[tuple]):
        """Evaluate relocating blocks ``idxs`` to device ``j``; returns the
        updated best candidate (pipe, tie, mig, j)."""
        old = cur[idxs].copy()
        need = sum(mem[i] for i in idxs if cur[i] != j)
        if use[j] + need > net.mem_avail[j]:
            return best
        cur[idxs] = j
        pipe, tie, mig = _pipe_value(prev, cur, blocks, cost, net, tau, k)
        cur[idxs] = old
        if pipe >= cur_pipe - 1e-15:
            return best
        if amortize * (cur_pipe - pipe) <= (mig - cur_mig):
            return best          # migration bytes never pay back
        if best is None or (pipe, tie) < (best[0], best[1]):
            return (pipe, tie, mig, j)
        return best

    def commit(idxs: List[int], best: tuple):
        nonlocal cur_pipe, cur_tie, cur_mig
        for i in idxs:
            use[cur[i]] -= mem[i]
            use[best[3]] += mem[i]
        cur[idxs] = best[3]
        cur_pipe, cur_tie, cur_mig = best[:3]

    for _ in range(max(0, rounds)):
        improved = False
        kind, ident, _ = bottleneck_attribution(cur, blocks, cost, net, tau)
        hot_devs = {ident} if kind == "device" else set(ident)
        # (a) layer-chain moves: layers touching the bottleneck resource
        for l in range(g.n_layers):
            idxs = [b.index for b in g.layer_blocks(l)]
            if not any(int(cur[i]) in hot_devs for i in idxs):
                continue
            best = None
            for j in act:
                best = try_move(idxs, j, best)
            if best is not None:
                commit(idxs, best)
                improved = True
        # (b) per-block best-improvement sweep over the (possibly new)
        # bottleneck resource's resident blocks
        kind, ident, _ = bottleneck_attribution(cur, blocks, cost, net, tau)
        hot_devs = {ident} if kind == "device" else set(ident)
        for i in range(len(blocks)):
            if int(cur[i]) not in hot_devs:
                continue
            best = None
            for j in act:
                if j != int(cur[i]):
                    best = try_move([i], j, best)
            if best is not None:
                commit([i], best)
                improved = True
        if not improved:
            break
    return cur
