"""Delay model — Eq. (2)–(7) of the paper, generalized to a per-layer
block graph.

A placement is an int array ``place[block_index] -> device``.

Single layer (Eq. 6, with the natural completion of the pipeline: proj and
ffn processing included — the paper's equation lists the communication
terms explicitly and §III.E(b) defines processing delays for *every*
block; ``strict_eq6=True`` reproduces the bare printed form):

  D_T = max_{i∈H}( D_in→d(i) + D_proc(i) + D_{d(i)→d(proj)} )
        [+ D_proc(proj)] + D_{d(proj)→d(ffn)} [+ D_proc(ffn)]

Multi-layer (``make_blocks(h, n_layers)`` graphs): one decode token
traverses the layers sequentially — there is no intra-token pipelining —
so the total is the layer-composed critical path

  D_T = Σ_l D_layer(l)

where D_layer(l) is Eq. 6 applied to layer l's blocks with layer l's input
stage replaced by the inter-layer edge: layer 0's heads receive the token
embeddings from the controller (``input_bytes``), layer l>0's heads
receive the previous layer's output from d(ffn(l-1))
(``interlayer_bytes``).  Because the layers execute back-to-back, every
directed link serializes all layers' transfers and every device runs all
layers' resident blocks sequentially — the cross-layer sharing shows up as
the Σ_l composition, and the intra-layer sharing as Eq. 6's per-link /
per-device sums.  With n_layers=1 the loop body is the original Eq. 6
arithmetic, bit-for-bit.

Concurrency semantics (§III.E/F), per layer:
 - compute: blocks co-located on a device run sequentially — a head's
   processing term uses the *sum* of that layer's head compute on its
   device;
 - links: transfers sharing a directed link (j,k) are serialized — each
   head's comm term uses the summed volume on its link.  The inter-layer
   broadcast is one transfer per destination device (co-located heads
   share it), matching the controller-input convention.

Migration (Eq. 2/7): D_mig = Σ_i m_i(τ-1)/R_{j,k}(τ), serialized per link
— unchanged: per-layer blocks each contribute their single-layer
footprint.

Pipelined decode (beyond the printed model; Model-Distributed Inference,
arXiv 2505.18164, and the comm/compute overlap accounting of arXiv
2211.05102): with per-layer placements, consecutive decode tokens of
*different* requests can occupy layer-disjoint device sets concurrently.
``pipelined_inference_delay`` models K in-flight tokens: the first token
pays the full sequential critical path D_T (pipeline fill), every further
token is admitted one steady-state interval B later, where B is the
busiest single resource's per-token busy time (per-device compute and
per-directed-link transfer serialization are preserved — a resource can
only serve one token's work at a time).  Per-token amortized delay:

  D_pipe(K) = (D_T + (K-1)·B) / K,   B = min(bottleneck, D_T)

K=1 is bit-for-bit ``inference_delay``.  B is clamped to D_T because Eq. 6's
max-over-heads form can under-serialize transfers in *different* head
chains sharing one directed link; operationally a pipeline can always
degrade to sequential issue, so the steady-state interval never exceeds
D_T — which also makes D_pipe(K) ≤ D_T an invariant for every K ≥ 1.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.blocks import Block, CostModel, graph_of
from repro_torch.core.network import DeviceNetwork


def _rate(net: DeviceNetwork, j: int, k: int) -> float:
    if j == k:
        return np.inf
    return float(net.bandwidth[j, k])


def _cdiv(x: float, rate: float) -> float:
    """Compute-time division pricing a dead device (C_j = 0) as +inf
    without tripping numpy's divide-by-zero warning: a placement that
    still references an inactive device has unbounded delay."""
    return float(x) / float(rate) if rate > 0.0 else np.inf


def _expert_stage(g, l, place, cost, tau):
    """Per-device (load fraction, summed compute) of layer l's expert
    blocks: the router fan-out/combine structure the delay model prices.

    Zero-load slots contribute nothing (no tokens are routed there); the
    per-device compute is summed BEFORE the single divide by the device
    rate so a co-located uniform-load expert set prices bit-for-bit like
    the dense ffn it collapses to."""
    agg: dict = {}
    for eb in g.experts[l]:
        ld = cost.expert_load(eb)
        if ld == 0.0:
            continue
        d = int(place[eb.index])
        fr, cp = agg.get(d, (0.0, 0.0))
        agg[d] = (fr + ld, cp + cost.compute(eb, tau))
    return agg


def inference_delay(place: np.ndarray, blocks: Sequence[Block],
                    cost: CostModel, net: DeviceNetwork, tau: int,
                    *, strict_eq6: bool = False) -> float:
    """D_T(τ) for placement ``place``: Eq. 6 per layer, composed along the
    inter-layer edges (see module docstring)."""
    g = graph_of(blocks)
    total = 0.0
    # layer 0: token embeddings from the controller; expert layers hand a
    # (device, load fraction) SOURCE LIST to the next layer's heads — the
    # router combine — which the dense path degenerates to as [(ffn, 1.0)]
    sources = [(net.controller, 1.0)]
    w_in = cost.input_bytes(tau)
    w_head = cost.head_to_proj_bytes(tau)
    for l in range(g.n_layers):
        heads = g.heads[l]
        d_proj = int(place[g.proj[l].index])

        # per-device summed head compute (sequential sharing)
        head_compute_on = np.zeros(net.n_devices)
        for h in heads:
            head_compute_on[place[h.index]] += cost.compute(h, tau)
        # per-link summed head->proj volume (serialized sharing)
        vol_to_proj = np.zeros(net.n_devices)
        for h in heads:
            vol_to_proj[place[h.index]] += w_head

        worst = 0.0
        for h in heads:
            j = int(place[h.index])
            t_in = sum(fr * w_in / _rate(net, s, j) for s, fr in sources)
            t_proc = _cdiv(head_compute_on[j], net.compute_avail[j])
            t_out = vol_to_proj[j] / _rate(net, j, d_proj)
            worst = max(worst, t_in + t_proc + t_out)

        total += worst
        if not strict_eq6:
            total += _cdiv(cost.compute(g.proj[l], tau), net.compute_avail[d_proj])
        if g.ffn[l] is not None:
            d_ffn = int(place[g.ffn[l].index])
            total += cost.proj_to_ffn_bytes(tau) / _rate(net, d_proj, d_ffn)
            if not strict_eq6:
                total += _cdiv(cost.compute(g.ffn[l], tau),
                               net.compute_avail[d_ffn])
            sources = [(d_ffn, 1.0)]
        else:
            # expert stage: router fan-out (load-fraction-scaled
            # proj->expert transfer) + per-device expert compute, run in
            # parallel across expert devices -> the stage is the slowest
            # device's (transfer, compute) pair, added as two terms to
            # keep the dense float association when collapsed
            agg = _expert_stage(g, l, place, cost, tau)
            w_p2f = cost.proj_to_ffn_bytes(tau)
            stage_t = stage_c = 0.0
            stage = -1.0
            for d in sorted(agg):
                fr, cp = agg[d]
                t_x = fr * w_p2f / _rate(net, d_proj, d)
                t_c = 0.0 if strict_eq6 else _cdiv(cp, net.compute_avail[d])
                if t_x + t_c > stage:
                    stage, stage_t, stage_c = t_x + t_c, t_x, t_c
            total += stage_t
            if not strict_eq6:
                total += stage_c
            sources = [(d, agg[d][0]) for d in sorted(agg)]
        w_in = cost.interlayer_bytes(tau)
    return float(total)


def resource_busy_times(place: np.ndarray, blocks: Sequence[Block],
                        cost: CostModel, net: DeviceNetwork, tau: int,
                        *, strict_eq6: bool = False
                        ) -> tuple[np.ndarray, dict]:
    """Per-token busy time of every resource under ``place``: seconds each
    device computes and each directed link transfers for ONE token's
    traversal of all layers.  These are the §III.E serialization
    constraints expressed as steady-state pipeline occupancies: a stream of
    in-flight tokens cannot be admitted faster than the busiest resource
    drains one token's share.

    Returns ``(device_busy (V,), link_busy {(j, k): seconds})`` with
    same-device transfers omitted (rate ∞, zero busy either way).
    """
    g = graph_of(blocks)
    dev_busy = np.zeros(net.n_devices)
    link_busy: dict = {}

    def add_link(j: int, k: int, seconds: float):
        if j != k and seconds > 0.0:
            link_busy[(j, k)] = link_busy.get((j, k), 0.0) + seconds

    sources = [(net.controller, 1.0)]
    w_in = cost.input_bytes(tau)
    w_head = cost.head_to_proj_bytes(tau)
    for l in range(g.n_layers):
        heads = g.heads[l]
        d_proj = int(place[g.proj[l].index])
        head_devs = set()
        for h in heads:
            j = int(place[h.index])
            head_devs.add(j)
            dev_busy[j] += _cdiv(cost.compute(h, tau), net.compute_avail[j])
            add_link(j, d_proj, w_head / _rate(net, j, d_proj))
        # inter-layer broadcast: one transfer per destination device
        # (co-located heads share it — the controller-input convention);
        # expert layers fan in from every expert-hosting source device
        # with its load fraction's share of the activation
        for s, fr in sources:
            for j in sorted(head_devs):
                add_link(s, j, fr * w_in / _rate(net, s, j))
        if not strict_eq6:
            dev_busy[d_proj] += _cdiv(cost.compute(g.proj[l], tau),
                                      net.compute_avail[d_proj])
        if g.ffn[l] is not None:
            d_ffn = int(place[g.ffn[l].index])
            if not strict_eq6:
                dev_busy[d_ffn] += _cdiv(cost.compute(g.ffn[l], tau),
                                         net.compute_avail[d_ffn])
            add_link(d_proj, d_ffn,
                     cost.proj_to_ffn_bytes(tau) / _rate(net, d_proj, d_ffn))
            sources = [(d_ffn, 1.0)]
        else:
            agg = _expert_stage(g, l, place, cost, tau)
            w_p2f = cost.proj_to_ffn_bytes(tau)
            for d in sorted(agg):
                fr, cp = agg[d]
                if not strict_eq6:
                    dev_busy[d] += _cdiv(cp, net.compute_avail[d])
                add_link(d_proj, d, fr * w_p2f / _rate(net, d_proj, d))
            sources = [(d, agg[d][0]) for d in sorted(agg)]
        w_in = cost.interlayer_bytes(tau)
    return dev_busy, link_busy


def pipeline_bottleneck(place: np.ndarray, blocks: Sequence[Block],
                        cost: CostModel, net: DeviceNetwork, tau: int,
                        *, strict_eq6: bool = False) -> float:
    """Steady-state per-token interval of a fully pipelined decode stream:
    the busiest single resource's busy time (unclamped — callers comparing
    against D_T should use ``pipelined_inference_delay``)."""
    dev_busy, link_busy = resource_busy_times(place, blocks, cost, net, tau,
                                              strict_eq6=strict_eq6)
    worst = float(dev_busy.max()) if dev_busy.size else 0.0
    if link_busy:
        worst = max(worst, max(link_busy.values()))
    return worst


def bottleneck_attribution(place: np.ndarray, blocks: Sequence[Block],
                           cost: CostModel, net: DeviceNetwork, tau: int,
                           *, strict_eq6: bool = False) -> tuple:
    """WHICH resource is the pipeline bottleneck: the argmax of
    ``resource_busy_times``, i.e. the single device or directed link whose
    per-token busy time bounds the steady-state pipelined rate.

    Returns ``("device", j, seconds)`` or ``("link", (j, k), seconds)``
    with ``seconds == pipeline_bottleneck(...)``.  A bottleneck-targeted
    search relieves exactly this resource first — moving blocks that
    neither compute on it nor transfer over it cannot shrink B."""
    dev_busy, link_busy = resource_busy_times(place, blocks, cost, net, tau,
                                              strict_eq6=strict_eq6)
    kind: str = "device"
    ident: object = int(np.argmax(dev_busy)) if dev_busy.size else 0
    busy = float(dev_busy.max()) if dev_busy.size else 0.0
    for lk, seconds in link_busy.items():
        if seconds > busy:
            kind, ident, busy = "link", lk, float(seconds)
    return kind, ident, busy


def pipelined_inference_delay(place: np.ndarray, blocks: Sequence[Block],
                              cost: CostModel, net: DeviceNetwork, tau: int,
                              *, k: int = 1,
                              strict_eq6: bool = False) -> float:
    """Per-token D_T with ``k`` tokens in flight over layer-disjoint stages
    (module docstring): (D_T + (k-1)·B)/k with B = min(bottleneck, D_T).

    ``k=1`` returns ``inference_delay`` bit-for-bit; D_pipe(k) ≤ D_T for
    every k ≥ 1, with equality exactly when nothing overlaps (single
    device, or B == D_T)."""
    if k < 1:
        raise ValueError(f"pipeline depth k must be >= 1, got {k}")
    d_t = inference_delay(place, blocks, cost, net, tau,
                          strict_eq6=strict_eq6)
    if k == 1:
        return d_t
    b = min(pipeline_bottleneck(place, blocks, cost, net, tau,
                                strict_eq6=strict_eq6), d_t)
    return float((d_t + (k - 1) * b) / k)


def migration_delay(prev: Optional[np.ndarray], place: np.ndarray,
                    blocks: Sequence[Block], cost: CostModel,
                    net: DeviceNetwork, tau: int) -> float:
    """Eq. (7): serialized migrations, block footprint at τ-1 (Eq. 2).

    With ``CostModel.page_size`` set (paged serving), the head-block
    footprint rounds the live token extent up to page granularity, so
    the priced migration bytes track allocated pages — the same unit
    the engine physically transfers — instead of the worst-case
    ``max_seq`` reservation."""
    if prev is None:
        return 0.0
    total = 0.0
    for bl in blocks:
        j, k = int(prev[bl.index]), int(place[bl.index])
        if j != k:
            total += cost.memory(bl, tau - 1) / _rate(net, j, k)
    return float(total)


def total_delay(prev: Optional[np.ndarray], place: np.ndarray,
                blocks: Sequence[Block], cost: CostModel,
                net: DeviceNetwork, tau: int, *,
                strict_eq6: bool = False) -> float:
    return inference_delay(place, blocks, cost, net, tau,
                           strict_eq6=strict_eq6) + \
        migration_delay(prev, place, blocks, cost, net, tau)


def pipelined_total_delay(prev: Optional[np.ndarray], place: np.ndarray,
                          blocks: Sequence[Block], cost: CostModel,
                          net: DeviceNetwork, tau: int, *, k: int = 1,
                          strict_eq6: bool = False) -> float:
    """D_pipe(k) + D_mig — the objective pipeline-aware policies/solvers
    optimize.  ``k=1`` is ``total_delay`` bit-for-bit."""
    return pipelined_inference_delay(place, blocks, cost, net, tau, k=k,
                                     strict_eq6=strict_eq6) + \
        migration_delay(prev, place, blocks, cost, net, tau)


def revert_unpaying_migrations(prev: Optional[np.ndarray],
                               place: np.ndarray, blocks: Sequence[Block],
                               cost: CostModel, net: DeviceNetwork,
                               tau: int, *, k: int = 1,
                               min_gain: float = 0.0) -> np.ndarray:
    """§III.G's migration filter, shared by the controller and
    ``ResourceAwarePolicy``: each migrated block is reverted to its
    previous device when keeping the move does not lower
    D_pipe(k) + D_mig by at least ``min_gain`` (k=1: D_T + D_mig).
    Reverts are only taken when memory-feasible, and NEVER back onto an
    inactive device — an evacuation off a dead device is mandatory, so
    the §III.G payback filter cannot undo it (the bypass is structural,
    not a flag)."""
    if prev is None:
        return place
    current = place.copy()
    cur_val = pipelined_total_delay(prev, current, blocks, cost, net, tau,
                                    k=k)
    for i in np.flatnonzero(current != prev):
        if not net.is_active(int(prev[i])):
            continue  # forced evacuation: reverting would re-kill the block
        trial = current.copy()
        trial[i] = prev[i]
        if not memory_feasible(trial, blocks, cost, net, tau):
            continue
        val = pipelined_total_delay(prev, trial, blocks, cost, net, tau,
                                    k=k)
        if val <= cur_val - min_gain:
            current, cur_val = trial, val
    return current


def memory_usage(place: np.ndarray, blocks: Sequence[Block],
                 cost: CostModel, net: DeviceNetwork, tau: int) -> np.ndarray:
    use = np.zeros(net.n_devices)
    for bl in blocks:
        use[place[bl.index]] += cost.memory(bl, tau)
    return use


def memory_feasible(place: np.ndarray, blocks: Sequence[Block],
                    cost: CostModel, net: DeviceNetwork, tau: int) -> bool:
    """Feasible against the *usable* memory view: observed availability,
    zero on inactive devices — so any placement still referencing a dead
    device is infeasible by construction."""
    return bool(np.all(memory_usage(place, blocks, cost, net, tau)
                       <= net.mem_usable() + 1e-9))
