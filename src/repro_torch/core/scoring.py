"""Scoring function S(i,j,τ) — paper §IV.A(a), generalized per-layer.

  S(i,j,τ) = max{ m_i(τ)/M_j(τ),  b_i(τ)/C_j(τ)·(1/T_budget),  CommFactor }

The paper leaves two scalings implicit; we make them explicit and testable:

 - the compute ratio b_i/C_j has units of seconds, while m_i/M_j is
   dimensionless.  A device is "individually feasible" when S <= 1, so the
   time-like terms are normalized by ``deadline`` — the wall-clock budget of
   one interval (the paper sizes intervals "on the order of a few seconds";
   default 5 s, exposed as a parameter and swept in the tests).

 - CommFactor(i,j,τ) "approximates data transfer times if i must exchange
   information with blocks on different devices".  On a per-layer block
   graph every counterpart is layer-local except the inter-layer edges:
   head(l,i) receives its input from ffn(l-1) (the controller for l=0) and
   sends to proj(l); proj(l) takes the max of inbound-head and
   outbound-ffn transfers; ffn(l) the max of the inbound transfer and the
   outbound ffn(l) → head(l+1,·) activation broadcast — all normalized by
   the same deadline.  Counterpart devices are read from the *previous*
   placement (the controller's best current knowledge).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.blocks import Block, CostModel, EXPERT, HEAD, PROJ, graph_of
from repro_torch.core.network import DeviceNetwork


def comm_factor(block: Block, j: int, blocks: Sequence[Block],
                prev_place: Optional[np.ndarray], cost: CostModel,
                net: DeviceNetwork, tau: int, deadline: float) -> float:
    def rate(a, b):
        return np.inf if a == b else float(net.bandwidth[a, b])

    g = graph_of(blocks)
    l = block.layer

    def dev(b: Block) -> int:
        """Counterpart device, -1 when unknown.  ``prev_place`` may be a
        partial view (entries -1): the assigner overlays its tentative
        in-round placement on the previous interval's — the controller's
        best current knowledge (§IV.A(a)) — so the first interval is not
        comm-blind for counterparts already placed this round."""
        if prev_place is None:
            return -1
        return int(prev_place[b.index])

    if block.kind == HEAD:
        t = 0.0
        if l == 0:
            t += cost.input_bytes(tau) / rate(net.controller, j)
        else:
            # inbound activation: the dense ffn, or the load-weighted
            # expert combine fan-in (sources with unknown devices skipped)
            for src_bl in g.out_blocks(l - 1):
                src = dev(src_bl)
                if src < 0:
                    continue
                fr = 1.0 if src_bl.kind != EXPERT \
                    else cost.expert_load(src_bl)
                t += fr * cost.interlayer_bytes(tau) / rate(src, j)
        proj_dev = dev(g.proj[l])
        if proj_dev >= 0:
            t += cost.head_to_proj_bytes(tau) / rate(j, proj_dev)
        return t / deadline
    if block.kind == PROJ:
        head_devs = set(d for d in (dev(h) for h in g.heads[l]) if d >= 0)
        t_in = cost.head_to_proj_bytes(tau) * cost.n_heads  # worst-case inbound
        t = 0.0
        if head_devs:
            t = t_in / min(rate(h_dev, j) for h_dev in head_devs)
        for out_bl in g.out_blocks(l):
            out_dev = dev(out_bl)
            if out_dev < 0:
                continue
            fr = 1.0 if out_bl.kind != EXPERT else cost.expert_load(out_bl)
            t = max(t, fr * cost.proj_to_ffn_bytes(tau) / rate(j, out_dev))
        return t / deadline
    if block.kind == EXPERT:
        # router fan-out in (load-fraction share of the proj activation),
        # combine out (same share of the next layer's activation broadcast)
        fr = cost.expert_load(block)
        t = 0.0
        proj_dev = dev(g.proj[l])
        if proj_dev >= 0:
            t = fr * cost.proj_to_ffn_bytes(tau) / rate(proj_dev, j)
        if l + 1 < g.n_layers:
            next_devs = [rate(j, d) for d in (dev(h) for h in g.heads[l + 1])
                         if d >= 0]
            if next_devs:
                t = max(t, fr * cost.interlayer_bytes(tau) / min(next_devs))
        return t / deadline
    # ffn: inbound from proj(l), outbound broadcast to layer l+1's heads
    t = 0.0
    proj_dev = dev(g.proj[l])
    if proj_dev >= 0:
        t = cost.proj_to_ffn_bytes(tau) / rate(proj_dev, j)
    if l + 1 < g.n_layers:
        next_devs = [rate(j, d) for d in (dev(h) for h in g.heads[l + 1])
                     if d >= 0]
        if next_devs:
            t = max(t, cost.interlayer_bytes(tau) / min(next_devs))
    return t / deadline


def score(block: Block, j: int, blocks: Sequence[Block],
          prev_place: Optional[np.ndarray], cost: CostModel,
          net: DeviceNetwork, tau: int, *, deadline: float = 5.0,
          mem_used: Optional[np.ndarray] = None,
          compute_used: Optional[np.ndarray] = None) -> float:
    """S(i,j,τ).  ``mem_used``/``compute_used`` optionally subtract already-
    assigned load on j (the per-block score in the paper is load-free; the
    algorithm's constraint check handles concurrency — §IV.A)."""
    if not net.is_active(j):
        # inactive device: no block may land here — enforced, not priced
        return np.inf
    mem_cap = net.mem_avail[j] - (0.0 if mem_used is None else mem_used[j])
    if mem_cap <= 0:
        return np.inf
    comp_avail = net.compute_avail[j]
    if comp_avail <= 0:
        return np.inf
    mem_term = cost.memory(block, tau) / mem_cap
    comp_term = (cost.compute(block, tau) +
                 (0.0 if compute_used is None else compute_used[j])) \
        / comp_avail / deadline
    cf = comm_factor(block, j, blocks, prev_place, cost, net, tau, deadline)
    return float(max(mem_term, comp_term, cf))


def score_matrix(blocks: Sequence[Block], prev_place: Optional[np.ndarray],
                 cost: CostModel, net: DeviceNetwork, tau: int,
                 *, deadline: float = 5.0) -> np.ndarray:
    """(|B|, |V|) matrix of S(i,j,τ)."""
    S = np.empty((len(blocks), net.n_devices))
    for bl in blocks:
        for j in range(net.n_devices):
            S[bl.index, j] = score(bl, j, blocks, prev_place, cost, net, tau,
                                   deadline=deadline)
    return S
