"""Block set B = H ∪ {ffn|experts, proj} and the Table-I resource model
(paper §III.C), extended with per-expert MoE blocks.

Memory m_i(τ) and compute b_i(τ) per block at interval τ, with λ=1 token per
interval so the sequence length is L_τ = L0 + τ.

Table I (d = D/h, b = bytes/param):
  head i : mem 3·L·d·b + 3·D·d·b            compute 3·L·D·d + L²·d
  cache  : mem τ·D·b (attached to its head)  —
  proj   : mem L·D·b                         compute L·D²
  ffn    : mem 4·L·D·b                       compute 8·L·D²

``cache_mode``:
  "paper"   — per-head cache τ·D·b exactly as printed (§III.C says m_i(τ)
              includes "the K/V cache of attention head i plus its params").
  "precise" — per-head K+V is 2·τ·d·b (beyond-paper studies).

``compute_mode``:
  "paper"       — full-sequence reprocessing per interval, as in Table I.
  "incremental" — KV-cache-reusing decode: one new token costs
                  3·D·d + 2·L·d MACs per head (the serving engine uses this).

``layer_mode`` — how a multi-layer decoder is lifted from Table I:
  "columns" — a *block* is the per-head column across all layers (the
              original aggregate lift): every per-block quantity scales by
              ``n_layers`` and the block list stays single-layer.  Head i of
              every layer is forced onto one device; inter-layer transfers
              are invisible.
  "graph"   — a true per-layer block graph: ``make_blocks(h, n_layers)``
              emits head(l,i)/proj(l)/ffn(l) blocks, each priced at its
              single-layer Table-I cost, with explicit inter-layer edges
              ffn(l) → head(l+1,·) carrying the full activation L·D·b
              (``interlayer_bytes``).  The paper notes the algorithm "can be
              applied independently to each layer" — this mode makes that
              literal: each layer's heads place independently.

``n_layers=1`` makes the two modes coincide with Table I exactly as printed.

Communication volumes (Eq. 3/4): W_{i→proj} = L·d·b, W_{proj→ffn} = L·D·b
("paper"); incremental mode sends only the new token's activations
(d·b and D·b).  The inter-layer edge carries the same volume as
W_{proj→ffn} — the full hidden state entering the next layer.

Expert blocks (``n_experts >= 2``) replace the monolithic ffn of a layer
with one block per (expert, replica slot):

  expert(l,e,r): mem  3·D·F·b   (weights only — no KV/sequence term, so
                                 Eq. 7 migration moves exactly the
                                 w_gate/w_up/w_down rows)
                 compute  load(l,e,r) · [today's ffn cost]
                 comm  in  load-fraction-scaled W_{proj→ffn} (router
                       fan-out), out load-fraction-scaled inter-layer
                       activation (combine)

``expert_loads`` is the router's observed token share per physical slot
(Σ over a layer's slots = 1; default: 1/E on each expert's first replica
slot, 0 on the rest).  With uniform loads and co-located experts the
per-device load fraction is exactly 1.0 (binary-exact for power-of-two
E), so the delay model prices the expert graph bit-for-bit equal to the
dense ffn graph — memory deliberately differs (expert weights 3·D·F·b
vs the paper's activation-coupled 4·L·D·b ffn term).

Replication is a first-class move: ``expert_replicas=r`` pre-provisions
r placeable slots per expert; activating a replica reassigns load across
the expert's slots (gates renormalise — Σ load per layer stays 1) and
the replica's weight bytes are paid on whatever device hosts it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

FFN = "ffn"
PROJ = "proj"
HEAD = "head"
EXPERT = "expert"

LAYER_MODES = ("columns", "graph")


@dataclasses.dataclass(frozen=True)
class Block:
    index: int           # position in the (layer-major) block list
    kind: str            # head | ffn | proj | expert
    head_id: int = -1    # for kind == head
    layer: int = 0       # decoder layer this block belongs to
    expert_id: int = -1  # logical expert (kind == expert)
    replica: int = 0     # replica slot of that expert (kind == expert)

    @property
    def name(self) -> str:
        if self.kind == HEAD:
            base = f"head{self.head_id}"
        elif self.kind == EXPERT:
            base = f"expert{self.expert_id}" if self.replica == 0 \
                else f"expert{self.expert_id}r{self.replica}"
        else:
            base = self.kind
        return base if self.layer == 0 else f"l{self.layer}:{base}"


def blocks_per_layer(n_heads: int, n_experts: int = 0,
                     expert_replicas: int = 1) -> int:
    ffn_like = n_experts * expert_replicas if n_experts >= 2 else 1
    return n_heads + 1 + ffn_like


def make_blocks(n_heads: int, n_layers: int = 1, n_experts: int = 0,
                expert_replicas: int = 1) -> List[Block]:
    """Layer-major block list: layer l holds heads 0..h-1, proj(l), then
    either ffn(l) or — when ``n_experts >= 2`` — expert(l,e,r) blocks in
    (expert, replica) order.

    ``n_layers=1`` (the default) reproduces the original single-layer list
    bit-for-bit, and ``n_experts`` of 0 or 1 emits the identical dense
    list — a 1-expert MoE *is* an ffn as far as placement is concerned.
    """
    blocks: List[Block] = []
    per = blocks_per_layer(n_heads, n_experts, expert_replicas)
    for l in range(n_layers):
        base = l * per
        for i in range(n_heads):
            blocks.append(Block(base + i, HEAD, head_id=i, layer=l))
        blocks.append(Block(base + n_heads, PROJ, layer=l))
        if n_experts >= 2:
            p = base + n_heads + 1
            for e in range(n_experts):
                for r in range(expert_replicas):
                    blocks.append(Block(p, EXPERT, layer=l,
                                        expert_id=e, replica=r))
                    p += 1
        else:
            blocks.append(Block(base + n_heads + 1, FFN, layer=l))
    return blocks


def expert_slot(block: Block, expert_replicas: int) -> int:
    """Physical expert-slot index of an expert block within its layer
    ((expert, replica)-major — the row order ``expert_loads`` and the
    engine's expert permutations use)."""
    return block.expert_id * expert_replicas + block.replica


class BlockGraph:
    """Layer-indexed view of a block list plus the inter-layer edges.

    ``edges`` lists the explicit ffn(l) → head(l+1, i) activation edges the
    per-layer delay/scoring models price (volume:
    ``CostModel.interlayer_bytes``).
    """

    def __init__(self, blocks: Sequence[Block]):
        # keep the caller's list object when possible: graph_of's cache is
        # keyed by id(list) and guarded by `g.blocks is blocks`
        if not isinstance(blocks, list):
            blocks = list(blocks)
        self.blocks = blocks
        self.n_layers = max(b.layer for b in blocks) + 1
        self.heads: List[List[Block]] = [[] for _ in range(self.n_layers)]
        self.experts: List[List[Block]] = [[] for _ in range(self.n_layers)]
        self.proj: List[Block] = [None] * self.n_layers  # type: ignore
        self.ffn: List[Block] = [None] * self.n_layers   # type: ignore
        for b in blocks:
            if b.kind == HEAD:
                self.heads[b.layer].append(b)
            elif b.kind == EXPERT:
                self.experts[b.layer].append(b)
            elif b.kind == PROJ:
                if self.proj[b.layer] is not None:
                    raise ValueError(f"duplicate proj in layer {b.layer}")
                self.proj[b.layer] = b
            else:
                if self.ffn[b.layer] is not None:
                    raise ValueError(f"duplicate ffn in layer {b.layer}")
                self.ffn[b.layer] = b
        for l in range(self.n_layers):
            if not self.heads[l] or self.proj[l] is None:
                raise ValueError(f"layer {l} is missing blocks")
            if (self.ffn[l] is None) == (not self.experts[l]):
                raise ValueError(f"layer {l} needs exactly one of ffn / "
                                 f"expert blocks")

    def layer_blocks(self, l: int) -> List[Block]:
        if self.ffn[l] is not None:
            return self.heads[l] + [self.proj[l], self.ffn[l]]
        return self.heads[l] + [self.proj[l]] + self.experts[l]

    def out_blocks(self, l: int) -> List[Block]:
        """The blocks producing layer l's output hidden state: the dense
        ffn, or the expert set whose weighted combine feeds layer l+1."""
        return [self.ffn[l]] if self.ffn[l] is not None else self.experts[l]

    @property
    def edges(self):
        """Inter-layer activation edges (ffn|expert(l), head(l+1, i))."""
        return [(src, h)
                for l in range(self.n_layers - 1)
                for src in self.out_blocks(l)
                for h in self.heads[l + 1]]

    def stage_partition(self, place) -> List[tuple]:
        """Pipeline-stage view of a placement: maximal contiguous layer
        runs greedily merged while their device sets intersect.  Adjacent
        stages use disjoint device sets, so tokens in consecutive stages
        can execute concurrently — the in-flight structure
        ``pipelined_inference_delay`` prices (non-adjacent stages may still
        share devices; the delay model's resource busy times, not this
        view, bound the achievable overlap).

        Returns ``[(frozenset devices, (layer, ...)), ...]`` in layer
        order; ``len()`` is the natural micro-batch depth of the placement.
        """
        stages: List[tuple] = []
        for l in range(self.n_layers):
            devs = {int(place[b.index]) for b in self.layer_blocks(l)}
            if stages and (stages[-1][0] & devs):
                stages[-1][0].update(devs)
                stages[-1][1].append(l)
            else:
                stages.append((set(devs), [l]))
        return [(frozenset(d), tuple(ls)) for d, ls in stages]


def stage_partition(place, blocks: Sequence[Block]) -> List[tuple]:
    """Module-level convenience: ``graph_of(blocks).stage_partition``."""
    return graph_of(blocks).stage_partition(place)


# Keyed by (id, len) with a strong reference to the list held in the value:
# while an entry lives, its list's id cannot be reused, so the key cannot
# alias a different list.  Bounded: cleared wholesale if it ever grows past
# a size no realistic process reaches organically.
_GRAPH_CACHE: dict = {}


def graph_of(blocks: Sequence[Block]) -> BlockGraph:
    blocks = blocks if isinstance(blocks, list) else list(blocks)
    key = (id(blocks), len(blocks))
    g = _GRAPH_CACHE.get(key)
    if g is not None and g.blocks is blocks:
        return g
    g = BlockGraph(blocks)
    if len(_GRAPH_CACHE) > 256:
        _GRAPH_CACHE.clear()
    _GRAPH_CACHE[key] = g
    return g


def replicate_placement(col_place, blocks: Sequence[Block]):
    """Lift a single-layer (column) placement onto a per-layer block list:
    head(l,i) ← col_place[head i], proj(l)/ffn(l) ← col_place[proj/ffn].

    This is exactly what ``layer_mode="columns"`` forces implicitly — the
    explicit form lets column co-partitioning be evaluated (and beaten)
    under the per-layer delay model."""
    import numpy as np
    g = graph_of(blocks)
    col = np.asarray(col_place, dtype=int)
    out = np.empty(len(g.blocks), dtype=int)
    n_heads = len(g.heads[0])
    for l in range(g.n_layers):
        for h in g.heads[l]:
            out[h.index] = col[h.head_id]
        out[g.proj[l].index] = col[n_heads]
        if g.ffn[l] is not None:
            out[g.ffn[l].index] = col[n_heads + 1]
        else:
            # expert layers: a dense column (h+2 slots) broadcasts its ffn
            # slot to every expert; an expert-aware column maps by position
            for j, e in enumerate(g.experts[l]):
                src = n_heads + 1 if len(col) == n_heads + 2 \
                    else n_heads + 1 + j
                out[e.index] = col[src]
    return out


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Table-I resource usage for an ``n_layers``-deep decoder.

    ``layer_mode="columns"`` is the original aggregate lift (§V.B, the
    paper's "GPT-2/LLaMA scale" evaluation): a *block* is the per-head
    column across all layers, so memory/compute/communication volumes all
    scale by ``n_layers`` and the block list stays single-layer.

    ``layer_mode="graph"`` prices each block at its single-layer Table-I
    cost; the multi-layer structure lives in the block list
    (``make_blocks(h, n_layers)``) and the per-layer delay model instead.

    ``n_layers=1`` makes both modes Table I exactly as printed.
    """

    d_model: int                 # D
    n_heads: int                 # h
    bytes_per_param: int = 2     # b
    L0: int = 64                 # prompt length
    lam: int = 1                 # λ tokens per interval
    n_layers: int = 1
    cache_mode: str = "paper"
    compute_mode: str = "paper"
    flops_per_mac: int = 2       # Table I counts MACs; FLOPs = 2x
    layer_mode: str = "columns"
    # page-granular KV (serving engines with a paged cache): the cache
    # term of a head block is rounded UP to whole pages, so migration/
    # memory pricing matches what the engine actually allocates and
    # moves — live pages, not a dense max_seq reservation.  0 = dense.
    page_size: int = 0
    # --- MoE: per-expert blocks instead of a monolithic ffn ---------------
    # n_experts >= 2 makes make_blocks emit expert(l,e,r) blocks; d_ff is
    # the expert hidden width F (0 -> the dense 4·D) used for the
    # weight-only memory/migration term; expert_loads is the observed
    # router token share per (layer, physical slot) — a tuple of n_layers
    # tuples of length n_experts·expert_replicas summing to 1 per layer
    # (() = uniform: 1/E on each expert's first replica slot).
    n_experts: int = 0
    expert_replicas: int = 1
    d_ff: int = 0
    expert_loads: tuple = ()

    def __post_init__(self):
        if self.layer_mode not in LAYER_MODES:
            raise ValueError(f"layer_mode must be one of {LAYER_MODES}, "
                             f"got {self.layer_mode!r}")
        if self.expert_loads:
            want = self.n_experts * self.expert_replicas
            for row in self.expert_loads:
                if len(row) != want:
                    raise ValueError(
                        f"expert_loads rows must have n_experts·"
                        f"expert_replicas = {want} entries, got {len(row)}")

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def expert_dim(self) -> int:
        """Expert hidden width F (falls back to the dense 4·D)."""
        return self.d_ff if self.d_ff > 0 else 4 * self.d_model

    @property
    def expert_slots(self) -> int:
        """Physical expert slots per layer (logical experts × replicas)."""
        return self.n_experts * self.expert_replicas

    def expert_load(self, block: Block) -> float:
        """Observed router token share of one expert block's slot.

        Defaults to uniform 1/E on each expert's first replica slot (so a
        freshly built model with no observations prices exactly like the
        dense ffn split E ways); replica slots beyond the first carry no
        load until the controller activates them."""
        if not self.expert_loads:
            return 1.0 / self.n_experts if block.replica == 0 else 0.0
        row = self.expert_loads[min(block.layer,
                                    len(self.expert_loads) - 1)]
        return float(row[expert_slot(block, self.expert_replicas)])

    def with_expert_loads(self, loads) -> "CostModel":
        """A copy of this model pricing the given per-(layer, slot) router
        loads (any nested sequence; stored as hashable tuples)."""
        t = tuple(tuple(float(x) for x in row) for row in loads)
        return dataclasses.replace(self, expert_loads=t)

    @property
    def _scale(self) -> int:
        """Per-block multiplier: columns aggregate all layers into each
        block; graph blocks are single-layer."""
        return 1 if self.layer_mode == "graph" else self.n_layers

    def seq_len(self, tau: int) -> int:
        return self.L0 + self.lam * tau

    def make_blocks(self) -> List[Block]:
        """The block list this cost model prices: per-layer in graph mode,
        the single-layer column list otherwise."""
        return make_blocks(self.n_heads,
                           self.n_layers if self.layer_mode == "graph" else 1,
                           self.n_experts, self.expert_replicas)

    # ----------------------------------------------------------- memory
    def memory(self, block: Block, tau: int) -> float:
        D, d, b = self.d_model, self.d_head, self.bytes_per_param
        L = self.seq_len(tau)
        if block.kind == HEAD:
            base = 3 * L * d * b + 3 * D * d * b
            t = tau if self.page_size <= 0 \
                else -(-tau // self.page_size) * self.page_size
            if self.cache_mode == "paper":
                cache = t * D * b
            else:
                cache = 2 * t * d * b
            return float(self._scale * (base + cache))
        if block.kind == PROJ:
            return float(self._scale * L * D * b)
        if block.kind == EXPERT:
            # weight-only (w_gate/w_up/w_down rows): no KV/sequence term,
            # so Eq. 7 migration of an expert moves exactly its 3·D·F·b
            return float(self._scale * 3 * D * self.expert_dim * b)
        return float(self._scale * 4 * L * D * b)  # ffn

    # ----------------------------------------------------------- compute
    def compute(self, block: Block, tau: int) -> float:
        D, d = self.d_model, self.d_head
        L = self.seq_len(tau)
        f = self.flops_per_mac * self._scale
        if self.compute_mode == "paper":
            if block.kind == HEAD:
                return float(f * (3 * L * D * d + L * L * d))
            if block.kind == PROJ:
                return float(f * (L * D * D))
            if block.kind == EXPERT:
                # today's ffn cost × the slot's observed token share:
                # uniform load splits the dense 8·L·D² exactly E ways
                return float(f * (8 * L * D * D) * self.expert_load(block))
            return float(f * (8 * L * D * D))
        # incremental: only the λ new tokens are processed
        n = self.lam
        if block.kind == HEAD:
            return float(f * n * (3 * D * d + 2 * L * d))
        if block.kind == PROJ:
            return float(f * n * (D * D))
        if block.kind == EXPERT:
            return float(f * n * (8 * D * D) * self.expert_load(block))
        return float(f * n * (8 * D * D))

    # ------------------------------------------------------ communication
    def head_to_proj_bytes(self, tau: int) -> float:
        d, b = self.d_head, self.bytes_per_param
        L = self.seq_len(tau)
        n = L if self.compute_mode == "paper" else self.lam
        return float(self._scale * n * d * b)

    def proj_to_ffn_bytes(self, tau: int) -> float:
        D, b = self.d_model, self.bytes_per_param
        L = self.seq_len(tau)
        n = L if self.compute_mode == "paper" else self.lam
        return float(self._scale * n * D * b)

    def interlayer_bytes(self, tau: int) -> float:
        """Volume of one ffn(l) → head(l+1,·) edge: the full hidden state
        entering the next layer (L·D·b; incremental mode sends only the λ
        new tokens' activations).  Per-edge — never scaled by n_layers."""
        D, b = self.d_model, self.bytes_per_param
        n = self.seq_len(tau) if self.compute_mode == "paper" else self.lam
        return float(n * D * b)

    def input_bytes(self, tau: int) -> float:
        """Controller -> head-device token embeddings."""
        D, b = self.d_model, self.bytes_per_param
        n = self.seq_len(tau) if self.compute_mode == "paper" else self.lam
        return float(n * D * b)

    # vectors over the standard block list -----------------------------------
    def memory_vector(self, blocks: Sequence[Block], tau: int):
        import numpy as np
        return np.array([self.memory(bl, tau) for bl in blocks])

    def compute_vector(self, blocks: Sequence[Block], tau: int):
        import numpy as np
        return np.array([self.compute(bl, tau) for bl in blocks])


def uniform_expert_loads(n_layers: int, n_experts: int,
                         expert_replicas: int = 1) -> tuple:
    """The default load tensor made explicit: 1/E on each expert's first
    replica slot, 0 on the rest."""
    row = []
    for _ in range(n_experts):
        row.append(1.0 / n_experts)
        row.extend(0.0 for _ in range(expert_replicas - 1))
    return tuple(tuple(row) for _ in range(n_layers))


def replicate_hot_expert(cost: "CostModel", layer: int = None) -> "CostModel":
    """Hot-expert replication as a cost-model move: split the argmax-load
    slot's token share in half onto an idle replica slot of the same
    expert (gates renormalise across replicas, so Σ load per layer is
    unchanged — 0.5· is exact in binary fp).  Layers with no idle replica
    slot for their hot expert are left as they are; ``layer`` restricts
    the move to one layer.  Returns a new CostModel (no-op if
    ``expert_replicas == 1``)."""
    if cost.n_experts < 2 or cost.expert_replicas < 2:
        return cost
    loads = cost.expert_loads or uniform_expert_loads(
        cost.n_layers, cost.n_experts, cost.expert_replicas)
    R = cost.expert_replicas
    new_rows = []
    for l, row in enumerate(loads):
        row = list(row)
        if layer is None or layer == l:
            hot = max(range(len(row)), key=lambda p: row[p])
            e = hot // R
            idle = [e * R + r for r in range(R)
                    if row[e * R + r] == 0.0]
            if idle:
                half = row[hot] * 0.5
                row[hot] = half
                row[idle[0]] = half
        new_rows.append(tuple(row))
    return cost.with_expert_loads(new_rows)
