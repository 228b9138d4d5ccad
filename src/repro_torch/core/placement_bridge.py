"""Placement bridge: Algorithm 1's block→device assignment realized as
head permutations of the stacked weights and KV cache, and as expert-row
permutations of the stacked MoE weights.

An arbitrary head→slot assignment is a permutation of the head axis: slot
s holds heads ``perm[s*Hp/n : (s+1)*Hp/n]``.  Placement changes are
permutation changes; applying the relative permutation to the KV cache and
the attention weights *is* the paper's migration.

The numpy half is a copy of the JAX package's ``core/placement_bridge.py``
(same names, same results); the torch half applies the permutations to
tensors with ``index_select`` on the head axis.  The layouts match the
JAX package's, so a migration is the same row permutation in both.

The placements on a ``DeviceMesh`` (``param_spec``, ``param_shardings``,
``batch_shardings``, ``decode_state_shardings``) are the reference's
path-keyed rules: a spec is the reference's ``PartitionSpec`` entries as a
tuple, and a tree of ``partitioning.Sharding`` (mesh and one placement per
mesh dimension) takes the place of its ``NamedSharding`` trees.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import Block, HEAD, expert_slot, graph_of
from repro_torch.models.partitioning import (Sharding, Spec, is_dtensor,
                                             placements, tp_degree)
from repro_torch.tree import map_with_path


# ---------------------------------------------------------------------------
# Algorithm-1 placement -> head permutation (one per layer)
# ---------------------------------------------------------------------------


def placement_to_perm(place: np.ndarray, blocks: Sequence[Block],
                      n_slots: int, heads_per_slot: int,
                      group_size: int = 1) -> np.ndarray:
    """Maps a block placement (head i -> device j) onto a head permutation.

    Head-blocks assigned to slot j occupy that slot's contiguous positions.
    If the assignment is unbalanced (more heads on a device than
    heads_per_slot — legal at the edge, not under SPMD) the overflow spills
    to the next slots round-robin; the spill count is reported so the
    controller can price it as extra migrations.

    ``group_size`` > 1 (GQA: ``group_size = Hp // KvE`` query heads share
    each KV head) makes the permutation *group-consistent*: whole KV groups
    are the migration unit — every block of ``group_size`` output positions
    holds one complete group in canonical within-group order, so the
    induced KV permutation (``kv_group_perms``) is well defined and grouped
    caches/weights physically move with their query heads.  A group whose
    heads Algorithm 1 scattered over several devices is snapped to the
    majority device (ties to the lowest device id); when ``group_size``
    exceeds ``heads_per_slot`` a group spans adjacent slots — the
    co-holding models KV replication across those slots.
    """
    if group_size > 1:
        return _placement_to_group_perm(place, blocks, n_slots,
                                        heads_per_slot, group_size)
    head_ids = [b.head_id for b in blocks if b.kind == HEAD]
    n_heads = len(head_ids)
    assert n_slots * heads_per_slot >= n_heads
    buckets: List[List[int]] = [[] for _ in range(n_slots)]
    spilled: List[int] = []
    for b in blocks:
        if b.kind != HEAD:
            continue
        j = int(place[b.index]) % n_slots
        if len(buckets[j]) < heads_per_slot:
            buckets[j].append(b.head_id)
        else:
            spilled.append(b.head_id)
    for h in spilled:
        j = int(np.argmin([len(bk) for bk in buckets]))
        buckets[j].append(h)
    perm = []
    for bk in buckets:
        perm.extend(bk)
        perm.extend([-1] * (heads_per_slot - len(bk)))  # padded positions
    # fill padding with the unused (padded) head ids
    unused = [h for h in range(n_slots * heads_per_slot) if h not in perm]
    out = np.array(perm)
    out[out == -1] = unused
    return out


def _placement_to_group_perm(place: np.ndarray, blocks: Sequence[Block],
                             n_slots: int, heads_per_slot: int,
                             group_size: int) -> np.ndarray:
    """Group-granular variant of ``placement_to_perm`` (see its docstring):
    assigns whole KV groups to slots by majority vote over their heads'
    placements and emits the head permutation that moves groups as units.

    Permutation positions keep their slot meaning (slot s = positions
    [s·hps, (s+1)·hps)): each block of ``group_size`` contiguous positions
    has a *primary slot* and every group takes the free block nearest its
    majority slot — so a group physically relocating between slots changes
    the permutation (and therefore produces migration pairs) even when the
    slot *order* of the groups is unchanged."""
    positions = n_slots * heads_per_slot
    if positions % group_size:
        raise ValueError(f"{positions} head positions not divisible by "
                         f"KV group size {group_size}")
    heads = [b for b in blocks if b.kind == HEAD]
    n_heads = len(heads)
    if n_heads % group_size:
        raise ValueError(f"{n_heads} heads not divisible by KV group "
                         f"size {group_size}")
    assert positions >= n_heads
    dev_of = {b.head_id: int(place[b.index]) % n_slots for b in heads}
    n_groups = n_heads // group_size
    total_blocks = positions // group_size
    # position-block p covers perm positions [p·G, (p+1)·G); its primary
    # slot is the one holding the block's first position
    primary = [(p * group_size) // heads_per_slot
               for p in range(total_blocks)]
    free = list(range(total_blocks))
    order = np.full(total_blocks, -1, dtype=int)
    for g in range(n_groups):
        votes = np.bincount([dev_of[g * group_size + i]
                             for i in range(group_size)],
                            minlength=n_slots)
        pref = int(np.argmax(votes))       # majority, ties -> lowest slot
        p = min(free, key=lambda p: (abs(primary[p] - pref), p))
        order[p] = g
        free.remove(p)
    # padded group ids (beyond the real heads) fill the remaining blocks
    for g, p in zip(range(n_groups, total_blocks), free):
        order[p] = g
    out = np.empty(positions, dtype=int)
    for p, g in enumerate(order):
        out[p * group_size:(p + 1) * group_size] = \
            g * group_size + np.arange(group_size)
    return out


def placement_to_perms(place: np.ndarray, blocks: Sequence[Block],
                       n_slots: int, heads_per_slot: int,
                       group_size: int = 1) -> np.ndarray:
    """Per-layer head permutations for a (possibly multi-layer) block
    graph: row l is ``placement_to_perm`` applied to layer l's blocks.
    Shape (n_layers, n_slots·heads_per_slot); a single-layer list yields
    one row, identical to ``placement_to_perm``.  ``group_size`` > 1 makes
    every row group-consistent (GQA migrates whole KV groups)."""
    g = graph_of(blocks)
    return np.stack([placement_to_perm(place, g.layer_blocks(l),
                                       n_slots, heads_per_slot, group_size)
                     for l in range(g.n_layers)])


def placement_to_expert_perms(place: np.ndarray, blocks: Sequence[Block],
                              n_slots: int, experts_per_slot: int,
                              expert_replicas: int = 1) -> np.ndarray:
    """Per-layer *expert-slot* permutations — the expert analog of
    ``placement_to_perms``.  Row l maps permutation position p (mesh slot
    ``p // experts_per_slot``) to the physical expert-row id
    (``blocks.expert_slot``: expert_id·R + replica) Algorithm 1 placed
    there; overflow beyond a slot's capacity spills round-robin exactly
    like head spill.  Shape (n_layers, n_slots·experts_per_slot), which
    must equal the number of physical expert rows (raises otherwise)."""
    g = graph_of(blocks)
    positions = n_slots * experts_per_slot
    rows = []
    for l in range(g.n_layers):
        ebs = g.experts[l]
        if positions != len(ebs):
            raise ValueError(f"{n_slots} slots x {experts_per_slot} experts "
                             f"per slot != {len(ebs)} expert rows")
        buckets: List[List[int]] = [[] for _ in range(n_slots)]
        spilled: List[int] = []
        for b in ebs:
            j = int(place[b.index]) % n_slots
            sid = expert_slot(b, expert_replicas)
            if len(buckets[j]) < experts_per_slot:
                buckets[j].append(sid)
            else:
                spilled.append(sid)
        for sid in spilled:
            j = int(np.argmin([len(bk) for bk in buckets]))
            buckets[j].append(sid)
        perm: List[int] = []
        for bk in buckets:
            perm.extend(bk)
        rows.append(np.array(perm))
    return np.stack(rows)


def kv_group_perms(perms: np.ndarray, group_size: int) -> np.ndarray:
    """The KV-head permutation stack induced by group-consistent query-head
    permutations: kv position p of row l holds old kv head
    ``perms[l, p·G] // G``.  Shape (L, H/G).  Raises ``ValueError`` when a
    block of ``group_size`` positions mixes heads from different KV groups
    — the permutation then has no grouped-cache realization and applying it
    would silently corrupt GQA attention."""
    perms = np.atleast_2d(np.asarray(perms))
    if group_size <= 1:
        return perms
    L, H = perms.shape
    if H % group_size:
        raise ValueError(f"perm width {H} not divisible by group size "
                         f"{group_size}")
    grouped = perms.reshape(L, H // group_size, group_size) // group_size
    if not (grouped == grouped[:, :, :1]).all():
        raise ValueError("head permutation is not KV-group-consistent: "
                         "a block of positions mixes heads from different "
                         "KV groups (emit perms via placement_to_perms("
                         "group_size=...) for grouped-KV archs)")
    out = grouped[:, :, 0]
    for l in range(L):
        if sorted(out[l].tolist()) != list(range(H // group_size)):
            raise ValueError(f"induced KV permutation of layer {l} is not "
                             f"a permutation: {out[l]}")
    return out


def expand_kv_perms(kv_perms: np.ndarray, rep: int) -> np.ndarray:
    """Expanded-KV (replicated) row permutation induced by a KV-head
    permutation: caches of ``rep``-replicated archs (``HeadDims.rep`` > 1,
    tp > n_kv_heads) store ``KvE = Kp·rep`` rows where expanded row
    ``o·rep + r`` is replica r of KV head o.  Replicas are exact copies,
    so a KV-head permutation lifts to the expanded layout by moving each
    head's whole replica block: new expanded row ``o·rep + r`` holds old
    expanded row ``kv_perms[.., o]·rep + r``.  Shape (L, Kp) -> (L, KvE);
    ``rep=1`` is the identity lift."""
    kv = np.atleast_2d(np.asarray(kv_perms))
    if rep <= 1:
        return kv
    out = kv[:, :, None] * rep + np.arange(rep)
    return out.reshape(kv.shape[0], -1)


def placement_to_head_slices(place: np.ndarray, blocks: Sequence[Block],
                             n_slots: int, layer: Optional[int] = None):
    """Per-(layer, slot) resident head rows of a BlockGraph placement — the
    gather maps the resident-slice decode kernel consumes
    (``kernels.decode_attention.decode_attention_resident``).

    Returns ``[layer][slot] -> np.ndarray`` of sorted logical head ids the
    placement puts on that slot (``layer=l`` selects one layer's list).
    The per-slot arrays are RAGGED — per-layer head counts per device are
    not uniform under the per-layer block graph — and their union over
    slots is exactly layer l's head set: every head's attention runs
    exactly once, on the device that hosts it.  This is the same placement
    the cost model prices and ``placement_to_perms`` snaps onto the SPMD
    mesh, so kernel dispatch, pricing, and migration all read one source
    of truth.  Devices fold onto slots modulo ``n_slots`` — the same
    deliberate device→slot folding every bridge function uses (a network
    larger than the engine's slot count is the normal serve-CLI case);
    keep them in lockstep or the maps stop describing the applied
    permutations."""
    g = graph_of(blocks)
    out = []
    for l in range(g.n_layers):
        buckets: List[List[int]] = [[] for _ in range(n_slots)]
        for b in g.heads[l]:
            buckets[int(place[b.index]) % n_slots].append(b.head_id)
        out.append([np.array(sorted(bk), dtype=np.int32) for bk in buckets])
    return out if layer is None else out[layer]


def head_row_maps(place: np.ndarray, blocks: Sequence[Block], n_slots: int,
                  total_rows: int, perms: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked kernel gather maps for a full-model decode step.

    Row l of the returned ``rows`` (n_layers, total_rows) array lists the
    PHYSICAL q-head rows of layer l in slot-grouped placement order: the
    concatenation over slots of each slot's resident slice
    (``placement_to_head_slices``), padded q-head rows (logical ids ≥ the
    placed head count) appended at the tail.  ``perms`` — the physical
    layout actually applied to weights/caches (position p holds logical
    head ``perms[l, p]``) — maps logical ids to physical positions; omit
    it while the layout is still the identity.  Also returns ``inv``
    (n_layers, total_rows), the scatter map with ``rows[l][inv[l]] ==
    arange``: gathering the kernel's compacted output by ``inv[l]``
    restores physical q order for the wo projection.

    A single-slot dispatch uses one slice of ``placement_to_head_slices``
    directly; this stacked form is the single-host (and per-layer-scan)
    emulation — the union of every slot's resident dispatch."""
    slices = placement_to_head_slices(place, blocks, n_slots)
    n_layers = len(slices)
    rows = np.empty((n_layers, total_rows), dtype=np.int32)
    inv = np.empty_like(rows)
    for l, per_slot in enumerate(slices):
        logical = np.concatenate([s for s in per_slot] or
                                 [np.empty(0, np.int32)])
        n_placed = logical.shape[0]
        if n_placed > total_rows:
            raise ValueError(f"layer {l} places {n_placed} heads but the "
                             f"model has only {total_rows} head rows")
        pad = np.setdiff1d(np.arange(total_rows, dtype=np.int32), logical)
        logical = np.concatenate([logical, pad])
        if perms is not None:
            pstack = np.atleast_2d(np.asarray(perms))
            p = pstack[0] if pstack.shape[0] == 1 else pstack[l]
            if p.shape[0] != total_rows:
                raise ValueError(f"perm width {p.shape[0]} != head rows "
                                 f"{total_rows}")
            inv_perm = np.empty(total_rows, dtype=np.int32)
            inv_perm[np.asarray(p, dtype=int)] = np.arange(total_rows)
            rows[l] = inv_perm[logical]
        else:
            rows[l] = logical
        inv[l] = np.argsort(rows[l])
    return rows, inv


def identity_head_rows(n_layers: int, total_rows: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The trivial gather maps (physical == logical == dense grid): what a
    kernelized decode runs before any controller plan exists."""
    rows = np.broadcast_to(np.arange(total_rows, dtype=np.int32),
                           (n_layers, total_rows)).copy()
    return rows, rows.copy()


def migration_pairs(old_perm: np.ndarray, new_perm: np.ndarray,
                    heads_per_slot: int) -> List[Tuple[int, int, int]]:
    """(head, src_slot, dst_slot) for every head whose slot changes."""
    slot_of_old = {h: i // heads_per_slot for i, h in enumerate(old_perm)}
    out = []
    for i, h in enumerate(new_perm):
        src, dst = slot_of_old[int(h)], i // heads_per_slot
        if src != dst:
            out.append((int(h), src, dst))
    return out


def migration_pairs_layers(old_perms: np.ndarray, new_perms: np.ndarray,
                           heads_per_slot: int
                           ) -> List[Tuple[int, int, int, int]]:
    """(layer, head, src_slot, dst_slot) over all layers' permutations."""
    out: List[Tuple[int, int, int, int]] = []
    for l, (op, np_) in enumerate(zip(old_perms, new_perms)):
        out.extend((l, h, s, d)
                   for h, s, d in migration_pairs(op, np_, heads_per_slot))
    return out


def relative_perms(prev_perms: np.ndarray, new_perms: np.ndarray
                   ) -> np.ndarray:
    """Per-layer relative permutations: row l maps the *current* physical
    layout (prev_perms[l]) onto the new one — ``take``-ing a cache/weight
    head axis by row l realizes layer l's migration.  Accepts (L, H) stacks
    or single (H,) permutations (returned as shape (1, H))."""
    prev_perms = np.atleast_2d(np.asarray(prev_perms))
    new_perms = np.atleast_2d(np.asarray(new_perms))
    if prev_perms.shape[0] == 1 and new_perms.shape[0] > 1:
        # one physical layout shared by all layers
        prev_perms = np.broadcast_to(prev_perms, new_perms.shape)
    if prev_perms.shape != new_perms.shape:
        raise ValueError(f"perm stacks disagree: {prev_perms.shape} vs "
                         f"{new_perms.shape}")
    out = np.empty_like(new_perms)
    for l, (pp, np_) in enumerate(zip(prev_perms, new_perms)):
        old_pos = {int(h): i for i, h in enumerate(pp)}
        out[l] = [old_pos[int(h)] for h in np_]
    return out


def migration_bytes(pairs: Sequence[Tuple[int, int, int]],
                    bytes_per_head: float) -> float:
    return float(len(pairs) * bytes_per_head)


def stage_slot_partition(place, blocks: Sequence[Block],
                         n_slots: int) -> List[tuple]:
    """Mesh-slot view of ``BlockGraph.stage_partition``: contiguous layer
    stages whose *slot* sets (device % n_slots) are adjacent-disjoint.
    ``len()`` bounds the micro-batch depth K a serving engine can usefully
    keep in flight on this placement — stage s+1's slots are free to start
    the next token while stage s finishes the previous one."""
    g = graph_of(blocks)
    slot_place = np.asarray(place, dtype=int) % n_slots
    return [(frozenset(devs), layer_ids)
            for devs, layer_ids in g.stage_partition(slot_place)]


# ---------------------------------------------------------------------------
# Applying permutations to tensors
# ---------------------------------------------------------------------------


def _kv_perms(perms: np.ndarray, group_size: int, rep: int = 1) -> np.ndarray:
    """Query-head permutations (any leading axes, heads last) -> the KV-row
    permutations that move each grouped (and ``rep``-replicated) KV head
    with its query heads, with the same leading axes."""
    perms = np.atleast_2d(np.asarray(perms))
    if group_size <= 1:
        return perms
    flat = expand_kv_perms(kv_group_perms(
        perms.reshape(-1, perms.shape[-1]), group_size), rep)
    return flat.reshape(perms.shape[:-1] + (flat.shape[-1],))


def _take_layers(w: torch.Tensor, axis: int, rows: np.ndarray,
                 sent: Optional[dict] = None) -> torch.Tensor:
    """Cell c of ``rows``' leading axes reorders axis ``axis`` of the
    layer slice ``w[c]``: rows (L, H) for a (L, ...) stack, (G, 4, H) for
    the VLM's (G, 4, ...) one (the layer axes lead).  A plain tensor comes
    back as a new one; a DTensor is permuted in place
    (``_permute_layers_``, which counts what it sends into ``sent``) and
    returned."""
    if is_dtensor(w):
        return _permute_layers_(w, axis, rows, sent)
    axis = axis % w.ndim
    n_lead = rows.ndim - 1
    if axis < n_lead:
        raise ValueError("the head axis cannot be a leading layer axis")
    if tuple(rows.shape[:-1]) != tuple(w.shape[:n_lead]):
        raise ValueError(f"{rows.shape[:-1]} permutation rows for "
                         f"{tuple(w.shape[:n_lead])} stacked layers")
    idx = torch.as_tensor(rows.reshape(-1, rows.shape[-1]),
                          dtype=torch.long, device=w.device)
    flat = w.reshape((-1,) + w.shape[n_lead:])
    return torch.stack([flat[l].index_select(axis - n_lead, idx[l])
                        for l in range(flat.shape[0])]).reshape(w.shape)


def apply_head_perm(cache_k, cache_v, perm, head_axis: int = 3,
                    group_size: int = 1, rep: int = 1):
    """Reorder the head axis of a stacked cache ((L, B, T, KvE, dh) by
    default) by ONE permutation, the same for every layer.  ``group_size``
    > 1: ``perm`` is a (group-consistent) query-head permutation and the
    cache's head axis holds one KV head per group, so the induced KV
    permutation is applied (lifted to ``rep`` replicated rows).  Returns
    new tensors; the inputs are not modified."""
    kv = _kv_perms(perm, group_size, rep)[0]
    idx = torch.as_tensor(kv, dtype=torch.long, device=cache_k.device)
    axis = head_axis % cache_k.ndim
    return cache_k.index_select(axis, idx), cache_v.index_select(axis, idx)


def apply_layer_head_perms(cache_k, cache_v, perms, *, head_axis: int = 3,
                           group_size: int = 1, rep: int = 1,
                           sent: Optional[dict] = None):
    """Per-layer reorder of a stacked cache ((L, B, T, KvE, dh) by default):
    row l of ``perms`` permutes layer l's head axis.  ``group_size`` > 1:
    rows are (group-consistent) query-head permutations while the cache
    head axis holds KV heads, so each row is mapped through
    ``kv_group_perms`` (and ``expand_kv_perms`` for ``rep`` > 1) first.
    ``perms`` may carry several leading axes, (G, 4, H) for a VLM cache
    (G, 4, B, T, KvE, dh), one permutation per leading cell.  Returns new
    tensors; the inputs are not modified — except DTensors (a sharded
    cache), which are permuted in place, each rank exchanging only the
    rows that change rank (``_permute_layers_``; ``sent`` counts them)."""
    kv = _kv_perms(perms, group_size, rep)
    return (_take_layers(cache_k, head_axis, kv, sent),
            _take_layers(cache_v, head_axis, kv, sent))


def permute_model_heads(params, perm, *, group_size: int = 1):
    """Physical head relocation by ONE permutation for every layer: the
    head axis of every ``attn`` dict's ``wq``/``wo``/``bq`` (query heads)
    and ``wk``/``wv``/``bk``/``bv`` (their KV groups, via
    ``kv_group_perms`` when ``group_size`` > 1), whatever its leading
    stack axes — the dense (L, ...) stack, the VLM's (G, 4, ...) self
    layers and (G, ...) cross layers alike.  Returns a new params dict
    sharing every tensor it does not permute."""
    q_idx = np.asarray(perm)
    kv_idx = _kv_perms(q_idx, group_size)[0]

    def take(w, axis, rows):
        return w.index_select(axis % w.ndim, torch.as_tensor(
            rows, dtype=torch.long, device=w.device))

    def visit(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k == "attn" and isinstance(v, dict):
                a = dict(v)
                a["wq"] = take(v["wq"], -2, q_idx)
                a["wk"] = take(v["wk"], -2, kv_idx)
                a["wv"] = take(v["wv"], -2, kv_idx)
                a["wo"] = take(v["wo"], -3, q_idx)
                if "bq" in v:
                    a["bq"] = take(v["bq"], -2, q_idx)
                for b in ("bk", "bv"):
                    if b in v:
                        a[b] = take(v[b], -2, kv_idx)
                out[k] = a
            else:
                out[k] = visit(v)
        return out

    return visit(params)


def permute_model_heads_layers(params, perms, *, group_size: int = 1,
                               sent: Optional[dict] = None):
    """Per-layer physical head relocation of layer-stacked attention
    weights: row l of ``perms`` reorders the head axis of layer l's
    ``wq``/``wo`` and ``bq`` (query heads) and ``wk``/``wv`` and
    ``bk``/``bv`` (their KV groups, via ``kv_group_perms`` when
    ``group_size`` > 1).  Attention is
    permutation-equivariant over heads within a layer (``wo`` sums over
    them), so the model function is unchanged; only which device holds
    which (layer, head) moves.  ``perms`` may carry several leading axes,
    (G, 4, H) for the VLM's supergroup-stacked self layers, matching the
    params' own.  Returns a new params dict sharing every tensor it does
    not permute; DTensor leaves (sharded weights) are permuted in place,
    their rows exchanged between ranks (``_permute_layers_``; ``sent``
    counts them)."""
    q_rows = np.atleast_2d(np.asarray(perms))
    kv_rows = _kv_perms(q_rows, group_size)

    def visit(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k == "attn" and isinstance(v, dict):
                a = dict(v)
                a["wq"] = _take_layers(v["wq"], -2, q_rows, sent)
                a["wk"] = _take_layers(v["wk"], -2, kv_rows, sent)
                a["wv"] = _take_layers(v["wv"], -2, kv_rows, sent)
                a["wo"] = _take_layers(v["wo"], -3, q_rows, sent)
                if "bq" in v:
                    a["bq"] = _take_layers(v["bq"], -2, q_rows, sent)
                for b in ("bk", "bv"):
                    if b in v:
                        a[b] = _take_layers(v[b], -2, kv_rows, sent)
                out[k] = a
            else:
                out[k] = visit(v)
        return out

    return visit(params)


def permute_model_experts_layers(params, perms, *,
                                 sent: Optional[dict] = None):
    """Physically relocate MoE expert rows, in place: row l of ``perms``
    reorders layer l's physical expert axis of ``w_gate``/``w_up``/
    ``w_down`` AND the ``owner``/``share`` maps that travel with the rows
    — the expert twin of ``permute_model_heads_layers``.  The combine
    scatters physical rows back into logical-expert order
    (``models.moe``), so the model function is bit-identical; only which
    mesh slot holds which expert row changes.  Layer by layer, each stack
    is gathered and copied back into its own storage, so the move needs
    one layer's stack of scratch, not a second copy of every expert (the
    reference returns new arrays instead).  Stacks sharded over "pod" (a
    DTensor) exchange only the rows that change rank, each with its d_ff
    slice, within each "model" coordinate's group (``_permute_layers_``;
    ``sent`` counts the rows and bytes this rank sent, summed over the
    three stacks); the replicated maps are permuted on every rank.
    Returns ``params``."""
    rows = np.atleast_2d(np.asarray(perms))

    def visit(tree):
        if not isinstance(tree, dict):
            return
        for k, v in tree.items():
            if k == "moe" and isinstance(v, dict):
                if "owner" not in v:
                    raise ValueError(
                        "expert migration needs owner/share maps "
                        "(install moe.expert_identity first)")
                for name in ("w_gate", "w_up", "w_down"):
                    _permute_layers_(v[name], -3, rows, sent)
                for name in ("owner", "share"):
                    _permute_layers_(v[name], -1, rows)
            else:
                visit(v)

    visit(params)
    return params


def _permute_layers_(w: torch.Tensor, axis: int, rows: np.ndarray,
                     sent: Optional[dict] = None) -> torch.Tensor:
    """In place: cell c of ``rows``' leading axes reorders axis ``axis`` of
    ``w[c]`` (rows (L, H) for a (L, ...) stack).  Returns ``w``.

    A DTensor whose ``axis`` is sharded over one mesh dimension (a head
    axis over "model") keeps its layout: each rank ends up holding its
    chunk of the permuted whole, and rows move between ranks only where
    they change rank — one ``all_to_all_single`` over that dimension's
    group, each rank sending exactly the rows another rank now holds, so
    no rank ever holds more than its shard and the rows it receives.
    Rows that stay on their rank are reordered locally.  ``sent``, when
    given, accumulates the rows and bytes this rank sent ("rows",
    "bytes").  A DTensor not sharded along ``axis`` is permuted on each
    rank's own shard."""
    axis = axis % w.ndim
    n_lead = rows.ndim - 1
    if axis < n_lead or tuple(rows.shape[:-1]) != tuple(w.shape[:n_lead]):
        raise ValueError(f"{rows.shape[:-1]} permutation rows for a stack "
                         f"of shape {tuple(w.shape)}, axis {axis}")
    if not is_dtensor(w):
        _permute_local_(w, axis, rows)
        return w
    from torch.distributed.tensor import Shard
    mesh = w.device_mesh
    over = [m for m, pl in enumerate(w.placements)
            if isinstance(pl, Shard) and pl.dim == axis]
    loc = w.to_local()
    if not over or mesh.size(over[0]) == 1:
        _permute_local_(loc, axis, rows)
        return w
    if len(over) > 1:
        raise NotImplementedError("a head axis sharded over several mesh "
                                  "dimensions")
    m = over[0]
    ranks, c = mesh.size(m), mesh.get_coordinate()[m]
    rows = rows.reshape(-1, rows.shape[-1]).astype(np.int64)
    n = rows.shape[1] // ranks
    if n * ranks != rows.shape[1] or loc.shape[axis] != n:
        raise ValueError(f"{rows.shape[1]} rows do not split evenly over "
                         f"{ranks} ranks")
    # (cells, n, rest): the rank's rows along axis 1, a view of its shard
    tm = loc.view((-1,) + loc.shape[n_lead:]).movedim(axis - n_lead + 1, 1)
    src = rows.reshape(-1, ranks, n)        # [cell, dst rank, dst row]
    src_rank, src_row = src // n, src % n
    mine = src_rank[:, c]                    # where my new rows come from
    cell = np.broadcast_to(np.arange(rows.shape[0])[:, None], mine.shape)
    dst = np.broadcast_to(np.arange(n), mine.shape)

    def idx(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.long,
                               device=loc.device)

    # rows I send: rank r's new rows that are mine now, rank by rank, each
    # in (cell, row) order — the order rank r reads them in
    out_cells, out_rows = [], []
    for r in range(ranks):
        i, j = np.nonzero(src_rank[:, r] == c) if r != c \
            else (np.zeros(0, int),) * 2
        out_cells.append(i)
        out_rows.append(src_row[i, r, j])
    send_n = [len(i) for i in out_cells]
    recv_n = [int((mine == r).sum()) if r != c else 0 for r in range(ranks)]
    row_bytes = math.prod(tm.shape[2:]) * tm.element_size()
    buf = tm[idx(np.concatenate(out_cells)), idx(np.concatenate(out_rows))]
    got = torch.empty(sum(recv_n) * row_bytes, dtype=torch.uint8,
                      device=loc.device)
    # every rank of the group takes part whenever any row changes rank
    # (each rank knows the whole permutation), as bytes: any dtype
    if (src_rank != np.arange(ranks)[None, :, None]).any():
        import torch.distributed as dist
        dist.all_to_all_single(
            got, buf.reshape(-1).view(torch.uint8),
            [k * row_bytes for k in recv_n], [k * row_bytes for k in send_n],
            group=mesh.get_group(m))
    if sent is not None:
        sent["rows"] = sent.get("rows", 0) + sum(send_n)
        sent["bytes"] = sent.get("bytes", 0) + sum(send_n) * row_bytes
    # rows that stay on this rank but move within it, then the rows it
    # received, by source rank in (cell, row) order
    stay = (mine == c) & (src_row[:, c] != dst)
    tm[idx(cell[stay]), idx(dst[stay])] = tm[idx(cell[stay]),
                                             idx(src_row[:, c][stay])]
    into = [np.nonzero(mine == r) for r in range(ranks) if r != c]
    tm[idx(np.concatenate([i for i, _ in into])),
       idx(np.concatenate([j for _, j in into]))] = \
        got.view(tm.dtype).view((-1,) + tm.shape[2:])
    return w


def _permute_local_(w: torch.Tensor, axis: int, rows: np.ndarray):
    """In place on a plain tensor: cell c of ``rows``' leading axes
    reorders axis ``axis`` of ``w[c]``."""
    n_lead = rows.ndim - 1
    idx = torch.as_tensor(rows, dtype=torch.long, device=w.device)
    for cell in np.ndindex(*rows.shape[:-1]):
        w[cell].copy_(w[cell].index_select(axis - n_lead, idx[cell]))


# ---------------------------------------------------------------------------
# Parameter, batch and decode-state placements (path-based rules)
# ---------------------------------------------------------------------------


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_spec(path_names: List[str], ndim: int, cfg, tp: int, *,
               fsdp: bool, pod_ep: bool, layout: str = "tp",
               shape: tuple = (), n_devices: int = 256) -> Spec:
    """Trailing-dims spec for one parameter, padded with leading Nones
    (stacked-layer axes are never sharded)."""
    name = path_names[-1] if path_names else ""
    quant_part = None
    if name in ("q8", "sc") and len(path_names) >= 2:
        quant_part = name
        name = path_names[-2]          # rules keyed by the weight name
    in_attn = "attn" in path_names
    if layout == "zero3":
        # every axis is DP: shard each param over the flattened device set
        # on its largest evenly-divisible dim (gathered per layer on use);
        # small/indivisible leaves stay replicated.
        if quant_part == "sc" or ndim <= 1 or not shape:
            return (None,) * ndim
        axes: list = [None] * ndim
        cands = sorted(range(ndim), key=lambda d: -shape[d])
        for d in cands:
            if shape[d] % n_devices == 0:
                axes[d] = ("data", "model")
                return tuple(axes)
        for d in cands:  # partial sharding over one axis still helps
            if shape[d] % tp == 0:
                axes[d] = "model"
                return tuple(axes)
        return (None,) * ndim
    F = "data" if fsdp else None
    kv_ok = cfg.n_kv_heads == 0 or cfg.n_kv_heads % tp == 0 \
        or cfg.n_heads % tp != 0  # padded archs keep Kp divisible too
    KV = "model" if (cfg.expanded_kv_heads(tp) and
                     cfg.padded_heads(tp) and kv_ok) else None
    EP = "pod" if pod_ep else None

    trailing: Optional[tuple] = None
    if name == "tok_embed":
        trailing = ("model", F)
    elif name == "lm_head":
        trailing = (F, "model")
    elif in_attn and name == "wq":
        trailing = (F, "model", None)
    elif in_attn and name in ("wk", "wv"):
        trailing = (F, KV, None)
    elif in_attn and name == "wo":
        trailing = ("model", None, F)
    elif in_attn and name == "bq":
        trailing = ("model", None)
    elif in_attn and name in ("bk", "bv"):
        trailing = (KV, None)
    elif name in ("w_gate", "w_up"):
        # dense (D,F) or moe (E,D,F)
        trailing = (EP, F, "model") if ndim >= 3 else (F, "model")
    elif name == "w_down":
        trailing = (EP, "model", F) if ndim >= 3 else ("model", F)
    elif name == "b_up":
        trailing = ("model",)
    elif name == "router":
        trailing = (None, None)
    # rwkv6 time/channel mix
    elif name in ("wr", "wk", "wv", "wg", "wcr"):
        trailing = (F, "model")
    elif name == "wo" and not in_attn:
        trailing = ("model", F)
    elif name == "wck":
        trailing = (F, "model")
    elif name == "wcv":
        trailing = ("model", F)
    elif name == "lora_A":
        trailing = (F, None)
    elif name == "u":
        trailing = ("model", None)
    # mamba2
    elif name == "w_in":
        trailing = (F, "model")
    elif name == "w_out":
        trailing = ("model", F)

    if trailing is None:
        trailing = ()
    if quant_part == "sc":
        # per-last-axis scale vector: inherits the weight's last-dim spec
        trailing = trailing[-1:] if trailing else ()
    trailing = tuple(trailing[-ndim:]) if ndim < len(trailing) else trailing
    lead = (None,) * (ndim - len(trailing))
    return lead + tuple(trailing)


def param_shardings(params_tree, cfg, mesh, *, fsdp: bool = False,
                    layout: str = "tp"):
    """A ``Sharding`` per parameter (or any mirrored state, such as AdamW
    moments) on ``mesh``, the tree's structure kept."""
    tp = tp_degree(mesh)
    pod_ep = cfg.is_moe and "pod" in mesh.mesh_dim_names

    def one(path, leaf):
        shape = _shape(leaf)
        return Sharding(mesh, placements(mesh, param_spec(
            list(path), len(shape), cfg, tp, fsdp=fsdp, pod_ep=pod_ep,
            layout=layout, shape=shape, n_devices=mesh.size())))
    return map_with_path(one, params_tree)


def batch_shardings(batch_tree, mesh, layout: str = "tp"):
    """Token batches: batch dim over (pod?, data) — or the whole mesh for
    zero3; everything else replicated."""
    names = tuple(mesh.mesh_dim_names)
    if layout == "zero3":
        data_axes = names
    else:
        data_axes = ("pod", "data") if "pod" in names else ("data",)

    def one(_, leaf):
        ndim = len(_shape(leaf))
        spec = [data_axes] + [None] * (ndim - 1) if ndim >= 1 else []
        return Sharding(mesh, placements(mesh, spec))
    return map_with_path(one, batch_tree)


def decode_state_spec(path_names: List[str], ndim: int, mesh_names,
                      seq_over_data: bool = False) -> Spec:
    """The reference's decode-state rule for one leaf: KV caches (lead...,
    B, T, KvE, dh) batch over data and heads over model (the co-location
    invariant; ``seq_over_data``: the cache sequence over data instead),
    int8 scales alike, SSM and WKV states heads over model, token shifts
    batch over data, the ring's slot positions replicated."""
    data_axes = ("pod", "data") if "pod" in mesh_names else ("data",)
    batch_axes = None if seq_over_data else data_axes
    nm = path_names[-1] if path_names else ""
    if nm in ("k", "v") and "img_kv" in path_names:
        # static image KV: (G, B, I, KvE, dh)
        spec = [None] * (ndim - 4) + [batch_axes, None, "model", None]
    elif nm in ("k", "v") and ndim >= 4:
        if seq_over_data:
            spec = [None] * (ndim - 4) + [None, "data", "model", None]
        else:
            spec = [None] * (ndim - 4) + [batch_axes, None, "model", None]
    elif nm in ("k_sc", "v_sc") and ndim >= 3:    # (lead,B,T,KvE)
        if seq_over_data:
            spec = [None] * (ndim - 3) + [None, "data", "model"]
        else:
            spec = [None] * (ndim - 3) + [batch_axes, None, "model"]
    elif nm == "wkv" and ndim >= 4:               # rwkv (lead,B,H,dh,dh)
        spec = [None] * (ndim - 4) + [batch_axes, "model", None, None]
    elif nm == "ssm" and ndim >= 4:               # mamba (lead,B,nh,dh,ns)
        spec = [None] * (ndim - 4) + [batch_axes, "model", None, None]
    elif nm == "conv" and ndim >= 3:              # (lead,B,cw-1,C)
        spec = [None] * (ndim - 3) + [batch_axes, None, "model"]
    elif nm in ("shift_t", "shift_c") and ndim >= 2:
        spec = [None] * (ndim - 2) + [batch_axes, None]
    elif nm == "pos":
        spec = []
    elif ndim >= 1:
        spec = [batch_axes] + [None] * (ndim - 1)
    else:
        spec = []
    return tuple(spec)


def decode_state_shardings(state_tree, cfg, mesh, *,
                           seq_over_data: bool = False):
    """A ``Sharding`` per decode-state leaf on ``mesh``
    (``decode_state_spec``); a leaf that is a Python number (a lock-step
    position) is replicated."""
    names = tuple(mesh.mesh_dim_names)

    def one(path, leaf):
        spec = decode_state_spec(list(path), len(_shape(leaf)), names,
                                 seq_over_data)
        return Sharding(mesh, placements(mesh, spec))
    return map_with_path(one, state_tree)
