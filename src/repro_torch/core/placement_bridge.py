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
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import Block, HEAD, expert_slot, graph_of


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
    """Rows of query-head permutations -> the KV-row permutations that move
    each grouped (and ``rep``-replicated) KV head with its query heads."""
    perms = np.atleast_2d(np.asarray(perms))
    if group_size <= 1:
        return perms
    return expand_kv_perms(kv_group_perms(perms, group_size), rep)


def _take_layers(w: torch.Tensor, axis: int, rows: np.ndarray) -> torch.Tensor:
    """Row l of ``rows`` reorders axis ``axis`` of layer slice ``w[l]``
    (the layer axis leads)."""
    axis = axis % w.ndim
    if axis == 0:
        raise ValueError("the head axis cannot be the leading layer axis")
    if rows.shape[0] != w.shape[0]:
        raise ValueError(f"{rows.shape[0]} permutation rows for "
                         f"{w.shape[0]} stacked layers")
    idx = torch.as_tensor(rows, dtype=torch.long, device=w.device)
    return torch.stack([w[l].index_select(axis - 1, idx[l])
                        for l in range(w.shape[0])])


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
                           group_size: int = 1, rep: int = 1):
    """Per-layer reorder of a stacked cache ((L, B, T, KvE, dh) by default):
    row l of ``perms`` permutes layer l's head axis.  ``group_size`` > 1:
    rows are (group-consistent) query-head permutations while the cache
    head axis holds KV heads, so each row is mapped through
    ``kv_group_perms`` (and ``expand_kv_perms`` for ``rep`` > 1) first.
    Returns new tensors; the inputs are not modified."""
    kv = _kv_perms(perms, group_size, rep)
    return (_take_layers(cache_k, head_axis, kv),
            _take_layers(cache_v, head_axis, kv))


def permute_model_heads_layers(params, perms, *, group_size: int = 1):
    """Per-layer physical head relocation of layer-stacked attention
    weights: row l of ``perms`` reorders the head axis of layer l's
    ``wq``/``wo`` and ``bq`` (query heads) and ``wk``/``wv`` and
    ``bk``/``bv`` (their KV groups, via ``kv_group_perms`` when
    ``group_size`` > 1).  Attention is
    permutation-equivariant over heads within a layer (``wo`` sums over
    them), so the model function is unchanged; only which device holds
    which (layer, head) moves.  Returns a new params dict sharing every
    tensor it does not permute."""
    q_rows = np.atleast_2d(np.asarray(perms))
    kv_rows = _kv_perms(q_rows, group_size)

    def visit(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k == "attn" and isinstance(v, dict):
                a = dict(v)
                a["wq"] = _take_layers(v["wq"], -2, q_rows)
                a["wk"] = _take_layers(v["wk"], -2, kv_rows)
                a["wv"] = _take_layers(v["wv"], -2, kv_rows)
                a["wo"] = _take_layers(v["wo"], -3, q_rows)
                if "bq" in v:
                    a["bq"] = _take_layers(v["bq"], -2, q_rows)
                for b in ("bk", "bv"):
                    if b in v:
                        a[b] = _take_layers(v[b], -2, kv_rows)
                out[k] = a
            else:
                out[k] = visit(v)
        return out

    return visit(params)


def permute_model_experts_layers(params, perms):
    """Physically relocate MoE expert rows, in place: row l of ``perms``
    reorders layer l's physical expert axis of ``w_gate``/``w_up``/
    ``w_down`` AND the ``owner``/``share`` maps that travel with the rows
    — the expert twin of ``permute_model_heads_layers``.  The combine
    scatters physical rows back into logical-expert order
    (``models.moe``), so the model function is bit-identical; only which
    mesh slot holds which expert row changes.  Layer by layer, each stack
    is gathered and copied back into its own storage, so the move needs
    one layer's stack of scratch, not a second copy of every expert (the
    reference returns new arrays instead).  Returns ``params``."""
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
                for name, axis in (("w_gate", -3), ("w_up", -3),
                                   ("w_down", -3), ("owner", -1),
                                   ("share", -1)):
                    _permute_layers_(v[name], axis, rows)
            else:
                visit(v)

    visit(params)
    return params


def _permute_layers_(w: torch.Tensor, axis: int, rows: np.ndarray):
    """In place: row l of ``rows`` reorders axis ``axis`` of ``w[l]``."""
    axis = axis % w.ndim
    if axis == 0 or rows.shape[0] != w.shape[0]:
        raise ValueError(f"{rows.shape[0]} permutation rows for a stack of "
                         f"shape {tuple(w.shape)}, axis {axis}")
    idx = torch.as_tensor(rows, dtype=torch.long, device=w.device)
    for l in range(w.shape[0]):
        w[l].copy_(w[l].index_select(axis - 1, idx[l]))
