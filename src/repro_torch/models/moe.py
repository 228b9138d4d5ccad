"""Mixtral-style sparse MoE MLP: top-2 routing, softmax-renormalized gates
— counterpart of the JAX package's ``models/moe.py``.

Dense dispatch (``moe_block``): every expert computes on every token and
the outputs are combined by gate weight (with 8 experts and top-2, 4× the
FLOPs of packed dispatch).  GShard capacity dispatch
(``moe_block_capacity``): tokens are grouped and each group routes into
per-expert buckets of a fixed capacity, overflow dropped, so expert work
is O(tokens · k · capacity_factor).  The expert products are plain
batched matrix products over the stacked ``(E, D, F)`` weights (int8
ones dequantized through ``quantization.wt``), left to ``torch.matmul``
and ``torch.einsum`` as the reference leaves them to XLA.

Physical expert layout (expert migration and replication): the weight
stacks ``w_gate``/``w_up``/``w_down`` may hold the experts in any
*physical* row order — or with extra replica rows — described by two side
arrays in the same param dict:

 - ``owner`` (Ep,) int32: physical row r holds a copy of logical expert
   ``owner[r]`` (Ep >= E when replicas exist);
 - ``share`` (Ep,) float32: row r's fraction of its expert's gate (rows
   owned by the same expert sum to 1).

The router scores the E logical experts; physical rows compute, and the
combine scatters row outputs back into logical-expert order before the
gate reduction.  With a pure permutation that scatter adds exact zeros and
multiplies by 1.0, so decode streams are bit-identical across applied
expert migrations.

Expert parallelism (``part`` with a mesh, a DTensor input): the stacks'
physical rows shard over "pod" and their d_ff over "model"; each block
runs on the rank's local tensors with explicit collectives
(``partitioning.ExpertShard``), so no expert weight travels between the
ranks that hold other experts.  Stacks stored over "data" as well
(``fsdp``: ``(E/pod, D/data, F/model)``) are gathered over "data" on use,
and under the zero3 layout, which stores everything over every axis,
every rank gathers every expert.  Under autograd the routing runs alike on
the ranks that split the experts' work, the tokens and gates enter that
work through Megatron's "f" (``ExpertShard.enter``), and the aux loss and
routed fractions are summed over the token ranks with an identity
backward.  Under sequence parallelism the output leaves by a
reduce-scatter along the sequence over "model" (Megatron's exit of the
region) where the all-reduce would be.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.partitioning import (NULL, Sharding, expert_shard,
                                             from_local, is_dtensor, like,
                                             local)
from repro_torch.models.quantization import is_quantized, wt


def expert_identity(n_experts: int, n_layers: int = 0, device=None):
    """Identity (owner, share): row r owns logical expert r with the full
    gate.  ``n_layers > 0`` returns stacked (L, E) arrays."""
    owner = torch.arange(n_experts, dtype=torch.int32, device=device)
    share = torch.ones((n_experts,), dtype=torch.float32, device=device)
    if n_layers:
        owner = owner.repeat(n_layers, 1)
        share = share.repeat(n_layers, 1)
    return owner, share


def replicate_expert(p: dict, expert: int) -> dict:
    """Append one physical replica of logical ``expert``: copy its weight
    rows and renormalize the gate share evenly across all of its copies.
    Accepts a per-layer moe dict ((E, D, F) weights) or the stacked layer
    tree ((L, E, D, F)); installs identity owner/share first if absent.
    Returns a new dict; ``p`` is not changed."""
    stacked = p["w_gate"].dim() == 4
    out = dict(p)
    if "owner" not in out:
        E = p["w_gate"].shape[1 if stacked else 0]
        n_layers = p["w_gate"].shape[0] if stacked else 0
        out["owner"], out["share"] = expert_identity(
            E, n_layers, device=p["w_gate"].device)
    own, sh = out["owner"], out["share"]
    # per layer, the first physical row that currently holds ``expert``
    src = (own == expert).int().argmax(dim=-1)
    for name in ("w_gate", "w_up", "w_down"):
        w = out[name]
        if stacked:
            row = w[torch.arange(w.shape[0], device=w.device), src][:, None]
            out[name] = torch.cat([w, row], dim=1)
        else:
            out[name] = torch.cat([w, w[src][None]], dim=0)
    new_col = torch.full(own.shape[:-1] + (1,), expert, dtype=own.dtype,
                         device=own.device)
    own = torch.cat([own, new_col], dim=-1)
    sh = torch.cat([sh, torch.ones(new_col.shape, dtype=sh.dtype,
                                   device=sh.device)], dim=-1)
    mask = own == expert
    cnt = mask.sum(dim=-1, keepdim=True).to(sh.dtype)
    out["owner"] = own
    out["share"] = torch.where(mask, 1.0 / cnt, sh)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, n_layers: int, dtype,
             device) -> dict:
    """Stacked (L, ...) expert weights in the reference's layouts: router
    (D, E) float32, ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D)."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def dense(d_in, shape, dt):
        return dense_init(gen, d_in, (n_layers,) + shape, dt, device)

    return {"router": dense(D, (D, E), torch.float32),
            "w_gate": dense(D, (E, D, Fd), dtype),
            "w_up": dense(D, (E, D, Fd), dtype),
            "w_down": dense(Fd, (E, Fd, D), dtype)}


def _combine_physical(out, p, n_experts: int):
    """Scatter physical expert-row outputs (B,S,Ep,D) into logical-expert
    slots (B,S,E,D): z_e = sum_{r: owner[r]=e} share[r] * out_r."""
    share = p["share"].to(out.dtype)
    onehot = F.one_hot(p["owner"].long(), n_experts).to(out.dtype)  # (Ep,E)
    return torch.einsum("bsrd,re->bsed", out * share[None, None, :, None],
                        onehot)


def _seq_out(part, x, sh) -> bool:
    """Whether the layer's output leaves by a reduce-scatter along the
    sequence (``ExpertShard.sum_partials(seq_out=True)``): under sequence
    parallelism ("res_seq" over "model") when the d_ff slices lie over
    "model" and the sequence splits evenly over it."""
    return sh.ff is not None and part.mesh is not None \
        and part.rules.get("res_seq") == "model" \
        and x.shape[1] % part.mesh.size(
            tuple(part.mesh.mesh_dim_names).index("model")) == 0


def _output(part, out, x, seq_out: bool):
    """The rank's output as the residual DTensor: laid out as ``x`` (its
    batch rows, whole over "model"), or, after a reduce-scatter along the
    sequence, with its sequence chunk over "model"."""
    if seq_out:
        from torch.distributed.tensor import Shard
        names = tuple(x.device_mesh.mesh_dim_names)
        out = from_local(out, Sharding(x.device_mesh, tuple(
            Shard(1) if names[m] == "model" else pl
            for m, pl in enumerate(x.placements))), x.shape)
    else:
        out = like(out, x)
    return part.constrain(out, ("batch", "res_seq", "d_model"))


def _on_this_rank(x, p: dict, part=NULL):
    """The layer's input and parameters as this rank computes them, and
    its ``partitioning.ExpertShard``.  On a mesh (a DTensor ``x``): the
    rank's tokens, the replicated router, the shard of each expert stack
    (its physical expert rows, its d_ff slice; its rows of D gathered
    where ``part``'s rules store it over "data") and the rows' slice of
    the replicated ``owner``/``share`` maps, all local tensors — the layer
    runs on them with explicit collectives (``ExpertShard.param``: the
    gradients partial over the token axes).  Otherwise ``x`` and ``p``
    themselves, every row."""
    w = p["w_gate"]
    sh = expert_shard(x, w["q8"] if is_quantized(w) else w, part)
    if not is_dtensor(x):
        return x, p, sh
    loc = {k: ({n: sh.param(t) for n, t in v.items()} if isinstance(v, dict)
               else sh.param(v)) for k, v in p.items()}
    for name in ("owner", "share"):
        if name in loc:
            loc[name] = loc[name][sh.lo:sh.lo + sh.n]
    return local(x), loc, sh


def _token_mean(t, sh):
    """The mean of ``t`` (B, S, E) over every token of the call: the sum
    over this rank's tokens — on a mesh all-reduced over the data axes —
    over the global count (as ``mean`` computes it; for 0/1 values, the
    routed fraction, a sum of integers, so the unsharded bits)."""
    total = sh.sum_tokens(t.sum(dim=(0, 1)))
    return total / (t.shape[0] * t.shape[1] * sh.token_ranks)


def _route(cfg: ModelConfig, p: dict, x, sh):
    """Top-k gates (B,S,E) of this rank's tokens, the load-balancing aux
    loss and the logical routed-token fraction (E,), both over every
    token of the call."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    top_vals, top_idx = torch.topk(logits, cfg.experts_per_token, dim=-1)
    top_w = torch.softmax(top_vals, dim=-1)                 # renormalized
    gates = torch.zeros_like(logits).scatter(-1, top_idx, top_w)
    frac_tokens = _token_mean((gates > 0).float(), sh)
    frac_probs = _token_mean(torch.softmax(logits, dim=-1), sh)
    aux_loss = cfg.n_experts * (frac_tokens * frac_probs).sum()
    return gates, aux_loss, frac_tokens


def router_probs(cfg: ModelConfig, p: dict, x, part=NULL):
    """(B,S,E) top-k gate weights (softmax over the selected), plus the
    Switch-style load-balancing auxiliary loss.  On a mesh the gates are
    this rank's tokens' and the loss is over every token of the call."""
    xl, pl, sh = _on_this_rank(x, p, part)
    gates, aux, _ = _route(cfg, pl, xl, sh)
    return gates, aux


def moe_block(cfg: ModelConfig, p: dict, x, part=NULL):
    """Dense-dispatch MoE. x: (B,S,D) -> (B,S,D), the aux loss, and the
    logical per-expert routed-token fraction (E,) of this call (the
    router-load signal the controller's expert cost model reads).

    On a mesh (``part``, a DTensor ``x``) each rank routes its own tokens,
    gathers them and their gates over "pod", runs only its expert rows
    with its d_ff slice on them, combines its rows through its slice of
    the ``owner``/``share`` maps, and sums the partial outputs: an
    all-reduce over "model", a reduce-scatter over "pod" back to its
    tokens (``partitioning.ExpertShard``).  The aux loss and the routed
    fraction are global means, equal on every rank."""
    xl, pl, sh = _on_this_rank(x, p, part)
    seq_out = _seq_out(part, x, sh)
    out, aux, freq = _dense_dispatch(cfg, pl, xl, sh, seq_out)
    return _output(part, out, x, seq_out), aux, freq


def _dense_dispatch(cfg: ModelConfig, pl: dict, xl, sh,
                    seq_out: bool = False):
    """:func:`moe_block` on the tensors a rank computes with
    (``_on_this_rank``): its expert rows ``[sh.lo, sh.lo + sh.n)`` and
    d_ff slice, over the tokens gathered from the ranks of other rows;
    the partial output summed over the ranks (``sh.sum_partials``)."""
    _, S, D = xl.shape
    gates, aux, freq = _route(cfg, pl, xl, sh)
    # the tokens of every rank whose expert rows differ, with their gates,
    # entering the work split over the expert rows and d_ff slices
    xg = sh.gather_tokens(sh.enter(xl))
    gates = sh.gather_tokens(sh.enter(gates.to(xl.dtype)))
    Bg = xg.shape[0]
    # every physical expert row on every token: (Ep, B*S, F), one batched
    # product per weight stack (the token matrix broadcasts over experts)
    xe = xg.reshape(1, Bg * S, D)
    h = torch.matmul(xe, wt(pl, "w_gate", xl.dtype))
    u = torch.matmul(xe, wt(pl, "w_up", xl.dtype))
    h = F.silu(h) * u
    out = torch.matmul(h, wt(pl, "w_down", xl.dtype))       # (Ep, B*S, D)
    out = out.permute(1, 0, 2).reshape(Bg, S, -1, D)        # (B,S,Ep,D)
    if "owner" in pl:
        out = _combine_physical(out, pl, cfg.n_experts)
    else:
        gates = gates[..., sh.lo:sh.lo + sh.n]
    out = torch.einsum("bsed,bse->bsd", out, gates)
    return sh.sum_partials(out, seq_out), aux, freq


def _capacity_routing(cfg: ModelConfig, p: dict, x, capacity_factor: float,
                      group: int, sh):
    """The capacity dispatch's routing: gates on the physical rows grouped
    as (BG, n, Ep) in x's dtype (replicas each take their share of their
    expert's gate), the bucket capacity, each (token, row)'s bucket
    position (its rank among the group's tokens routed to that row) and
    whether it fits, plus the aux loss and the logical freq.  On a mesh
    ``x`` and ``p`` are the rank's (``_on_this_rank``): the gates are its
    rows', over the tokens gathered from the ranks of other rows — a
    bucket position is a cumulative sum per row, so rows are
    independent."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    n = min(group, S)
    if S % n:
        raise ValueError(f"capacity dispatch groups {n} tokens; a sequence "
                         f"of {S} does not split into them")
    cap = max(int(capacity_factor * k * n / E), 1)
    gates, aux, freq = _route(cfg, p, x, sh)                # (B,S,E)
    # the logical gates of the gathered tokens, then this rank's rows'
    gates = sh.gather_tokens(sh.enter(gates.to(x.dtype)))
    if "owner" in p:
        gates = gates.index_select(-1, p["owner"].long()) \
            * p["share"].to(x.dtype)
    else:
        gates = gates[..., sh.lo:sh.lo + sh.n]
    gt = gates.reshape(-1, n, gates.shape[-1])
    sel = gt > 0
    pos = torch.cumsum(sel.int(), dim=1) - 1                # (BG,n,Ep)
    keep = sel & (pos < cap)
    return gt, cap, pos, sel, keep, aux, freq


def moe_block_capacity(cfg: ModelConfig, p: dict, x,
                       capacity_factor: float = 1.25, group: int = 1024,
                       part=NULL):
    """GShard-style grouped capacity dispatch.

    Tokens are split into groups of ``group`` along the sequence (whole
    batch rows per group); each group routes into per-row buckets of
    capacity C = max(int(cf·k·n / E), 1), and a (token, row) past C in
    its group is dropped (standard MoE semantics).  Expert work is
    O(N·k·cf) instead of dense dispatch's O(N·E).  Returns (out (B,S,D),
    aux, freq) as :func:`moe_block`, and splits over a mesh as it does:
    each rank fills only its rows' buckets, from the gathered groups."""
    xl, pl, sh = _on_this_rank(x, p, part)
    seq_out = _seq_out(part, x, sh)
    out, aux, freq = _capacity_dispatch(cfg, pl, xl, sh, capacity_factor,
                                        group, seq_out)
    return _output(part, out, x, seq_out), aux, freq


def _capacity_dispatch(cfg: ModelConfig, pl: dict, xl, sh,
                       capacity_factor: float = 1.25, group: int = 1024,
                       seq_out: bool = False):
    """:func:`moe_block_capacity` on a rank's tensors, as
    :func:`_dense_dispatch` runs :func:`moe_block`."""
    B, S, D = xl.shape
    gt, cap, pos, _, keep, aux, freq = _capacity_routing(
        cfg, pl, xl, capacity_factor, group, sh)
    BG, n, Ep = gt.shape
    # one-hot bucket slots; a dropped (token, row) — unselected, or past
    # the capacity — goes to the spare slot ``cap``, sliced away, so it
    # dispatches nowhere (``jax.nn.one_hot`` zeroes such indices; torch's
    # raises on them)
    slot = torch.where(keep, pos, cap).long()
    disp = torch.zeros((BG, n, Ep, cap + 1), dtype=xl.dtype,
                       device=xl.device)
    disp = disp.scatter_(-1, slot[..., None], 1.0)[..., :cap]
    xe = torch.einsum("gnd,gnec->gecd",
                      sh.gather_tokens(sh.enter(xl)).reshape(BG, n, D),
                      disp)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe,
                            wt(pl, "w_gate", xl.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", xe, wt(pl, "w_up", xl.dtype))
    ye = torch.einsum("gecf,efd->gecd", h, wt(pl, "w_down", xl.dtype))
    comb = disp * gt[..., None]                             # (BG,n,Ep,C)
    y = torch.einsum("gecd,gnec->gnd", ye, comb)
    return sh.sum_partials(y.reshape(-1, S, D), seq_out), aux, freq


def capacity_drops(cfg: ModelConfig, p: dict, x,
                   capacity_factor: float = 1.25, group: int = 1024,
                   part=NULL):
    """The number of (token, physical row) assignments that
    :func:`moe_block_capacity` drops on ``x`` (routed, but past their
    bucket's capacity), as a 0-d tensor — on a mesh, over every rank's
    rows and tokens."""
    xl, pl, sh = _on_this_rank(x, p, part)
    _, _, _, sel, keep, _, _ = _capacity_routing(cfg, pl, xl,
                                                 capacity_factor, group, sh)
    return sh.sum_rows((sel & ~keep).sum())
