"""Mixtral-style sparse MoE MLP: top-2 routing, softmax-renormalized gates
— counterpart of the JAX package's ``models/moe.py`` for the dense
dispatch the serving model uses.

Dense dispatch: every expert computes on every token and the outputs are
combined by gate weight (with 8 experts and top-2, 4× the FLOPs of packed
dispatch).  The expert products are plain batched matrix products over
the stacked ``(E, D, F)`` weights, left to ``torch.matmul`` as the
reference leaves them to XLA.

Physical expert layout (expert migration): the weight stacks
``w_gate``/``w_up``/``w_down`` may hold the experts in any *physical* row
order, described by two side arrays in the same param dict:

 - ``owner`` (Ep,) int32: physical row r holds logical expert ``owner[r]``;
 - ``share`` (Ep,) float32: row r's fraction of its expert's gate.

The router scores the E logical experts; physical rows compute, and the
combine scatters row outputs back into logical-expert order before the
gate reduction.  With a pure permutation that scatter adds exact zeros and
multiplies by 1.0, so decode streams are bit-identical across applied
expert migrations.  ``moe_block_capacity`` and ``replicate_expert`` are not
ported yet (ROADMAP Queue 1 #11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init


def expert_identity(n_experts: int, n_layers: int = 0, device=None):
    """Identity (owner, share): row r owns logical expert r with the full
    gate.  ``n_layers > 0`` returns stacked (L, E) arrays."""
    owner = torch.arange(n_experts, dtype=torch.int32, device=device)
    share = torch.ones((n_experts,), dtype=torch.float32, device=device)
    if n_layers:
        owner = owner.repeat(n_layers, 1)
        share = share.repeat(n_layers, 1)
    return owner, share


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


def router_probs(cfg: ModelConfig, p: dict, x):
    """(B,S,E) top-k gate weights (softmax over the selected), plus the
    Switch-style load-balancing auxiliary loss."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    top_vals, top_idx = torch.topk(logits, cfg.experts_per_token, dim=-1)
    top_w = torch.softmax(top_vals, dim=-1)                 # renormalized
    gates = torch.zeros_like(logits).scatter(-1, top_idx, top_w)
    frac_tokens = (gates > 0).float().mean(dim=(0, 1))
    frac_probs = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    aux_loss = cfg.n_experts * (frac_tokens * frac_probs).sum()
    return gates, aux_loss


def moe_block(cfg: ModelConfig, p: dict, x):
    """Dense-dispatch MoE. x: (B,S,D) -> (B,S,D), the aux loss, and the
    logical per-expert routed-token fraction (E,) of this call (the
    router-load signal the controller's expert cost model reads)."""
    B, S, D = x.shape
    gates, aux = router_probs(cfg, p, x)                    # (B,S,E)
    freq = (gates > 0).float().mean(dim=(0, 1))
    gates = gates.to(x.dtype)
    # every physical expert row on every token: (Ep, B*S, F), one batched
    # product per weight stack (the token matrix broadcasts over experts)
    xe = x.reshape(1, B * S, D)
    h = torch.matmul(xe, p["w_gate"].to(x.dtype))
    u = torch.matmul(xe, p["w_up"].to(x.dtype))
    h = F.silu(h) * u
    out = torch.matmul(h, p["w_down"].to(x.dtype))          # (Ep, B*S, D)
    out = out.permute(1, 0, 2).reshape(B, S, -1, D)         # (B,S,Ep,D)
    if "owner" in p:
        out = _combine_physical(out, p, cfg.n_experts)
    out = torch.einsum("bsed,bse->bsd", out, gates)
    return out, aux, freq
