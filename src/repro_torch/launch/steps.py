"""Train, prefill and decode step factories shared by the launcher and the
demos — counterpart of the JAX package's ``launch/steps.py``.

The train step differentiates ``model.loss`` with autograd on copies of
the params that require grad, then applies the optimizer; the params it
returns are detached.  It runs the model's plain path: the kernels have no
backward and refuse to be differentiated (``kernels.refuse_autograd``).
On a mesh the params are DTensors and every gradient comes back laid out
as its param; ``train_cell`` builds the reference's sharded train cell.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.optim.adamw import (AdamW, AdamWState, laid_out_as,
                                     tree_leaves, tree_map)


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: grads is a tree like
    ``params`` (zeros for a leaf the loss does not reach, as JAX
    returns).  A DTensor param's gradient is redistributed to the param's
    placements (autograd may leave it a ``Partial`` sum or otherwise
    laid out)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(laid_out_as(g, p) if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, flat))
    return loss.detach(), tree_map(lambda _: next(it), leaves)


def make_train_step(model, opt: AdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``; ``train_step.model`` is ``model``."""
    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        loss, grads = value_and_grad(model.loss, params, batch)
        with torch.no_grad():
            new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, loss
    train_step.model = model
    return train_step


def make_prefill_step(model):
    def prefill_step(params, state, tokens):
        with torch.no_grad():
            return model.prefill(params, state, tokens)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, state, tokens):
        with torch.no_grad():
            return model.decode_step(params, state, tokens)
    return decode_step


def train_cell(cfg, mesh, *, fsdp: bool = True, layout: str = "tp",
               remat: str = "full", capacity_moe=None, opt=None,
               params=None):
    """The sharded train cell of the reference's
    ``launch/dryrun.build_cell`` (its train branch, ``dryrun.py:55-118``)
    on a ``DeviceMesh``, without the lowering: the partitioner of
    ``make_partitioner(mesh, fsdp=fsdp, sp=layout == "tp",
    layout=layout)``, the model of ``build_model(cfg, tp=<mesh's "model">,
    part=, remat=, capacity_moe=)`` — capacity dispatch for a MoE, as the
    reference trains one, unless ``capacity_moe`` says otherwise — params and
    AdamW moments placed by ``param_shardings(..., fsdp=, layout=)`` and
    the batch's placements by ``batch_shardings(..., layout=)``.

    ``params``: whole weights (the same on every rank), placed here; by
    default the model's init from seed 0 on the mesh's device.  Returns
    ``(step_fn, params, opt_state, batch_shardings)``: ``step_fn(params,
    opt_state, batch)`` is ``make_train_step``'s, for a batch placed by
    ``batch_shardings`` (``{"tokens", "labels"}`` and the VLM's image
    inputs; whole tensors are placed on use too)."""
    from repro_torch.core.placement_bridge import (batch_shardings,
                                                   param_shardings)
    from repro_torch.models.api import batch_extras, build_model
    from repro_torch.models.partitioning import (make_partitioner,
                                                 mesh_device, place,
                                                 tp_degree)
    from repro_torch.tree import flatten, map_with_path
    part = make_partitioner(mesh, fsdp=fsdp, sp=layout == "tp",
                            layout=layout)
    model = build_model(cfg, tp=tp_degree(mesh), part=part, remat=remat,
                        capacity_moe=cfg.is_moe if capacity_moe is None
                        else capacity_moe,
                        device=mesh_device(mesh))
    if params is None:
        params = model.init(torch.Generator(
            device=model.device).manual_seed(0))
    p_sh = flatten(param_shardings(params, cfg, mesh, fsdp=fsdp,
                                   layout=layout))
    params = map_with_path(lambda path, v: place(v, p_sh[path]), params)
    opt = opt or AdamW(lr=3e-4)
    opt_state = opt.init(params)
    o_sh = flatten(param_shardings(opt_state.mu, cfg, mesh, fsdp=fsdp,
                                   layout=layout))
    for path, m in flatten(opt_state.mu).items():
        assert tuple(m.placements) == o_sh[path].placements, path
    batch = {"tokens": torch.empty((1, 1), device="meta"),
             "labels": torch.empty((1, 1), device="meta"),
             **batch_extras(cfg, 1, torch.float32, device="meta")}
    return (make_train_step(model, opt), params, opt_state,
            batch_shardings(batch, mesh, layout=layout))
