"""Train, prefill and decode step factories shared by the launcher and the
demos — counterpart of the JAX package's ``launch/steps.py``.

The train step differentiates ``model.loss`` with autograd on copies of
the params that require grad, then applies the optimizer; the params it
returns are detached.  It runs the model's plain path: the kernels have no
backward and refuse to be differentiated (``kernels.refuse_autograd``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.optim.adamw import AdamW, AdamWState, tree_leaves, tree_map


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: grads is a tree like
    ``params`` (zeros for a leaf the loss does not reach, as JAX
    returns)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, flat))
    return loss.detach(), tree_map(lambda _: next(it), leaves)


def make_train_step(model, opt: AdamW):
    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        loss, grads = value_and_grad(model.loss, params, batch)
        with torch.no_grad():
            new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, loss
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
