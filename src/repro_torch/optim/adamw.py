"""AdamW and a cosine LR schedule over the port's params trees (nested
dicts of tensors) — counterpart of the JAX package's ``optim/adamw.py``,
with its arithmetic: a float32 global-norm clip, float32 moments whatever
the param dtype, bias corrections ``1 - b^step``, the update
``mhat / (sqrt(nhat) + eps) + wd * p`` applied in float32 and cast back to
the param's dtype, and the learning rate read at the incremented step.

This is not ``torch.optim.AdamW``, which keeps its moments in the param
dtype and applies the decay before the Adam step.  ``update`` is
functional, as the reference's: it returns new params and a new state and
writes none of its inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor         # scalar int32
    mu: Any                    # first moment (float32 tree)
    nu: Any                    # second moment (float32 tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        device = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          mu=zeros, nu=tree_map(torch.clone, zeros))

    def _lr(self, step):
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    def update(self, grads, state: AdamWState, params):
        """One step from ``grads`` (a tree like ``params``).  Returns
        (new_params, new_state)."""
        step = state.step + 1
        grads = tree_map(lambda g: g.float(), grads)
        if self.grad_clip > 0:
            gnorm = torch.sqrt(sum(g.square().sum()
                                   for g in tree_leaves(grads)))
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g * g, state.nu,
                      grads)
        stepf = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=stepf.device), stepf)
        lr = self._lr(step)

        def upd(p, m, n):
            p32 = p.float()
            delta = (m / bc1) / (torch.sqrt(n / bc2) + self.eps)
            delta = delta + self.weight_decay * p32
            return (p32 - lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``; ``lr(step)`` takes a step
    tensor and returns a float32 scalar tensor."""
    def lr(step):
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
