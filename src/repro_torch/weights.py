"""Weight bridge: the JAX package's params as the port's params.

``params_from_jax`` takes the reference's params pytree after
``np.asarray`` on every leaf (a nested dict of numpy arrays; this module
imports no JAX) and returns the same nested dict of torch tensors on
``device``.  Names and stacked ``(L, ...)`` layouts are unchanged, so the
two packages compute the same function on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)           # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: move the
        # raw 16-bit patterns and reinterpret them
        bits = torch.from_numpy(a.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device):
    """Nested dict of numpy arrays -> nested dict of tensors on device."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, torch.device(device))
