"""Hand-written Hopper kernels (CUDA C++ sources under ``csrc/``), each
beside its plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when autograd would record through ``kernel``: grad mode is on
    and a floating input requires grad.  The kernels have no backward (the
    reference's Pallas kernels have no VJP either), and their outputs carry
    no ``grad_fn``, so a differentiated call would silently drop the
    gradient of everything before it.  Checked on every device: the plain
    version that stands in on the CPU refuses as the kernel does."""
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in tensors
           if isinstance(t, torch.Tensor) and t.is_floating_point()):
        raise RuntimeError(
            f"{kernel} has no backward pass: train through the model's "
            f"plain path (use_kernel=False), or call it under "
            f"torch.no_grad()")
