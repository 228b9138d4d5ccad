"""Model API: ``build_model(cfg, use_kernel=..., device=...)`` — counterpart
of the JAX package's ``models/api.py`` for every family the reference
builds (dense, MoE, audio, VLM, RWKV-6 ``ssm`` and the Zamba2 ``hybrid``)
— and ``batch_extras``, the stubbed frontend inputs.

The returned model exposes ``init(generator)``, ``forward`` (returning
``(logits, aux)`` as the reference's does), ``loss(params, batch)`` and the
lock-step API of the wave scheduler (``init_decode_state``, ``prefill``,
``decode_step``).  Attention-backed models (dense, MoE, audio, VLM) also
expose the continuous-batching slot API:
``init_decode_state(..., per_slot=True)``, ``prefill_bucketed``,
``insert_slot`` and ``decode_step``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama3_2_vision_11b import N_IMAGE_TOKENS
from repro_torch.models.rwkv6 import RWKV6Model
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.zamba2 import Zamba2Model


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU, and raises where none is present; pass
    ``"cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def build_model(cfg: ModelConfig, *, use_kernel: bool = False, device=None,
                capacity_moe: bool = False, capacity_factor: float = 1.25,
                remat: str = "none"):
    """``capacity_moe`` runs MoE layers through GShard capacity dispatch
    at ``capacity_factor`` (attention families; RWKV-6 and Zamba2 have no
    MoE, as in the reference, which ignores the option for them).
    ``remat`` is one of the reference's ``REMAT_POLICIES`` names ("none",
    "full", "dots", "dots_no_batch"): activation checkpointing under
    autograd (``transformer.remat_call``); any other name raises."""
    if cfg.family == "ssm":
        return RWKV6Model(cfg, use_kernel=use_kernel, remat=remat,
                          device=resolve_device(device))
    if cfg.family == "hybrid":
        return Zamba2Model(cfg, use_kernel=use_kernel, remat=remat,
                           device=resolve_device(device))
    return TransformerLM(cfg, use_kernel=use_kernel,
                         device=resolve_device(device),
                         capacity_moe=capacity_moe,
                         capacity_factor=capacity_factor, remat=remat)


def batch_extras(cfg: ModelConfig, batch: int, dtype,
                 device="cpu") -> Dict[str, Any]:
    """Extra (stubbed) frontend inputs for a batch: the VLM's precomputed
    patch embeddings (zeros, (batch, N_IMAGE_TOKENS, d_model)) and an
    all-valid mask.  The audio family's EnCodec frontend is stubbed to the
    codec tokens themselves, so it needs none."""
    if cfg.family == "vlm":
        return {"img_embeds": torch.zeros((batch, N_IMAGE_TOKENS,
                                           cfg.d_model), dtype=dtype,
                                          device=device),
                "img_mask": torch.ones((batch, N_IMAGE_TOKENS),
                                       dtype=torch.bool, device=device)}
    return {}
