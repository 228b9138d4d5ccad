"""Model API: ``build_model(cfg, tp=..., part=..., use_kernel=...,
device=...)`` — counterpart of the JAX package's ``models/api.py`` for
every family the reference builds (dense, MoE, audio, VLM, RWKV-6
``ssm`` and the Zamba2 ``hybrid``) — and ``batch_extras``, the stubbed
frontend inputs.

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
from repro_torch.device import resolve_device
from repro_torch.models.partitioning import NULL
from repro_torch.models.rwkv6 import RWKV6Model
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.zamba2 import Zamba2Model


def build_model(cfg: ModelConfig, *, tp: int = 1, part=NULL,
                use_kernel: bool = False, device=None,
                capacity_moe: bool = False, capacity_factor: float = 1.25,
                remat: str = "none"):
    """``tp`` lays attention heads out for head-level tensor parallelism
    at that degree (padded query heads, ``rep``-replicated KV heads;
    ``layers.head_dims``; RWKV-6 has no attention heads and ignores it).
    ``part`` (``partitioning``) maps the intermediates onto a mesh: every
    family's ``forward``, prefills and ``decode_step`` then run sharded,
    each rank holding its heads' KV cache (linear or ring), for MoE its
    experts' rows over "pod", for the VLM its heads' image K/V, for
    RWKV-6 and Zamba2 its heads' WKV, SSM and conv state shards (the
    recurrences on local tensors).  ``capacity_moe``
    runs MoE layers through GShard capacity dispatch at
    ``capacity_factor`` (attention families; RWKV-6 and Zamba2 have no
    MoE, as in the reference, which ignores the option for them).
    ``remat`` is one of the reference's ``REMAT_POLICIES`` names ("none",
    "full", "dots", "dots_no_batch"): activation checkpointing under
    autograd (``transformer.remat_call``); any other name raises."""
    common = dict(use_kernel=use_kernel, remat=remat,
                  device=resolve_device(device), part=part)
    if cfg.family == "ssm":
        return RWKV6Model(cfg, **common)
    if cfg.family == "hybrid":
        return Zamba2Model(cfg, tp=tp, **common)
    return TransformerLM(cfg, capacity_moe=capacity_moe,
                         capacity_factor=capacity_factor, tp=tp, **common)


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
