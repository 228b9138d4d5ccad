"""Model configuration and the ``--arch`` registry.

Copy of the JAX package's ``configs/base.py`` (fields unchanged, so a
config converts between the packages with ``dataclasses.asdict``).  The
port serves the dense, MoE and RWKV-6 (``ssm``) families; the model raises
on the fields of the other families.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (decoder-only backbone)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio

    n_layers: int
    d_model: int
    n_heads: int            # query heads (0 for attention-free archs)
    n_kv_heads: int         # GQA KV heads
    d_head: int
    d_ff: int
    vocab_size: int

    # --- attention details -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    rope_fraction: float = 1.0          # glm4 rotates half the head dim
    sliding_window: int = 0             # 0 = full attention (mixtral: 4096)
    # layers (indices) that use cross-attention instead of self-attention
    cross_attn_layers: Tuple[int, ...] = ()

    # --- MLP / norm flavour -------------------------------------------------
    mlp_type: str = "swiglu"            # swiglu | gelu
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0

    # --- SSM (rwkv6 / mamba2 / zamba2) --------------------------------------
    ssm_state: int = 0                  # mamba2 state size per head
    ssm_head_dim: int = 64
    ssm_expand: int = 2                 # d_inner = expand * d_model
    ssm_conv: int = 4
    # zamba2: a single shared attention block applied every k mamba layers
    shared_attn_every: int = 0

    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    kv_quant: bool = False              # int8 KV cache (serving, §Perf)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    return sorted(_REGISTRY)
