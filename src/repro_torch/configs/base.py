"""Model configuration and the ``--arch`` registry.

Copy of the JAX package's ``configs/base.py`` (fields unchanged, so a
config converts between the packages with ``dataclasses.asdict``).  Every
architecture is a :class:`ModelConfig`; input shapes are
:class:`ShapeConfig`.  The port serves the dense, MoE, RWKV-6 (``ssm``) and
audio families; the model raises on the fields of the other families.
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
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def full_attention_only(self) -> bool:
        """True if every attention layer is dense full attention (so a
        ``long_500k`` cell does not apply)."""
        if self.family in ("ssm", "hybrid"):
            return False
        return self.sliding_window == 0

    def padded_heads(self, tp: int) -> int:
        """Query heads zero-padded up to a multiple of the TP degree."""
        if self.n_heads == 0:
            return 0
        return -(-self.n_heads // tp) * tp

    def expanded_kv_heads(self, tp: int) -> int:
        """KV heads replicated up to the TP degree (co-location invariant)."""
        if self.n_kv_heads == 0:
            return 0
        return max(self.n_kv_heads, min(tp, self.padded_heads(tp)))

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Rough parameter count (roofline MODEL_FLOPS = 6 N D)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        H, K, dh = self.n_heads, self.n_kv_heads, self.d_head
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            d_inner = D
            tmix = 6 * D * d_inner          # r,k,v,g,w,o (approx, + loras)
            cmix = 2 * D * F
            return L * (tmix + cmix) + emb
        attn = D * (H * dh) + 2 * D * (K * dh) + (H * dh) * D
        if self.qkv_bias:
            attn += H * dh + 2 * K * dh
        if self.is_moe:
            n_e = self.experts_per_token if active_only else self.n_experts
            mlp = n_e * 3 * D * F + D * self.n_experts  # experts + router
        elif self.mlp_type == "swiglu":
            mlp = 3 * D * F
        else:
            mlp = 2 * D * F
        if self.family == "hybrid":
            # zamba2: mamba2 blocks + one shared attention block
            d_in = self.ssm_expand * D
            mamba = L * (D * 2 * d_in + d_in * D + d_in * (2 * self.ssm_state)
                         + d_in * self.ssm_conv + 3 * d_in)
            shared = attn + 3 * D * F
            return mamba + shared + emb
        per_layer = attn + mlp
        if self.family == "vlm":
            # cross-attention layers carry an extra KV projection pair
            per_layer_x = attn + mlp + 2 * D * (K * dh)
            n_x = len(self.cross_attn_layers)
            return (L - n_x) * per_layer + n_x * per_layer_x + emb
        return L * per_layer + emb


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape: sequence length, global batch and kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long-decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long-decode")


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long-decode"),
}


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


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell applies (the long_500k policy)."""
    if shape.kind == "long-decode" and cfg.full_attention_only:
        return False, ("skipped: pure full-attention arch — 524k dense KV cache "
                       "is the quadratic blow-up long_500k excludes (DESIGN.md §5)")
    return True, ""
