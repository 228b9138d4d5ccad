"""The family-preserving reduced float32 widths at which the port is held
to the JAX package on the CPU — that package's
``tests/conftest.reduced_config``, written here without JAX so that the
port's rank helpers and ``chip_smoke.py`` share one definition."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, get_config


def reduced_config(name: str, **over) -> ModelConfig:
    """``name``'s config at d 64, d_ff 128, vocab 97, 4 heads of 16 (at
    most 4 KV heads), float32; 2 layers (the VLM 5, the hybrid 4 with its
    shared block every 2nd); a MoE keeps 4 experts and a window of 8.
    ``over`` is applied last."""
    cfg = get_config(name)
    base = dict(d_model=64, d_ff=128, vocab_size=97,
                dtype="float32", param_dtype="float32")
    if cfg.n_heads:
        base.update(n_heads=4, d_head=16,
                    n_kv_heads=min(4, cfg.n_kv_heads or 4))
    if cfg.family == "vlm":
        base.update(n_layers=5)
    elif cfg.family == "hybrid":
        base.update(n_layers=4, shared_attn_every=2)
    elif cfg.family == "ssm":
        base.update(n_layers=2, n_heads=4, d_head=16)
    else:
        base.update(n_layers=2)
    if cfg.is_moe:
        base.update(n_experts=4, sliding_window=8)
    base.update(over)
    return cfg.with_overrides(**base)
