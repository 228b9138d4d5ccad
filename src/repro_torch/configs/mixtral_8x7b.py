"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, 8 experts top-2, SWA.

[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("mixtral-8x7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=32000,
        rope_theta=1_000_000.0,
        norm_eps=1e-5,
        n_experts=8,
        experts_per_token=2,
        sliding_window=4096,
    )
