"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, 8 experts top-2, SWA.

[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("mixtral-8x22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=16384,
        vocab_size=32768,
        rope_theta=1_000_000.0,
        norm_eps=1e-5,
        n_experts=8,
        experts_per_token=2,
        sliding_window=4096,
    )
