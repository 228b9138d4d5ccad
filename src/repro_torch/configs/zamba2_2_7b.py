"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.

Mamba2 backbone with a single *shared* attention block applied every 6 mamba
layers (9 applications, one weight copy) — Zamba2-style hybrid.

[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_head=80,
        d_ff=10240,
        vocab_size=32000,
        norm_eps=1e-5,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        shared_attn_every=6,
    )
