"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 attention-free d_ff=14336 vocab=65536.

Data-dependent decay; O(1) decode state (no K/V cache): 64 WKV heads of
64 channels each carry a (64, 64) float32 state.

[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,          # wkv heads = d_model / head_dim(64)
        n_kv_heads=0,        # attention-free
        d_head=64,
        d_ff=14336,
        vocab_size=65536,
        norm_type="layernorm",
        ssm_head_dim=64,
    )
