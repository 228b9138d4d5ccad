"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064, QKV bias.

[hf:Qwen/Qwen1.5-0.5B family; hf]
40 heads do not divide TP=16 -> zero-padded to 48 (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        d_head=128,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        norm_eps=1e-6,
    )
