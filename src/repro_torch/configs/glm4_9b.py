"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 — partial RoPE.

[hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("glm4-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_head=128,
        d_ff=13696,
        vocab_size=151552,
        rope_theta=10_000.0,
        rope_fraction=0.5,   # GLM rotates half of each head dim
        qkv_bias=True,       # glm-4 uses attention bias on QKV
        norm_eps=1.5625e-7,
    )
