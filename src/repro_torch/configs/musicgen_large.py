"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only over EnCodec tokens; the EnCodec frontend is a STUB per the
assignment (``input_specs()`` supplies precomputed frame embeddings / codec
token ids). LayerNorm + GELU MLP (T5/BART-style decoder).

[arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=8192,
        vocab_size=2048,
        mlp_type="gelu",
        norm_type="layernorm",
        norm_eps=1e-5,
        rope_theta=10_000.0,
    )
