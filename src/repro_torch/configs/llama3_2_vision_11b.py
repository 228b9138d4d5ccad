"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

Cross-attention image layers every 5th layer (8 of 40). The vision frontend is
a STUB per the assignment: the model takes precomputed patch embeddings
(B, n_img_tokens, d_model).

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

CROSS_ATTN_LAYERS = (3, 8, 13, 18, 23, 28, 33, 38)
N_IMAGE_TOKENS = 1601  # one 448x448 tile -> (448/14)^2 + 1 = 1025; HF uses 1601 w/ tiles


@register("llama-3.2-vision-11b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500_000.0,
        norm_eps=1e-5,
        cross_attn_layers=CROSS_ATTN_LAYERS,
    )
