"""The paper's own evaluation model: single-layer decoder, h=32, D=2048, L0=64.

"For a Large LLM model setup (h=32, D=2048), we approximate GPT-2/LLaMA
scales." — §V.B(a).  Used by the simulator benchmarks and the e2e examples.
"""
from repro_torch.configs.base import ModelConfig, register


@register("paper-gpt")
def config() -> ModelConfig:
    return ModelConfig(
        name="paper-gpt",
        family="dense",
        n_layers=1,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=8192,           # paper Table I uses the canonical 4*D FFN
        vocab_size=50257,    # GPT-2 vocabulary
        rope_theta=10_000.0,
        norm_eps=1e-5,
    )
