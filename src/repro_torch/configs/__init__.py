"""Architecture registry — import every config module so @register runs."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    cell_is_runnable,
    get_config,
    list_archs,
)

# Register every architecture the reference registers: the dense family
# (llama, GLM-4, Qwen1.5 and the paper's own model), the sliding-window MoE
# family, the attention-free RWKV-6, the audio decoder musicgen-large, the
# VLM llama-3.2-vision and the Mamba-2 hybrid zamba2.
from repro_torch.configs import (  # noqa: F401
    glm4_9b,
    llama3_2_vision_11b,
    llama3_8b,
    mixtral_8x22b,
    mixtral_8x7b,
    musicgen_large,
    paper_gpt,
    qwen1_5_110b,
    qwen1_5_32b,
    rwkv6_7b,
    zamba2_2_7b,
)

# the reference's assigned architectures, all of which the port serves
ASSIGNED_ARCHS = (
    "qwen1.5-32b",
    "qwen1.5-110b",
    "llama3-8b",
    "glm4-9b",
    "llama-3.2-vision-11b",
    "rwkv6-7b",
    "mixtral-8x22b",
    "mixtral-8x7b",
    "musicgen-large",
    "zamba2-2.7b",
)
