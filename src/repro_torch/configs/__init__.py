"""Architecture registry — import every config module so @register runs."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_archs,
)

# The port serves the dense GQA family (llama, and GLM-4 with QKV bias and
# partial RoPE), the sliding-window MoE family and the attention-free
# RWKV-6 family.
from repro_torch.configs import (  # noqa: F401
    glm4_9b, llama3_8b, mixtral_8x7b, rwkv6_7b)
