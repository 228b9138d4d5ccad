"""Architecture registry — import every config module so @register runs."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_archs,
)

# The port's first slice serves the dense GQA family.
from repro_torch.configs import llama3_8b  # noqa: F401
