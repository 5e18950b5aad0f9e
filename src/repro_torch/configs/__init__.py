"""Architecture registry: import every config module to register it.

The port carries the configurations its serving path supports: the
attention-only ``llama3.2-1b`` and the Mamba2 + shared-attention hybrid
``zamba2-1.2b``."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, get_config, reduced,
)

from repro_torch.configs import llama3_2_1b, zamba2_1_2b  # noqa: F401
