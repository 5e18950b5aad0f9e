"""Architecture registry: import every config module to register it.

The port carries the configurations its serving path supports; this slice
serves the attention-only ``llama3.2-1b``."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, get_config, reduced,
)

from repro_torch.configs import llama3_2_1b  # noqa: F401
