"""Architecture registry: import every config module to register it.

The port carries the configurations its serving path supports: the dense
attention stacks (``llama3.2-1b``, ``internlm2-1.8b``, ``yi-34b``,
``gemma3-27b`` and the paper's own ``qwen1.5-7b`` / ``-14b`` / ``-72b``),
the MoE stacks ``mixtral-8x22b`` and ``phi3.5-moe-42b-a6.6b``, the
Mamba2 + shared-attention hybrid ``zamba2-1.2b`` and the attention-free
xLSTM ``xlstm-350m``."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, get_config, list_configs, reduced, validate_draft_pair,
)

from repro_torch.configs import (  # noqa: F401
    gemma3_27b, internlm2_1_8b, llama3_2_1b, mixtral_8x22b, phi3_5_moe,
    qwen1_5_7b, qwen1_5_14b, qwen1_5_72b, xlstm_350m, yi_34b, zamba2_1_2b,
)

