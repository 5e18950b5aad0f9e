"""Architecture registry: import every config module to register it.

The port carries the configurations its serving path supports: the dense
attention stacks (``llama3.2-1b``, ``internlm2-1.8b``, ``yi-34b``,
``gemma3-27b`` and the paper's own ``qwen1.5-7b`` / ``-14b`` / ``-72b``),
the MoE stacks ``mixtral-8x22b`` and ``phi3.5-moe-42b-a6.6b``, the
Mamba2 + shared-attention hybrid ``zamba2-1.2b``, the attention-free
xLSTM ``xlstm-350m``, the encoder-decoder ``whisper-small`` and the M-RoPE
VLM backbone ``qwen2-vl-7b``."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ParallelConfig, ShapeConfig, applicable_shapes,
    get_config, list_configs, reduced, validate_draft_pair,
)

from repro_torch.configs import (  # noqa: F401
    gemma3_27b, internlm2_1_8b, llama3_2_1b, mixtral_8x22b, phi3_5_moe,
    qwen1_5_7b, qwen1_5_14b, qwen1_5_72b, qwen2_vl_7b, whisper_small,
    xlstm_350m, yi_34b, zamba2_1_2b,
)

# assigned architectures, in repro's order
ASSIGNED = (
    "llama3.2-1b", "internlm2-1.8b", "yi-34b", "gemma3-27b", "xlstm-350m",
    "whisper-small", "mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-7b",
    "zamba2-1.2b",
)
