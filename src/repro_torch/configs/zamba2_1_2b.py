"""zamba2-1.2b — hybrid Mamba2 + shared attention [arXiv:2411.15242; hf].

Pattern: 18 Mamba2 blocks then one shared-weight full-attention block,
cycled twice (38 layers; the attention block's weights are shared by both
invocations, each with its own pool layer)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,         # MHA in the shared attention blocks
    d_head=64,
    d_ff=8192,
    vocab_size=32000,
    pattern=("mamba",) * 18 + ("attn",),
    act="gelu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    rope_theta=10_000.0,
    source="arXiv:2411.15242",
))
