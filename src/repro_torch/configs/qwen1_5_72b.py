"""qwen1.5-72b — the paper's largest evaluation model (Table 1 LLM-72B:
80L, 64H, d_h=128, SwiGLU, 32K context) [arXiv:2309.16609]."""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="qwen1.5-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=64,
    d_head=128,
    d_ff=24576,
    vocab_size=151936,
    act="swiglu",
    rope_theta=1_000_000.0,
    source="paper Table 1 (Qwen1.5-72B)",
))
set_skips(CONFIG.name, {"long_500k"})
