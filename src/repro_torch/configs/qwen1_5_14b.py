"""qwen1.5-14b — the paper's mid-scale evaluation model (Table 1 LLM-14B:
40L, 40H, d_h=128, SwiGLU, 32K context) [arXiv:2309.16609]."""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="qwen1.5-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_head=128,
    d_ff=13696,
    vocab_size=151936,
    act="swiglu",
    rope_theta=1_000_000.0,
    source="paper Table 1 (Qwen1.5-14B)",
))
set_skips(CONFIG.name, {"long_500k"})
