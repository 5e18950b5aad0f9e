"""qwen1.5-7b — the paper's own primary evaluation model (Table 1 LLM-7B:
32L, 32H, d_h=128, SwiGLU, no GQA, 32K context) [arXiv:2309.16609]."""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="qwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,         # no GQA, per the paper's Table 1
    d_head=128,
    d_ff=11008,
    vocab_size=151936,
    act="swiglu",
    rope_theta=1_000_000.0,
    source="paper Table 1 (Qwen1.5-7B)",
))
set_skips(CONFIG.name, {"long_500k"})
