"""qwen2-vl-7b — VLM transformer backbone with M-RoPE [arXiv:2409.12191;
hf].

Backbone only: the vision tower is a stub. A caller passes patch-embedding
stand-ins (``extra_embeds``) and the 3-axis (temporal, height, width)
M-RoPE position ids; text positions are the same id on all three axes."""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab_size=152064,
    act="swiglu",
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),   # t/h/w sections of d_head/2 = 64
    rope_theta=1_000_000.0,
    source="arXiv:2409.12191",
))
set_skips(CONFIG.name, {"long_500k"})
