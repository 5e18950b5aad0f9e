"""llama3.2-1b — dense GQA llama3 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_head=64,             # 32 x 64 = 2048
    d_ff=8192,
    vocab_size=128256,
    act="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
))
set_skips(CONFIG.name, {"long_500k"})
