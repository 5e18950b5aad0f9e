"""internlm2-1.8b — dense GQA [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,            # 16 x 128 = 2048
    d_ff=8192,
    vocab_size=92544,
    act="swiglu",
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297",
))
set_skips(CONFIG.name, {"long_500k"})
