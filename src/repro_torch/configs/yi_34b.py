"""yi-34b — llama-arch dense GQA [arXiv:2403.04652; hf].

56 query heads on 8 kv heads: a group of 7 query rows per kv head, the
odd group size of the decode and prefill attention kernels.
"""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,            # 56 x 128 = 7168
    d_ff=20480,
    vocab_size=64000,
    act="swiglu",
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
))
set_skips(CONFIG.name, {"long_500k"})
