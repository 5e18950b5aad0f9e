"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf].

Every layer is a 4096-token sliding-window (``local``) block whose FFN is
the routed expert MLP (``models/moe.py``).
"""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=("local",),    # sliding-window attention per the assignment
    sliding_window=4096,
    act="swiglu",
    n_experts=8,
    moe_top_k=2,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
))
set_skips(CONFIG.name, set())
