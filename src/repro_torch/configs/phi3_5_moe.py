"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

Full attention in every layer; its FFN is the routed expert MLP
(``models/moe.py``), 2 of 16 experts a token.
"""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab_size=32064,
    act="swiglu",
    n_experts=16,
    moe_top_k=2,
    rope_theta=10_000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
set_skips(CONFIG.name, {"long_500k"})
