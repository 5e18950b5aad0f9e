"""gemma3-27b — dense GQA, 5:1 local:global interleave, 128k context
[hf:google/gemma-3-27b-pt].

Local layers attend through a 1024-token sliding window; every 6th layer
is global. 62 layers is not a multiple of the 6-layer pattern: the stack
ends two local layers into its eleventh cycle (``block_kinds``). qk-norm,
geglu and a tied embedding head.
"""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    sliding_window=1024,
    act="geglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-27b-pt",
))
set_skips(CONFIG.name, set())
