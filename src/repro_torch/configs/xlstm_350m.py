"""xlstm-350m — mLSTM + sLSTM blocks [arXiv:2405.04517; unverified].

Attention-free: a constant-size recurrent carry per request instead of a KV
cache, so the engine's paged pool serves it with no attention layer. The
pattern cycles one mLSTM block (matrix memory, gated linear attention with
an exponential input gate) and one sLSTM block (scalar memory with
recurrent memory mixing). ``d_ff`` 0: each block carries its own up/down
projections (``ssm_expand``)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_head=256,            # qkv head dim inside mLSTM blocks
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm", "slstm"),
    ssm_expand=2,
    rope_kind="none",
    source="arXiv:2405.04517",
))
