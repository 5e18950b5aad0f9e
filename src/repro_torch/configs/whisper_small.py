"""whisper-small — encoder-decoder audio backbone [arXiv:2212.04356;
unverified].

The conv/mel frontend is a stub: the encoder takes precomputed frame
embeddings ``[B, 1500, d_model]`` (zeros in the serving engine). The
decoder is the LM backbone with cross-attention to the 1500 encoder
states; positions are sinusoidal (no rope). vocab 51865 is padded to
52224."""
from repro_torch.configs.base import ModelConfig, register, set_skips

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,           # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab_size=51865,
    act="gelu",
    rope_kind="none",      # learned absolute positions (sinusoidal here)
    enc_layers=12,
    enc_seq=1500,
    cross_attn=True,
    source="arXiv:2212.04356",
))
set_skips(CONFIG.name, {"long_500k"})
