"""Model configurations: the port's copy of ``ModelConfig`` and its registry.

A framework-free copy of the architecture description the JAX package keeps
in ``repro/configs/base.py`` (the port imports nothing from that package).
Only what the port's serving path reads is carried over: ``ModelConfig``
with its derived widths, the name registry and ``reduced``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

BLOCK_KINDS = ("attn", "local", "mamba", "mlstm", "slstm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    pattern: tuple[str, ...] = ("attn",)   # cycled over n_layers
    sliding_window: int = 0
    act: str = "swiglu"              # swiglu | geglu | relu | gelu
    norm_eps: float = 1e-5
    qk_norm: bool = False
    rope_kind: str = "rope"          # rope | mrope | none (learned/sinusoidal)
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM ---
    ssm_state: int = 0               # N (state size per head)
    ssm_expand: int = 2              # d_inner = ssm_expand * d_model
    ssm_head_dim: int = 64           # mamba2 P
    ssm_conv: int = 4
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0                 # fixed encoder context (1500 audio frames)
    cross_attn: bool = False
    # --- VLM ---
    mrope_sections: tuple[int, ...] = ()   # (t, h, w) rotary sections, in d_head/2 units
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_multiple: int = 256        # Megatron-style vocab padding
    source: str = ""                 # provenance tag from the assignment table

    # ---------------- derived ----------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def block_kinds(self) -> tuple[str, ...]:
        """Per-layer kinds, the pattern cycled across n_layers."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return not any(k in ("attn", "local") for k in self.block_kinds())

    @property
    def uniform_stack(self) -> bool:
        """True when all layers share one block kind & shape (PP-stackable)."""
        kinds = set(self.block_kinds())
        return len(kinds) == 1 and self.enc_layers == 0

    # ------------- analytics (used by roofline & the PIM model) -------------
    def param_count(self) -> int:
        n = 0
        n += self.padded_vocab * self.d_model                       # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model                   # lm head
        for kind in self.block_kinds():
            n += 2 * self.d_model                                   # norms
            if kind in ("attn", "local"):
                n += self.d_model * (self.q_dim + 2 * self.kv_dim)  # qkv
                n += self.q_dim * self.d_model                      # proj
                if self.is_moe:
                    n += self.d_model * self.n_experts              # router
                    n += self.n_experts * 3 * self.d_model * self.d_ff
                elif self.d_ff:
                    mult = 3 if self.act in ("swiglu", "geglu") else 2
                    n += mult * self.d_model * self.d_ff
            elif kind == "mamba":
                di, ns = self.d_inner, self.ssm_state
                n += self.d_model * (2 * di + 2 * ns + self.ssm_n_heads)
                n += di * self.d_model
            elif kind in ("mlstm", "slstm"):
                di = self.d_inner
                n += self.d_model * 4 * di + di * self.d_model
        if self.enc_layers:
            per = (self.d_model * (self.q_dim + 2 * self.kv_dim)
                   + self.q_dim * self.d_model
                   + 2 * self.d_model * self.d_ff)
            n += self.enc_layers * per
            # decoder cross-attention
            n += self.n_layers * (self.d_model * (self.q_dim + 2 * self.kv_dim)
                                  + self.q_dim * self.d_model)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for k in self.block_kinds() if k in ("attn", "local"))
        all_exp = moe_layers * self.n_experts * 3 * self.d_model * self.d_ff
        act_exp = moe_layers * self.moe_top_k * 3 * self.d_model * self.d_ff
        return full - all_exp + act_exp

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        attn_layers = sum(1 for k in self.block_kinds() if k in ("attn", "local"))
        return attn_layers * 2 * self.kv_dim * bytes_per_el


def reduced(cfg: ModelConfig, *, layers: int | None = None) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    n_layers = layers if layers is not None else max(2, 2 * len(cfg.pattern))
    if len(cfg.pattern) > 1:   # keep at least one full pattern cycle
        n_layers = max(n_layers, len(cfg.pattern))
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        vocab_multiple=16,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
    )
    if cfg.is_moe:
        kw.update(n_experts=4, moe_top_k=2)
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_head_dim=16)
    if cfg.enc_layers:
        kw.update(enc_layers=2, enc_seq=8)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(2, 3, 3))
    return replace(cfg, **kw)


# Populated by configs/__init__.py
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]

