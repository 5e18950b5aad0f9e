"""Model configurations: the port's copy of ``ModelConfig`` and its registry.

A framework-free copy of the architecture description the JAX package keeps
in ``repro/configs/base.py`` (the port imports nothing from that package).
Carried over: ``ModelConfig`` with its derived widths, the name registry,
``reduced``, the four cell shapes (``ShapeConfig``, ``SHAPES``) with each
architecture's skips (``set_skips`` / ``applicable_shapes``), and the
knobs of a cell's plan (``ParallelConfig``: the fields of repro's that the
port reads; its Pallas knobs ``use_pallas`` / ``kernel_interpret`` are the
port's ``use_kernels``).
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


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class ParallelConfig:
    """The knobs of a cell that the plan, its runtime and the pipeline read
    (``distributed/sharding.py``, ``distributed/pipeline.py``); the mesh
    sizes come from the mesh itself.

    ``use_kernels`` (None or True: the kernel wrappers; False: the plain
    paths) and ``kernel_splits`` (split-K partitions of the decode page
    axis in one kernel call) become the plan runtime's ``KernelConfig``.
    ``serve_quant="int8"`` quantizes the weights of a decode plan
    (``core/quant.py``, ``Plan.serve_params``).
    """
    page_size: int = 256         # tokens per KV page
    remat: bool = True
    use_kernels: bool | None = None
    kernel_splits: int = 1
    # grad-accum microbatches of a train cell (launch/dryrun.py)
    microbatches: int = 1
    serve_quant: str = ""        # "int8" = weight-only quant on serve paths


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


def validate_draft_pair(target: ModelConfig, draft: ModelConfig) -> None:
    """Reject draft/target pairings speculative decoding cannot serve.

    The draft proposes token ids the target scores, so the two must share
    a tokenizer: equal ``vocab_size`` and ``padded_vocab``. Verify also
    needs attention stacks on both sides: paged KV rolls back for free
    (stale rows are masked, then overwritten), a recurrent carry cannot
    roll back past a rejected proposal."""
    if draft.vocab_size != target.vocab_size or \
            draft.padded_vocab != target.padded_vocab:
        raise ValueError(
            f"draft/target tokenizer mismatch: draft {draft.name!r} has "
            f"vocab {draft.vocab_size} (padded {draft.padded_vocab}) but "
            f"target {target.name!r} has vocab {target.vocab_size} (padded "
            f"{target.padded_vocab}); EngineConfig.draft_config requires a "
            "draft sharing the target's tokenizer")
    for side, cfg in (("target", target), ("draft", draft)):
        if cfg.family == "encdec" or not all(
                k in ("attn", "local") for k in cfg.block_kinds()):
            raise ValueError(
                f"speculative decode needs attention-only decoder stacks; "
                f"{side} {cfg.name!r} (family {cfg.family!r}, pattern "
                f"{cfg.pattern!r}) has recurrent or encoder blocks whose "
                "state cannot roll back past rejected proposals")


# Populated by configs/__init__.py
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


# Which shapes apply per arch (each config module registers its skips).
_SKIP: dict[str, set[str]] = {}


def set_skips(name: str, skips: set[str]) -> None:
    _SKIP[name] = skips


def applicable_shapes(name: str) -> list[str]:
    skips = _SKIP.get(name, set())
    return [s for s in SHAPES if s not in skips]
