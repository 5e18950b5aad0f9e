"""The attention-only model: parameters, decode, fused multi-step decode,
prefill and chunked prefill.

Port of the uniform attention stack of ``repro/models/model.py``. Each
``lax.scan`` over layers or decode steps becomes a Python loop; the paged
pool is updated in place (each layer writes its own ``pool[...][i]`` view).
Decode attention runs through ``core/itpp.py`` (the paged split-K kernel
when ``Runtime.kernels`` is enabled); prefill attention runs through
``kernels/ops.attention_fwd`` (the flash-attention kernel when enabled).

Recurrent, MoE, enc-dec and VLM families wait for ROADMAP queue A.9.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.itpp import itpp_decode_attention_shard
from repro_torch.kernels import ops
from repro_torch.kernels.backend import KernelConfig, resolve_device
from repro_torch.models import layers as L


@dataclass
class Runtime:
    """Execution hooks; single device. ``kernels=None`` keeps the plain
    reference paths (gather-then-dense decode, chunked online-softmax
    prefill)."""
    ring_width: int = 0
    kernels: KernelConfig | None = None

    def __post_init__(self):
        if self.ring_width:
            raise NotImplementedError(
                "ring pools (all-windowed stacks) are ROADMAP queue A.9")

    def itpp_apply(self, q, k, v, pk, pv, bt, ctx, npage, noff, window):
        return itpp_decode_attention_shard(
            q, k, v, pk, pv, bt, ctx, npage, noff, window,
            max_pages_per_req=bt.shape[1], ring_width=self.ring_width,
            kernels=self.kernels)


DEFAULT_RT = Runtime()


def _check_family(cfg) -> None:
    if cfg.family == "encdec" or cfg.is_moe or cfg.rope_kind == "mrope" \
            or not all(k in ("attn", "local") for k in cfg.block_kinds()):
        raise NotImplementedError(
            f"{cfg.name}: only dense attention-only stacks are ported "
            "(ROADMAP queue A.9)")


def init_params(cfg, seed: int = 0, dtype=torch.float32, device=None):
    """Random weights from a seeded ``torch.Generator`` with the
    distributions of ``repro.models.model.init_params`` (the numbers differ
    from JAX's). Layout: ``{"embed" [V, D], "final_norm" [D], ("head"
    [D, V]), "layers": [per-layer dict]}``, dense weights ``[d_in, d_out]``.
    """
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * scale).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": normal((cfg.padded_vocab, d), 0.02),
        "final_norm": zeros(d),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.padded_vocab), 0.02)
    layers = []
    for _ in range(cfg.n_layers):
        attn = {"wq": normal((d, cfg.q_dim), 1 / math.sqrt(d)),
                "wk": normal((d, cfg.kv_dim), 1 / math.sqrt(d)),
                "wv": normal((d, cfg.kv_dim), 1 / math.sqrt(d)),
                "wo": normal((cfg.q_dim, d),
                             1 / math.sqrt(cfg.q_dim * 2 * cfg.n_layers))}
        if cfg.qk_norm:
            attn["qn"] = zeros(cfg.d_head)
            attn["kn"] = zeros(cfg.d_head)
        lp = {"ln1": zeros(d), "attn": attn}
        if cfg.d_ff:
            lp["ln2"] = zeros(d)
            lp["mlp"] = {"w1": normal((d, cfg.d_ff), 1 / math.sqrt(d)),
                         "w2": normal((cfg.d_ff, d), 1 / math.sqrt(cfg.d_ff))}
            if cfg.act in ("swiglu", "geglu"):
                lp["mlp"]["w3"] = normal((d, cfg.d_ff), 1 / math.sqrt(d))
        layers.append(lp)
    params["layers"] = layers
    return params


def param_count_actual(params) -> int:
    n = params["embed"].numel() + params["final_norm"].numel()
    if "head" in params:
        n += params["head"].numel()

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else v.numel()
                   for v in tree.values())
    return n + sum(count(lp) for lp in params["layers"])


def _window_array(cfg) -> list[int]:
    return [cfg.sliding_window if k == "local" else 0
            for k in cfg.block_kinds()]


def _cos_sin(cfg, positions):
    """positions [B, S] -> cos/sin [B, S, dh/2] (None without rope)."""
    if cfg.rope_kind == "none":
        return None
    return L.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)


def init_decode_state(cfg, pool_spec, batch: int, *, device=None):
    """Decode-side caches: the paged pools of the attention layers
    (``batch`` is unused — an attention stack keeps no per-slot rows)."""
    from repro_torch.core.paged_kv import init_pool
    _check_family(cfg)
    return {"pool": init_pool(pool_spec, resolve_device(device))}


def _logits(cfg, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    return L.lm_head(x, w, transpose=cfg.tie_embeddings)


def _block_tail(lp, cfg, h):
    """FFN epilogue of an attention block (prefill and decode)."""
    if "ln2" in lp:
        h = h + L.mlp(lp["mlp"], L.rms_norm(h, lp["ln2"], cfg.norm_eps),
                      cfg.act)
    return h


# ---------------------------------------------------------------------------
# decode (single token, paged KV via ITPP)
# ---------------------------------------------------------------------------

def _attn_block_decode(lp, cfg, x, cs, window, pool_k, pool_v, bt, ctx,
                       npage, noff, rt: Runtime):
    """x [B, D] one token; writes pool_k/pool_v in place."""
    B = x.shape[0]
    h = L.rms_norm(x[:, None, :], lp["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], cfg, h)          # [B,1,H,dh]
    if cs is not None:
        q = L.apply_rope(q, *cs)
        k = L.apply_rope(k, *cs)
    a, _, _ = rt.itpp_apply(q[:, 0], k[:, 0], v[:, 0], pool_k, pool_v, bt,
                            ctx, npage, noff, window)
    x = x + L.dense(a.reshape(B, cfg.q_dim), lp["attn"]["wo"])
    return _block_tail(lp, cfg, x[:, None, :])[:, 0]


def decode_step(cfg, params, state, tokens, bt, ctx, npage, noff, *,
                rt: Runtime = DEFAULT_RT):
    """One decode step for the whole batch.

    tokens [B]; bt [B, maxp]; ctx [B] (INCLUDING the new token);
    npage/noff [B] write target for the new token's KV (``n_pages`` =
    the trash page, for slots not decoding). Returns (fp32 logits [B, V],
    state) — the state's pool is written in place.
    """
    x = L.embed(params["embed"], tokens)                # [B, D]
    cs = _cos_sin(cfg, (ctx.long() - 1)[:, None])
    pool = state["pool"]
    for i, (lp, w) in enumerate(zip(params["layers"], _window_array(cfg))):
        x = _attn_block_decode(lp, cfg, x, cs, w, pool["k"][i], pool["v"][i],
                               bt, ctx, npage, noff, rt)
    return _logits(cfg, params, x), state


def decode_multi(cfg, params, state, tokens, bt, ctx, rem, allow, *,
                 horizon: int, table_width: int, page_size: int, n_pages: int,
                 eos_token: int, sample, rt: Runtime = DEFAULT_RT):
    """Fused multi-step decode: ``horizon`` decode steps with on-device
    sampling and per-slot EOS/budget masking, no host sync inside.

    Device-resident slot state (all [B] unless noted): tokens — incoming
    token per slot; bt — [B, W] Va2Pa table (attention reads the leading
    ``table_width`` slots, write targets resolve against the full width);
    ctx — context INCLUDING the incoming token; rem — tokens the slot may
    still emit; allow — steps the slot may run this horizon (0 = idle).
    ``sample``: ``logits [B, V] -> tokens [B]`` on device.

    A slot that samples EOS or spends its budget freezes (later steps write
    its KV to the trash page); one that only exhausts ``allow`` pauses with
    its pending token intact — per-token trajectories are identical for
    every horizon. Returns ``(toks [K, B], emit [K, B] bool, finished [B],
    state, tokens, ctx, rem)``.
    """
    from repro_torch.kernels.ops import write_targets
    W = bt.shape[1]
    bt_attn = bt[:, :table_width] if table_width < W else bt
    alive0 = allow > 0
    alive = alive0
    toks, emits = [], []
    for _ in range(horizon):
        run = alive & (allow > 0)
        npage, noff = write_targets(bt, ctx, run, page_size=page_size,
                                    n_pages=n_pages, ring_width=rt.ring_width)
        logits, state = decode_step(cfg, params, state, tokens, bt_attn,
                                    ctx, npage, noff, rt=rt)
        nxt = sample(logits)
        tokens = torch.where(run, nxt, tokens)
        rem = torch.where(run, rem - 1, rem)
        fin = run & ((nxt == eos_token) | (rem <= 0))
        alive = alive & ~fin
        ctx = torch.where(run & ~fin, ctx + 1, ctx)
        allow = torch.where(run, allow - 1, allow)
        toks.append(nxt)
        emits.append(run)
    return (torch.stack(toks), torch.stack(emits), alive0 & ~alive, state,
            tokens, ctx, rem)


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also fills the paged pool
# ---------------------------------------------------------------------------

def _last_rows(x, last_idx):
    if last_idx is None:
        return x[:, -1]
    idx = torch.as_tensor(last_idx, device=x.device).long()
    return x[torch.arange(x.shape[0], device=x.device), idx]


def prefill(cfg, params, state, tokens, bt, *, last_idx=None, valid_len=None,
            rt: Runtime = DEFAULT_RT):
    """Run the prompt through the model, writing its KV pages.

    tokens [B, S] (padded to a shared S); ``last_idx`` [B] picks each
    request's true last position for the logits and ``valid_len`` [B]
    keeps pad positions out of the pool. Returns (fp32 logits of the last
    position [B, V], state)."""
    from repro_torch.core.paged_kv import write_prefill
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    cs = _cos_sin(cfg, pos)
    pool = state["pool"]
    for i, (lp, w) in enumerate(zip(params["layers"], _window_array(cfg))):
        hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], cfg, hn)
        if cs is not None:
            q = L.apply_rope(q, *cs)
            k = L.apply_rope(k, *cs)
        write_prefill(pool["k"][i], pool["v"][i], k, v, bt,
                      valid_len=valid_len)
        a = ops.attention_fwd(q, k, v, causal=True, window=w,
                              kernels=rt.kernels)
        x = x + L.dense(a.reshape(B, S, cfg.q_dim), lp["attn"]["wo"])
        x = _block_tail(lp, cfg, x)
    return _logits(cfg, params, _last_rows(x, last_idx)), state


def prefill_chunk(cfg, params, state, tokens, bt, ctx_start, *,
                  last_idx=None, valid_len=None, rt: Runtime = DEFAULT_RT):
    """Chunked prefill continuation — the DCS-style interleave primitive.

    Processes tokens [B, C] at global positions ctx_start..ctx_start+C-1
    against context already held by earlier chunks: each layer writes the
    chunk's K/V (``write_prefill(ctx_start=...)``), gathers its pages and
    attends with ``q_offset=ctx_start``. ``ctx_start`` is a scalar or a [B]
    vector (each request at its own depth); ``valid_len`` keeps end-padding
    out of the pool. Returns (fp32 logits at last_idx (default C-1)
    [B, V], state)."""
    from repro_torch.core.paged_kv import gather_kv, write_prefill
    B, C = tokens.shape
    x = L.embed(params["embed"], tokens)
    start = torch.as_tensor(ctx_start, dtype=torch.long, device=x.device)
    offset = start if start.ndim == 0 else start[:, None]
    pos = (torch.arange(C, device=x.device)[None] + offset).expand(B, C)
    cs = _cos_sin(cfg, pos)
    pool = state["pool"]
    for i, (lp, w) in enumerate(zip(params["layers"], _window_array(cfg))):
        hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], cfg, hn)
        if cs is not None:
            q = L.apply_rope(q, *cs)
            k = L.apply_rope(k, *cs)
        pk, pv = write_prefill(pool["k"][i], pool["v"][i], k, v, bt,
                               ctx_start=start, valid_len=valid_len)
        kf, vf = gather_kv(pk, pv, bt)         # [B, maxp*page, KVH, D]
        a = ops.attention_fwd(q, kf, vf, causal=True, window=w,
                              q_offset=start, kernels=rt.kernels)
        x = x + L.dense(a.reshape(B, C, cfg.q_dim), lp["attn"]["wo"])
        x = _block_tail(lp, cfg, x)
    return _logits(cfg, params, _last_rows(x, last_idx)), state
