"""The model: parameters, decode, fused multi-step decode, prefill and
chunked prefill, for attention-only stacks and the zamba2 hybrid.

Port of ``repro/models/model.py``. Each ``lax.scan`` over layers or decode
steps becomes a Python loop; the paged pool is updated in place (each layer
writes its own ``pool[...][i]`` view), and so are the recurrent rows of the
decode state. Decode attention runs through ``core/itpp.py`` (the paged
split-K kernel when ``Runtime.kernels`` is enabled); prefill attention
runs through ``kernels/ops.attention_fwd`` (the flash-attention kernel);
the Mamba2 scan through ``kernels/ops.mamba_mixer`` (the chunk-scan
kernel).

The zamba2 hybrid: ``pattern`` = n Mamba2 blocks then one attention block
whose weights (``attn_shared``) are shared by every cycle; each invocation
keeps its own pool layer. Mamba2 weights are stacked leaves
``mamba/* [L_mamba, ...]`` and the state rows ``mamba`` are stacked
``[L_mamba, B, ...]``, as in JAX.

xLSTM, MoE, enc-dec and VLM families wait for ROADMAP queue A.9.
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
from repro_torch.models import ssm as SSM


@dataclass
class Runtime:
    """Execution hooks; single device. ``kernels=None`` keeps the plain
    reference paths (gather-then-dense decode, chunked online-softmax
    prefill)."""
    ring_width: int = 0
    kernels: KernelConfig | None = None
    gla_chunk: int = 128                 # Mamba2 scan chunk at prefill

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


def _is_hybrid(cfg) -> bool:
    """The zamba2 pattern: Mamba2 blocks plus one shared attention block."""
    return set(cfg.pattern) == {"mamba", "attn"}


def _check_family(cfg) -> None:
    attn_only = all(k in ("attn", "local") for k in cfg.block_kinds())
    if cfg.family == "encdec" or cfg.is_moe or cfg.rope_kind == "mrope" \
            or not (attn_only or _is_hybrid(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: only dense attention-only stacks and the zamba2 "
            "hybrid are ported (ROADMAP queue A.9)")
    if _is_hybrid(cfg) and cfg.n_layers % len(cfg.pattern):
        raise ValueError(f"{cfg.name}: a hybrid runs whole pattern cycles; "
                         f"{cfg.n_layers} layers is not a multiple of "
                         f"{len(cfg.pattern)}")


def _hybrid_cycles(cfg) -> tuple[int, int]:
    """(cycles, Mamba2 layers per cycle) of a hybrid stack."""
    return (cfg.n_layers // len(cfg.pattern),
            sum(1 for k in cfg.pattern if k == "mamba"))


def _init_attn_layer(cfg, normal, zeros):
    d = cfg.d_model
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
    return lp


def init_params(cfg, seed: int = 0, dtype=torch.float32, device=None):
    """Random weights from a seeded ``torch.Generator`` with the
    distributions of ``repro.models.model.init_params`` (the numbers differ
    from JAX's). Layout: ``{"embed" [V, D], "final_norm" [D], ("head"
    [D, V]), "layers": [per-layer dict]}`` for attention stacks; hybrids
    hold ``"mamba"`` (stacked ``[L_mamba, ...]`` leaves) and
    ``"attn_shared"`` (one attention layer) instead of ``"layers"``. Dense
    weights are ``[d_in, d_out]``; the Mamba2 ``A_log``, ``D`` and
    ``dt_bias`` stay fp32, as in JAX.
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
    if _is_hybrid(cfg):
        n_cyc, per_cyc = _hybrid_cycles(cfg)
        layers = [SSM.init_mamba(cfg, normal, zeros, dtype, dev)
                  for _ in range(n_cyc * per_cyc)]
        params["mamba"] = {k: torch.stack([lp.pop(k) for lp in layers])
                           for k in list(layers[0])}
        params["attn_shared"] = _init_attn_layer(cfg, normal, zeros)
        return params
    params["layers"] = [_init_attn_layer(cfg, normal, zeros)
                        for _ in range(cfg.n_layers)]
    return params


def param_count_actual(params) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(count(v) for v in tree)
        return tree.numel()
    return count(params)


def _window_array(cfg) -> list[int]:
    return [cfg.sliding_window if k == "local" else 0
            for k in cfg.block_kinds()]


def _cos_sin(cfg, positions):
    """positions [B, S] -> cos/sin [B, S, dh/2] (None without rope)."""
    if cfg.rope_kind == "none":
        return None
    return L.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)


# ---------------------------------------------------------------------------
# per-slot recurrent rows
# ---------------------------------------------------------------------------

# state entries with a per-slot batch row at axis 1 ([L, B, ...] leaves):
# the recurrent carry the serving engine resets, gathers and scatters per
# slot for state-carrying batched / chunked prefill. The paged ``pool`` is
# not here (pages are per request via the block table). Only ``mamba``
# exists in the port so far; the rest come with their families (A.9).
RSTATE_KEYS = ("mamba", "mlstm", "slstm", "cross_k", "cross_v")


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of dicts / tuples of tensors."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def rstate_entries(state) -> dict[str, Any]:
    """The per-slot recurrent entries present in a decode state."""
    return {k: state[k] for k in RSTATE_KEYS if k in state}


def init_rstate(cfg, batch: int, *, device=None) -> dict[str, Any]:
    """Fresh (zero) recurrent state for ``batch`` slots — every leaf
    [L, batch, ...]."""
    state: dict[str, Any] = {}
    n_m = sum(1 for k in cfg.block_kinds() if k == "mamba")
    if n_m:
        state["mamba"] = SSM.mamba_init_state(
            cfg, batch, device=resolve_device(device), lead=(n_m,))
    return state


def _row_index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long).to(device,
                                                      non_blocking=True)


def gather_rstate(state, idx) -> dict[str, Any]:
    """Rows ``idx`` of every recurrent entry ([L, B, ...] ->
    [L, len(idx), ...], copies) — the engine's group gather for batched
    and chunked prefill."""
    rows = rstate_entries(state)
    if not rows:
        return {}
    dev = next(iter(rows.values()))["conv"].device
    ix = _row_index(idx, dev)
    return tree_map(lambda a: a.index_select(1, ix), rows)


def scatter_rstate(state, idx, rows) -> dict[str, Any]:
    """Write ``rows`` (a ``gather_rstate``-shaped tree) into recurrent rows
    ``idx`` of ``state``, in place; returns ``state``."""
    entries = rstate_entries(state)
    if entries:
        dev = next(iter(entries.values()))["conv"].device
        ix = _row_index(idx, dev)
        tree_map(lambda a, r: a.index_copy_(1, ix, r.to(a.dtype)),
                  {k: entries[k] for k in rows}, rows)
    return state


def init_decode_state(cfg, pool_spec, batch: int, *, device=None):
    """Decode-side caches: the paged pools of the attention layers plus the
    recurrent rows of the Mamba2 layers (``batch`` slots)."""
    from repro_torch.core.paged_kv import init_pool
    _check_family(cfg)
    dev = resolve_device(device)
    state: dict[str, Any] = {}
    if any(k in ("attn", "local") for k in cfg.block_kinds()):
        state["pool"] = init_pool(pool_spec, dev)
    state.update(init_rstate(cfg, batch, device=dev))
    return state


def _keep_rows(new, old, run):
    """Advance recurrent state only for running slots: rows [B, ...] with
    ``run=False`` keep their previous carry."""
    if run is None:
        return new
    return torch.where(run.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def _mamba_layers(params) -> list[dict]:
    """Per-layer views of the stacked Mamba2 weights."""
    cols = {k: v.unbind(0) for k, v in params["mamba"].items()}
    n = len(next(iter(cols.values())))
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def _layer_rows(mst, i) -> dict:
    C, n, m = mst["ssm"]
    return {"conv": mst["conv"][i], "ssm": (C[i], n[i], m[i])}


def _put_layer_rows(mst, i, new, run=None) -> None:
    """Write Mamba2 layer ``i``'s new state into the stacked rows in place
    (rows with ``run=False`` keep their carry)."""
    C, n, m = mst["ssm"]
    for dst, src in zip((mst["conv"][i], C[i], n[i], m[i]),
                        (new["conv"], *new["ssm"])):
        dst.copy_(_keep_rows(src, dst, run))


def _hybrid_stack(cfg, params, state, x, mamba, attn, run=None):
    """The zamba2 stack: per cycle, the cycle's Mamba2 layers (``mamba(lp,
    x, rows) -> (y, new_rows)``, residual) then the shared attention block
    on pool layer ``c`` (``attn(lp, x, c) -> x``)."""
    n_cyc, per_cyc = _hybrid_cycles(cfg)
    layers = _mamba_layers(params)
    mst = state["mamba"]
    for c in range(n_cyc):
        for i in range(c * per_cyc, (c + 1) * per_cyc):
            y, new = mamba(layers[i], x, _layer_rows(mst, i))
            x = x + y
            _put_layer_rows(mst, i, new, run)
        x = attn(params["attn_shared"], x, c)
    return x


def _logits(cfg, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    return L.lm_head(x, w, transpose=cfg.tie_embeddings)


def _qkv(lp, cfg, x, cs):
    """Attention prologue: pre-norm, q/k/v projections, rope."""
    q, k, v = L.qkv_project(lp["attn"], cfg,
                            L.rms_norm(x, lp["ln1"], cfg.norm_eps))
    if cs is not None:
        q = L.apply_rope(q, *cs)
        k = L.apply_rope(k, *cs)
    return q, k, v


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
    q, k, v = _qkv(lp, cfg, x[:, None, :], cs)           # [B,1,H,dh]
    a, _, _ = rt.itpp_apply(q[:, 0], k[:, 0], v[:, 0], pool_k, pool_v, bt,
                            ctx, npage, noff, window)
    x = x + L.dense(a.reshape(B, cfg.q_dim), lp["attn"]["wo"])
    return _block_tail(lp, cfg, x[:, None, :])[:, 0]


def decode_step(cfg, params, state, tokens, bt, ctx, npage, noff, *,
                run=None, rt: Runtime = DEFAULT_RT):
    """One decode step for the whole batch.

    tokens [B]; bt [B, maxp]; ctx [B] (INCLUDING the new token);
    npage/noff [B] write target for the new token's KV (``n_pages`` =
    the trash page, for slots not decoding). ``run`` [B] bool: slots
    decoding this step — recurrent rows of the others keep their carry
    (an idle, paused or mid-chunk-prefill slot must not absorb its stale
    pending token); None advances every row. Returns (fp32 logits [B, V],
    state) — the state's pool and rows are written in place.
    """
    x = L.embed(params["embed"], tokens)                # [B, D]
    cs = _cos_sin(cfg, (ctx.long() - 1)[:, None])
    pool = state["pool"]
    if "mamba" in params:
        def mamba(lp, h, rows):
            return SSM.mamba_step(lp, cfg, h, rows, kernels=rt.kernels)

        def attn(lp, h, c):
            return _attn_block_decode(lp, cfg, h, cs, 0, pool["k"][c],
                                      pool["v"][c], bt, ctx, npage, noff, rt)
        x = _hybrid_stack(cfg, params, state, x, mamba, attn, run)
        return _logits(cfg, params, x), state
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
                                    ctx, npage, noff, run=run, rt=rt)
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


def _attn_block_prefill(lp, cfg, x, cs, w, pk, pv, bt, valid_len,
                        rt: Runtime):
    """A whole-prompt attention block: writes the prompt's K/V pages
    (``valid_len`` keeps pad positions out) and attends causally."""
    from repro_torch.core.paged_kv import write_prefill
    B, S = x.shape[:2]
    q, k, v = _qkv(lp, cfg, x, cs)
    write_prefill(pk, pv, k, v, bt, valid_len=valid_len)
    a = ops.attention_fwd(q, k, v, causal=True, window=w, kernels=rt.kernels)
    x = x + L.dense(a.reshape(B, S, cfg.q_dim), lp["attn"]["wo"])
    return _block_tail(lp, cfg, x)


def _attn_block_chunk(lp, cfg, x, cs, w, pk, pv, bt, start, valid_len,
                      rt: Runtime):
    """A chunk's attention block: writes the chunk's K/V at ``start``,
    gathers the pages and attends with ``q_offset=start``."""
    from repro_torch.core.paged_kv import gather_kv, write_prefill
    B, C = x.shape[:2]
    q, k, v = _qkv(lp, cfg, x, cs)
    pk, pv = write_prefill(pk, pv, k, v, bt, ctx_start=start,
                           valid_len=valid_len)
    kf, vf = gather_kv(pk, pv, bt)             # [B, maxp*page, KVH, D]
    a = ops.attention_fwd(q, kf, vf, causal=True, window=w, q_offset=start,
                          kernels=rt.kernels)
    x = x + L.dense(a.reshape(B, C, cfg.q_dim), lp["attn"]["wo"])
    return _block_tail(lp, cfg, x)


def _prefill_mask(valid_len, S: int, device):
    """[B, S] real-token mask for the recurrent layers (None = all real):
    end-padding must not advance a row's carry."""
    if valid_len is None:
        return None
    vl = torch.as_tensor(valid_len, device=device).long()
    return torch.arange(S, device=device)[None] < vl[:, None]


def _mamba_prefill(cfg, rt: Runtime, mask):
    """Mamba2 layer body shared by ``prefill`` and ``prefill_chunk``."""
    def mamba(lp, h, rows):
        return SSM.mamba_forward(lp, cfg, h, state=rows, chunk=rt.gla_chunk,
                                 mask=mask, kernels=rt.kernels)
    return mamba


def _last_rows(x, last_idx):
    if last_idx is None:
        return x[:, -1]
    idx = torch.as_tensor(last_idx, device=x.device).long()
    return x[torch.arange(x.shape[0], device=x.device), idx]


def prefill(cfg, params, state, tokens, bt, *, last_idx=None, valid_len=None,
            rt: Runtime = DEFAULT_RT):
    """Run the prompt through the model, writing its KV pages and (hybrids)
    the recurrent rows of ``state``, which hold the rows' carry in.

    tokens [B, S] (padded to a shared S); ``last_idx`` [B] picks each
    request's true last position for the logits and ``valid_len`` [B]
    keeps pad positions out of the pool and the recurrent carry. Returns
    (fp32 logits of the last position [B, V], state)."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    cs = _cos_sin(cfg, pos)
    pool = state["pool"]
    if "mamba" in params:
        def attn(lp, h, c):
            return _attn_block_prefill(lp, cfg, h, cs, 0, pool["k"][c],
                                       pool["v"][c], bt, valid_len, rt)
        x = _hybrid_stack(cfg, params, state, x, _mamba_prefill(
            cfg, rt, _prefill_mask(valid_len, S, x.device)), attn)
    else:
        for i, (lp, w) in enumerate(zip(params["layers"],
                                        _window_array(cfg))):
            x = _attn_block_prefill(lp, cfg, x, cs, w, pool["k"][i],
                                    pool["v"][i], bt, valid_len, rt)
    return _logits(cfg, params, _last_rows(x, last_idx)), state


def prefill_chunk(cfg, params, state, tokens, bt, ctx_start, *,
                  last_idx=None, valid_len=None, rt: Runtime = DEFAULT_RT):
    """Chunked prefill continuation — the DCS-style interleave primitive.

    Processes tokens [B, C] at global positions ctx_start..ctx_start+C-1
    against context already held by earlier chunks: attention layers write
    the chunk's K/V (``write_prefill(ctx_start=...)``), gather their pages
    and attend with ``q_offset=ctx_start``; Mamba2 layers resume from the
    per-row carry in ``state`` (the previous chunk's returned state).
    ``ctx_start`` is a scalar or a [B] vector (each request at its own
    depth); ``valid_len`` keeps end-padding out of the pool and the carry.
    Returns (fp32 logits at last_idx (default C-1) [B, V], state)."""
    B, C = tokens.shape
    x = L.embed(params["embed"], tokens)
    start = torch.as_tensor(ctx_start, dtype=torch.long, device=x.device)
    offset = start if start.ndim == 0 else start[:, None]
    pos = (torch.arange(C, device=x.device)[None] + offset).expand(B, C)
    cs = _cos_sin(cfg, pos)
    pool = state["pool"]
    if "mamba" in params:
        def attn(lp, h, c):
            return _attn_block_chunk(lp, cfg, h, cs, 0, pool["k"][c],
                                     pool["v"][c], bt, start, valid_len, rt)
        x = _hybrid_stack(cfg, params, state, x, _mamba_prefill(
            cfg, rt, _prefill_mask(valid_len, C, x.device)), attn)
    else:
        for i, (lp, w) in enumerate(zip(params["layers"],
                                        _window_array(cfg))):
            x = _attn_block_chunk(lp, cfg, x, cs, w, pool["k"][i],
                                  pool["v"][i], bt, start, valid_len, rt)
    return _logits(cfg, params, _last_rows(x, last_idx)), state
