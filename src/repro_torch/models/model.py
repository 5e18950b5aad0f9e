"""The model: parameters, decode, fused multi-step decode, speculative
decode (the draft's proposal scan and the one-pass multi-query verify),
prefill and chunked prefill, for attention-only stacks (dense, MoE, the
M-RoPE VLM backbone), the zamba2 hybrid, xLSTM and the enc-dec family.

Port of ``repro/models/model.py``. Each ``lax.scan`` over layers or decode
steps becomes a Python loop; the paged pool is updated in place (each layer
writes its own ``pool[...][i]`` view), and so are the recurrent rows of the
decode state. Decode attention runs through ``core/itpp.py`` (the paged
split-K kernel when ``Runtime.kernels`` is enabled); prefill attention
runs through ``kernels/ops.attention_fwd`` (the flash-attention kernel);
the Mamba2 scan through ``kernels/ops.mamba_mixer`` (the chunk-scan
kernel).

MoE stacks (``family == "moe"``): every attention block's FFN is the routed
expert MLP of ``models/moe.py``, applied in ``_block_tail`` on every path
through ``Runtime.moe_apply`` (``moe_local`` on one device, the plan's
``moe_ep`` on a mesh), with repro's capacity over every row the path
passes.

A sharding plan (``distributed/sharding.py``) fills the ``Runtime``'s
distribution hooks for a shard body: decode attention through
``Runtime.itpp`` (a shard's ITPP over its pages), the dense decode
products as Megatron TP through ``Runtime.tp_axis``, the prefill pool
writes through ``Runtime.write_pool``, the MoE through ``Runtime.moe``;
their defaults are the single-device paths.

The zamba2 hybrid: ``pattern`` = n Mamba2 blocks then one attention block
whose weights (``attn_shared``) are shared by every cycle; each invocation
keeps its own pool layer. Mamba2 weights are stacked leaves
``mamba/* [L_mamba, ...]`` and the state rows ``mamba`` are stacked
``[L_mamba, B, ...]``, as in JAX.

xLSTM (``pattern == ("mlstm", "slstm")``, attention-free): cycles of one
mLSTM and one sLSTM block, each residual. Weights are stacked leaves
``mlstm/* [n_cyc, ...]`` and ``slstm/* [n_cyc, ...]`` and the carries are
stacked rows ``mlstm`` = (C, n, m) and ``slstm`` = (c, n, m, h), each
``[n_cyc, B, ...]``, as in JAX. The decode state holds no pool. No kernel
runs on this path: the mLSTM is the plain ``chunked_gla(normalize=True)``
and the sLSTM a loop of cell steps (``models/ssm.py``), as in JAX.

The enc-dec family (whisper, ``family == "encdec"``): an encoder stack of
non-causal attention blocks over stub frame embeddings (``encode``) and a
decoder stack (``params["dec"]``) whose every block adds cross-attention
to the encoder states after its self-attention. Positions are sinusoidal
(added to the embeddings; no rope). The cross K/V rows are computed once
a request (``make_cross_kv``) and kept in the decode state as stacked
``cross_k`` / ``cross_v`` rows ``[L, B, enc_seq, KVH, D]``, written in
place like the recurrent rows. Prefill attends to them through
``ops.attention_fwd(causal=False)`` (the flash-attention kernel), a decode
step through ``ops.cross_attention_decode`` (the flash-decode kernel's
split-K partials and their merge), where JAX calls the jnp
``flash_attention`` and ``decode_attention_ref``: the same functions.

Multimodal rope (qwen2-vl, ``rope_kind == "mrope"``): positions are
``[3, B, S]`` (t, h, w ids) where a caller gives them (``prefill``'s
``positions=`` beside ``extra_embeds=``, the vision tower's stand-ins);
by default one id on all three axes, which is plain rope.

Ring pools (``Runtime(ring_width=W)``, sliding-window stacks): table slots
recycle mod W, prefill writes only the prompt's last ``W * page`` tokens
and decode attention maps slots back to virtual pages (the paged kernel's
``ring_width``).

Training (``forward_hidden``, ``forward``, ``train_loss``): the
full-sequence forward of every family with no pool, each layer optionally
recomputed in backward (``Runtime.remat``), and a chunked cross-entropy.
It runs on the plain paths only (``check_trainable``): no kernel of the
port has a backward, and repro's training path reaches no Pallas kernel,
so autograd differentiates the plain ``layers.flash_attention``,
``ssm.chunked_gla`` and the sLSTM cell loop, as ``jax.grad`` does
repro's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.itpp import itpp_decode_attention_shard
from repro_torch.distributed import mesh as M
from repro_torch.kernels import ops
from repro_torch.kernels.backend import KernelConfig, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM


@dataclass
class Runtime:
    """Execution hooks; the defaults are the single-device paths.
    ``kernels=None`` keeps the plain reference paths (gather-then-dense
    decode, chunked online-softmax prefill). ``remat`` recomputes each
    layer of the full-sequence forward in backward
    (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``).

    The distribution layer (``distributed/sharding.py``) fills the rest,
    as repro's: ``itpp`` the sharded decode attention
    (``core/itpp.make_itpp_attention``), ``moe`` the expert-parallel MoE
    (``(p, cfg, x) -> (y, aux)``), ``write_pool`` the shard-local prefill
    writer and ``cond_window`` the windowed bound of mixed local:global
    stacks.

    A sharded train step (``Plan.make_runtime(mode="train")``) carries its
    ``plan``; ``training/train.make_train_step`` runs it on the plan's
    mesh with a shard's runtime, whose ``fetch`` returns a layer's whole
    weights from the shard's FSDP slices (called inside the layer's
    forward, so remat gathers again in backward) and whose ``seq_axis``
    names the mesh axis the sequence is cut over (the ``sp`` layout:
    attention takes K/V gathered over it at the shard's ``q_offset``; a
    recurrent layer runs on the gathered sequence and keeps its own
    slice).

    A sharded decode step (``Plan.make_runtime(mode="decode")``,
    ``distributed/sharding.make_decode_step``) sets ``tp_axis``, the mesh
    axis of Megatron tensor parallelism: a weight the serve plan cuts
    holds the shard's block (``models/layers.dense_col`` /
    ``dense_row``). A column-parallel product is all-gathered where the
    next step takes the whole vector (q/k/v into ITPP, whose shards each
    attend over their own pages with every head; the Mamba2 and mLSTM
    inputs) and an MLP's ``w1`` / ``w3`` block feeds its row-parallel
    ``w2``; a row-parallel product is summed over the axis. ``embed`` is
    cut on D (a looked-up block, all-gathered), an untied ``head`` on the
    vocabulary (the shard's block of the logits), a tied head is
    row-parallel over D."""
    ring_width: int = 0
    kernels: KernelConfig | None = None
    gla_chunk: int = 128                 # Mamba2 scan chunk at prefill
    remat: bool = False
    itpp: Callable | None = None
    moe: Callable | None = None
    write_pool: Callable | None = None
    cond_window: int = 0
    plan: Any = None
    fetch: Callable | None = None
    seq_axis: str | None = None
    tp_axis: str | None = None

    def itpp_apply(self, q, k, v, pk, pv, bt, ctx, npage, noff, window):
        if self.itpp is not None:
            return self.itpp(q, k, v, pk, pv, bt, ctx, npage, noff, window)
        return itpp_decode_attention_shard(
            q, k, v, pk, pv, bt, ctx, npage, noff, window,
            max_pages_per_req=bt.shape[1], ring_width=self.ring_width,
            cond_window=self.cond_window, kernels=self.kernels)

    def moe_apply(self, p, cfg, x, *, with_aux: bool = False):
        """The MoE FFN over x [B, S, D]: y, or ``(y, aux)`` with
        ``with_aux``."""
        if self.moe is not None:
            y, aux = self.moe(p, cfg, x)
            return (y, aux) if with_aux else y
        return MOE.moe_local(p, cfg, x, with_aux=with_aux)


DEFAULT_RT = Runtime()


def _fetch(rt: Runtime, tree):
    """``tree``'s whole weights: ``rt.fetch``'s gather of a shard's slices,
    or ``tree`` itself."""
    return tree if rt.fetch is None else rt.fetch(tree)


def _seq_offset(rt: Runtime, S: int) -> int:
    """The position of this shard's first token in its rows (``sp``)."""
    return 0 if rt.seq_axis is None else M.axis_index(rt.seq_axis) * S


def _seq_whole(rt: Runtime, fn, h, *, carry: bool = False):
    """``fn`` over the whole sequence of ``h`` [B, S, D] (gathered over
    ``rt.seq_axis`` in the ``sp`` layout), this shard's slice of its
    output (``carry``: of its ``(y, carry)`` output's ``y``)."""
    if rt.seq_axis is None:
        return fn(h)
    S = h.shape[1]
    out = fn(M.all_gather(h, rt.seq_axis, dim=1, tiled=True))
    y = out[0] if carry else out
    y = y.narrow(1, _seq_offset(rt, S), S)
    return (y, *out[1:]) if carry else y


def _last_hidden(rt: Runtime, x, last_idx):
    """Each row's hidden state at ``last_idx`` (its last position by
    default); in the ``sp`` layout from the shard holding it."""
    if rt.seq_axis is None:
        return _last_rows(x, last_idx)
    B, S = x.shape[:2]
    off = _seq_offset(rt, S)
    idx = torch.as_tensor(S * M.axis_size(rt.seq_axis) - 1
                          if last_idx is None else last_idx,
                          device=x.device).long().expand(B)
    loc = idx - off
    own = (loc >= 0) & (loc < S)
    rows = x[torch.arange(B, device=x.device), loc.clamp(0, S - 1)]
    return M.psum(torch.where(own[:, None], rows, torch.zeros_like(rows)),
                  rt.seq_axis)


def _is_hybrid(cfg) -> bool:
    """The zamba2 pattern: Mamba2 blocks plus one shared attention block."""
    return set(cfg.pattern) == {"mamba", "attn"}


def _is_xlstm(cfg) -> bool:
    """The xLSTM pattern: (mLSTM, sLSTM) cycles, no attention."""
    return tuple(cfg.pattern) == ("mlstm", "slstm")


def _check_family(cfg) -> None:
    attn_only = all(k in ("attn", "local") for k in cfg.block_kinds())
    if (cfg.is_moe and not attn_only) \
            or not (attn_only or _is_hybrid(cfg) or _is_xlstm(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: pattern {cfg.pattern!r} is not ported; the port "
            "serves attention-only stacks (dense, MoE, enc-dec), the zamba2 "
            "hybrid and xLSTM")
    if (_is_hybrid(cfg) or _is_xlstm(cfg)) \
            and cfg.n_layers % len(cfg.pattern):
        raise ValueError(f"{cfg.name}: a recurrent stack runs whole pattern "
                         "cycles; "
                         f"{cfg.n_layers} layers is not a multiple of "
                         f"{len(cfg.pattern)}")


def _hybrid_cycles(cfg) -> tuple[int, int]:
    """(cycles, Mamba2 layers per cycle) of a hybrid stack."""
    return (cfg.n_layers // len(cfg.pattern),
            sum(1 for k in cfg.pattern if k == "mamba"))


def _init_attention(cfg, normal, zeros, *, cross: bool = False):
    d = cfg.d_model
    attn = {"wq": normal((d, cfg.q_dim), 1 / math.sqrt(d)),
            "wk": normal((d, cfg.kv_dim), 1 / math.sqrt(d)),
            "wv": normal((d, cfg.kv_dim), 1 / math.sqrt(d)),
            "wo": normal((cfg.q_dim, d),
                         1 / math.sqrt(cfg.q_dim * 2 * cfg.n_layers))}
    if cfg.qk_norm and not cross:
        attn["qn"] = zeros(cfg.d_head)
        attn["kn"] = zeros(cfg.d_head)
    return attn


def _init_attn_layer(cfg, normal, zeros, *, cross: bool = False,
                     moe_virtual: int = 0):
    d = cfg.d_model
    lp = {"ln1": zeros(d), "attn": _init_attention(cfg, normal, zeros)}
    if cross:
        lp["lnx"] = zeros(d)
        lp["xattn"] = _init_attention(cfg, normal, zeros, cross=True)
    if cfg.is_moe:
        lp["ln2"] = zeros(d)
        lp["moe"] = MOE.init_moe(cfg, normal, n_virtual=moe_virtual or None)
    elif cfg.d_ff:
        lp["ln2"] = zeros(d)
        lp["mlp"] = {"w1": normal((d, cfg.d_ff), 1 / math.sqrt(d)),
                     "w2": normal((cfg.d_ff, d), 1 / math.sqrt(cfg.d_ff))}
        if cfg.act in ("swiglu", "geglu"):
            lp["mlp"]["w3"] = normal((d, cfg.d_ff), 1 / math.sqrt(d))
    return lp


def init_params(cfg, seed: int = 0, dtype=torch.float32, device=None, *,
                moe_virtual: int = 0):
    """Random weights from a seeded ``torch.Generator`` with the
    distributions of ``repro.models.model.init_params`` (the numbers differ
    from JAX's). Layout: ``{"embed" [V, D], "final_norm" [D], ("head"
    [D, V]), "layers": [per-layer dict]}`` for attention stacks; hybrids
    hold ``"mamba"`` (stacked ``[L_mamba, ...]`` leaves) and
    ``"attn_shared"`` (one attention layer) instead of ``"layers"``; xLSTM
    holds ``"mlstm"`` and ``"slstm"`` (stacked ``[n_cyc, ...]`` leaves);
    the enc-dec family ``"enc"`` (per-layer dicts), ``"enc_norm"`` and
    ``"dec"`` (per-layer dicts with ``lnx`` and ``xattn``).
    Dense weights are ``[d_in, d_out]``; the Mamba2 ``A_log``, ``D`` and
    ``dt_bias`` and the xLSTM gate biases stay fp32, as in JAX. A MoE's
    experts come as ``moe_virtual`` virtual experts (default one per
    expert; a plan's ``tp`` for expert parallelism). ``device="meta"``
    gives the shapes alone (a plan's specs at full size).
    """
    _check_family(cfg)
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev)
    if gen is not None:
        gen.manual_seed(seed)

    def normal(shape, scale):
        if gen is None:
            return torch.empty(shape, dtype=dtype, device=dev)
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

    def stack(layers):
        return {k: torch.stack([lp.pop(k) for lp in layers])
                for k in list(layers[0])}
    if _is_hybrid(cfg):
        n_cyc, per_cyc = _hybrid_cycles(cfg)
        params["mamba"] = stack([SSM.init_mamba(cfg, normal, zeros, dtype, dev)
                                 for _ in range(n_cyc * per_cyc)])
        params["attn_shared"] = _init_attn_layer(cfg, normal, zeros)
        return params
    if _is_xlstm(cfg):
        n_cyc = cfg.n_layers // 2
        params["mlstm"] = stack([SSM.init_mlstm(cfg, normal, zeros, dtype, dev)
                                 for _ in range(n_cyc)])
        params["slstm"] = stack([SSM.init_slstm(cfg, normal, zeros, dtype, dev)
                                 for _ in range(n_cyc)])
        return params
    if cfg.family == "encdec":
        params["enc"] = [_init_attn_layer(cfg, normal, zeros)
                         for _ in range(cfg.enc_layers)]
        params["enc_norm"] = zeros(d)
        params["dec"] = [_init_attn_layer(cfg, normal, zeros, cross=True)
                         for _ in range(cfg.n_layers)]
        return params
    params["layers"] = [_init_attn_layer(cfg, normal, zeros,
                                         moe_virtual=moe_virtual)
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
    """positions [B, S] (rope), or [3, B, S] or [B, S] (M-RoPE; [B, S]
    broadcast to all three axes) -> cos/sin [B, S, dh/2] (None without
    rope)."""
    if cfg.rope_kind == "none":
        return None
    if cfg.rope_kind == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        return L.mrope_cos_sin(positions, cfg.d_head, cfg.rope_theta,
                               cfg.mrope_sections)
    return L.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)


def default_positions(cfg, B: int, S: int, device=None):
    """Positions ``arange(S)`` a row: [B, S], or [3, B, S] (one id on all
    three axes) for M-RoPE."""
    pos = torch.arange(S, device=device)[None].expand(B, S)
    if cfg.rope_kind == "mrope":
        return pos[None].expand(3, B, S)
    return pos


# ---------------------------------------------------------------------------
# per-slot recurrent rows
# ---------------------------------------------------------------------------

# state entries with a per-slot batch row at axis 1 ([L, B, ...] leaves):
# the recurrent carry and the enc-dec cross K/V the serving engine resets,
# gathers and scatters per slot for state-carrying batched / chunked
# prefill. The paged ``pool`` is not here (pages are per request via the
# block table).
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
    """The per-slot recurrent / cross entries present in a decode state."""
    return {k: state[k] for k in RSTATE_KEYS if k in state}


def init_rstate(cfg, batch: int, *, device=None) -> dict[str, Any]:
    """Fresh recurrent / cross state for ``batch`` slots — every leaf [L,
    batch, ...]: zeros (the enc-dec ``cross_k`` / ``cross_v`` rows [L,
    batch, enc_seq, KVH, D] fp32), and the xLSTM stabilisers ``m`` at
    ``NEG_INF``."""
    state: dict[str, Any] = {}
    dev = resolve_device(device)
    n_m = sum(1 for k in cfg.block_kinds() if k == "mamba")
    if n_m:
        state["mamba"] = SSM.mamba_init_state(cfg, batch, device=dev,
                                              lead=(n_m,))
    if _is_xlstm(cfg):
        n = cfg.n_layers // 2
        state["mlstm"] = SSM.mlstm_init_state(cfg, batch, device=dev,
                                              lead=(n,))
        state["slstm"] = SSM.slstm_init_state(cfg, batch, device=dev,
                                              lead=(n,))
    if cfg.family == "encdec":
        state["cross_k"] = torch.zeros(
            (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.d_head),
            dtype=torch.float32, device=dev)
        state["cross_v"] = torch.zeros_like(state["cross_k"])
    return state


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (dict, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


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
    ix = _row_index(idx, _first_leaf(rows).device)
    return tree_map(lambda a: a.index_select(1, ix), rows)


def scatter_rstate(state, idx, rows) -> dict[str, Any]:
    """Write ``rows`` (a ``gather_rstate``-shaped tree) into recurrent rows
    ``idx`` of ``state``, in place; returns ``state``."""
    entries = rstate_entries(state)
    if entries:
        ix = _row_index(idx, _first_leaf(entries).device)
        tree_map(lambda a, r: a.index_copy_(1, ix, r.to(a.dtype)),
                  {k: entries[k] for k in rows}, rows)
    return state


def init_decode_state(cfg, pool_spec, batch: int, *, device=None):
    """Decode-side caches: the paged pools of the attention layers (none
    for xLSTM; the decoder's for enc-dec) plus the recurrent rows of the
    Mamba2 / xLSTM layers and the enc-dec cross rows (``batch`` slots)."""
    from repro_torch.core.paged_kv import init_pool
    _check_family(cfg)
    dev = resolve_device(device)
    state: dict[str, Any] = {}
    if any(k in ("attn", "local") for k in cfg.block_kinds()) \
            or cfg.family == "encdec":
        state["pool"] = init_pool(pool_spec, dev)
    state.update(init_rstate(cfg, batch, device=dev))
    return state


def encode(cfg, params, frames, rt: Runtime = DEFAULT_RT):
    """The whisper encoder over stub frame embeddings [B, enc_seq, D]:
    sinusoidal positions, non-causal attention blocks
    (``ops.attention_fwd(causal=False)``), the final norm; each layer
    recomputed in backward under ``rt.remat``."""
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames + L.sinusoidal_at(pos, cfg.d_model).to(frames.dtype)[None]

    def layer(lp):
        def fn(x):
            B, S = x.shape[:2]
            p = _fetch(rt, lp)
            q, k, v = _qkv(p, cfg, x, None)
            a = ops.attention_fwd(q, k, v, causal=False, kernels=rt.kernels)
            return _block_tail(p, cfg,
                               x + L.dense(a.reshape(B, S, cfg.q_dim),
                                           p["attn"]["wo"]), rt)
        return fn
    for lp in params["enc"]:
        x = _remat(rt.remat, layer(lp), x)
    return L.rms_norm(x, _fetch(rt, params["enc_norm"]), cfg.norm_eps)


def make_cross_kv(cfg, params, enc_out, rt: Runtime = DEFAULT_RT):
    """The decoder's cross-attention K/V of encoder states [B, T, D]:
    (cross_k, cross_v), each [L, B, T, KVH, D]."""
    B = enc_out.shape[0]
    shape = (B, -1, cfg.n_kv_heads, cfg.d_head)
    ks, vs = [], []
    for lp in params["dec"]:
        x = _fetch(rt, lp)["xattn"]
        ks.append(L.dense(enc_out, x["wk"]).reshape(shape))
        vs.append(L.dense(enc_out, x["wv"]).reshape(shape))
    return torch.stack(ks), torch.stack(vs)


def stub_frames(cfg, batch: int, device) -> torch.Tensor:
    """The serving path's stub audio frames: zeros [batch, enc_seq, D]."""
    return torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                       dtype=torch.float32, device=device)


def _keep_rows(new, old, run):
    """Advance recurrent state only for running slots: rows [B, ...] with
    ``run=False`` keep their previous carry."""
    if run is None:
        return new
    return torch.where(run.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def _stacked_layers(stack) -> list[dict]:
    """Per-layer views of stacked ``[L, ...]`` weight leaves (an int8
    QTensor's ``q`` and ``s`` alike); a list of layers as it is."""
    if isinstance(stack, list):
        return stack
    n = _first_leaf(stack).shape[0]
    return [tree_map(lambda a: a[i], stack) for i in range(n)]


def _layer_rows(rows, i):
    """Layer ``i``'s rows (views) of a stacked ``[L, B, ...]`` carry."""
    return tree_map(lambda a: a[i], rows)


def _put_layer_rows(rows, i, new, run=None) -> None:
    """Write layer ``i``'s new carry into the stacked rows in place (rows
    with ``run=False`` keep their carry)."""
    tree_map(lambda dst, src: dst.copy_(_keep_rows(src, dst, run)),
             _layer_rows(rows, i), new)


def _hybrid_stack(cfg, params, state, x, mamba, attn, run=None):
    """The zamba2 stack: per cycle, the cycle's Mamba2 layers (``mamba(lp,
    x, rows) -> (y, new_rows)``, residual) then the shared attention block
    on pool layer ``c`` (``attn(lp, x, c) -> x``)."""
    n_cyc, per_cyc = _hybrid_cycles(cfg)
    layers = _stacked_layers(params["mamba"])
    mst = state["mamba"]
    for c in range(n_cyc):
        for i in range(c * per_cyc, (c + 1) * per_cyc):
            y, new = mamba(layers[i], x, _layer_rows(mst, i))
            x = x + y
            _put_layer_rows(mst, i, new, run)
        x = attn(params["attn_shared"], x, c)
    return x


def _xlstm_stack(cfg, params, state, x, mlstm, slstm, run=None):
    """The xLSTM stack: per cycle ``c``, an mLSTM block then an sLSTM block
    (``fn(lp, x, rows) -> (y, new_rows)``, each residual) on rows ``c`` of
    the ``mlstm`` / ``slstm`` carries, written back in place."""
    for c, (lm, ls) in enumerate(zip(_stacked_layers(params["mlstm"]),
                                     _stacked_layers(params["slstm"]))):
        for fn, lp, key in ((mlstm, lm, "mlstm"), (slstm, ls, "slstm")):
            y, new = fn(lp, x, _layer_rows(state[key], c))
            x = x + y
            _put_layer_rows(state[key], c, new, run)
    return x


def _embed(cfg, table, tokens, rt: Runtime = DEFAULT_RT):
    """Token embeddings [.., D]; a TP shard's table holds a block of D:
    its columns are looked up, then all-gathered."""
    x = L.embed(table, tokens)
    if x.shape[-1] < cfg.d_model:
        x = M.all_gather(x, rt.tp_axis, dim=-1, tiled=True)
    return x


def _logits(cfg, params, x, rt: Runtime = DEFAULT_RT):
    """fp32 logits over the padded vocabulary; on a TP shard whose untied
    head holds a block of the vocabulary, that block's."""
    x = L.rms_norm(x, _fetch(rt, params["final_norm"]), cfg.norm_eps)
    if not cfg.tie_embeddings:
        return L.lm_head(x, L.own_cols(_fetch(rt, params["head"]),
                                       rt.tp_axis), transpose=False)
    w = _fetch(rt, params["embed"])
    n = w.shape[-1]
    if n == cfg.d_model:
        return L.lm_head(x, w, transpose=True)
    x = x.narrow(-1, M.axis_index(rt.tp_axis) * n, n)  # row-parallel over D
    return M.psum(L.lm_head(x, w, transpose=True), rt.tp_axis)


def _qkv(lp, cfg, x, cs, tp=None):
    """Attention prologue: pre-norm, q/k/v projections (whole on a TP
    shard, ``tp``), rope."""
    q, k, v = L.qkv_project(lp["attn"], cfg,
                            L.rms_norm(x, lp["ln1"], cfg.norm_eps), tp)
    if cs is not None:
        q = L.apply_rope(q, *cs)
        k = L.apply_rope(k, *cs)
    return q, k, v


def _cross_attn(lp, cfg, h, cross, rt: Runtime):
    """An enc-dec block's cross-attention over ``cross`` = (k, v, ctx):
    rows [B, T, KVH, D] and T on every row [B], residual: h [B, S, D] at
    prefill (non-causal flash attention), [B, D] at decode
    (``ops.cross_attention_decode``)."""
    hx = L.rms_norm(h, lp["lnx"], cfg.norm_eps)
    qx = L.dense_col(hx, lp["xattn"]["wq"], cfg.q_dim, rt.tp_axis)
    if h.dim() == 2:
        B = h.shape[0]
        ax = ops.cross_attention_decode(
            qx.reshape(B, cfg.n_heads, cfg.d_head), *cross,
            kernels=rt.kernels)
    else:
        B, S = h.shape[:2]
        ax = ops.attention_fwd(qx.reshape(B, S, cfg.n_heads, cfg.d_head),
                               cross[0], cross[1], causal=False,
                               kernels=rt.kernels)
    return h + L.dense_row(ax.reshape(*h.shape[:-1], cfg.q_dim),
                           lp["xattn"]["wo"], cfg.q_dim, rt.tp_axis)


def _block_tail(lp, cfg, h, rt: Runtime = DEFAULT_RT, *,
                with_aux: bool = False):
    """FFN epilogue of an attention block (prefill, decode, verify and the
    full-sequence forward): the MLP, or the routed experts over every row
    of ``h`` [B, S, D]. ``with_aux`` returns ``(h, aux)``, the MoE's
    load-balancing term (0 without experts)."""
    aux = 0.0
    if "ln2" in lp:
        h2 = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
        if "moe" in lp:
            y = rt.moe_apply(lp["moe"], cfg, h2, with_aux=with_aux)
            if with_aux:
                y, aux = y
        else:
            y = L.mlp(lp["mlp"], h2, cfg.act, cfg.d_ff, rt.tp_axis)
        h = h + y
    return (h, aux) if with_aux else h


# ---------------------------------------------------------------------------
# decode (single token, paged KV via ITPP)
# ---------------------------------------------------------------------------

def _attn_block_decode(lp, cfg, x, cs, window, pool_k, pool_v, bt, ctx,
                       npage, noff, rt: Runtime, cross=None):
    """x [B, D] one token; writes pool_k/pool_v in place. ``cross``: the
    layer's (k, v) cross rows (enc-dec) or None."""
    B = x.shape[0]
    q, k, v = _qkv(lp, cfg, x[:, None, :], cs, rt.tp_axis)   # [B,1,H,dh]
    a, _, _ = rt.itpp_apply(q[:, 0], k[:, 0], v[:, 0], pool_k, pool_v, bt,
                            ctx, npage, noff, window)
    x = x + L.dense_row(a.reshape(B, cfg.q_dim), lp["attn"]["wo"],
                        cfg.q_dim, rt.tp_axis)
    if cross is not None:
        x = _cross_attn(lp, cfg, x, cross, rt)
    return _block_tail(lp, cfg, x[:, None, :], rt)[:, 0]


def _decoder(cfg, params, state):
    """The attention stack's layers, each with its window and (enc-dec)
    its cross rows and their length, made once for every layer:
    [(lp, window, (k, v, ctx) or None)]."""
    if cfg.family == "encdec":
        ck, cv = state["cross_k"], state["cross_v"]
        full = torch.full((ck.shape[1],), ck.shape[2], dtype=torch.int32,
                          device=ck.device)
        return [(lp, 0, (ck[i], cv[i], full))
                for i, lp in enumerate(params["dec"])]
    return [(lp, w, None)
            for lp, w in zip(params["layers"], _window_array(cfg))]


def decode_step(cfg, params, state, tokens, bt, ctx, npage, noff, *,
                positions=None, run=None, rt: Runtime = DEFAULT_RT):
    """One decode step for the whole batch.

    tokens [B]; bt [B, maxp]; ctx [B] (INCLUDING the new token);
    npage/noff [B] write target for the new token's KV (``n_pages`` =
    the trash page, for slots not decoding). ``rt.tp_axis`` runs it as a
    Megatron TP shard body (``distributed/sharding.make_decode_step``).
    ``run`` [B] bool: slots decoding this step — recurrent rows of the
    others keep their carry (an idle, paused or mid-chunk-prefill slot
    must not absorb its stale pending token); None advances every row.
    ``positions``: rope ids [B, 1]
    or M-RoPE ids [3, B, 1]; None = ctx - 1 (on all three axes), computed
    on the device, as the enc-dec family's sinusoidal position is, so a
    captured horizon reads only its static ``ctx``. Returns (fp32 logits
    [B, V], state) — the state's pool and rows are written in place.
    """
    x = _embed(cfg, params["embed"], tokens, rt)        # [B, D]
    if cfg.family == "encdec":
        x = x + L.sinusoidal_at(ctx - 1, cfg.d_model).to(x.dtype)
    if "mlstm" in params:
        def mlstm(lp, h, rows):
            return SSM.mlstm_step(lp, cfg, h, rows, tp=rt.tp_axis)

        def slstm(lp, h, rows):
            return SSM.slstm_step(lp, cfg, h, rows)
        x = _xlstm_stack(cfg, params, state, x, mlstm, slstm, run)
        return _logits(cfg, params, x, rt), state
    cs = _cos_sin(cfg, (ctx.long() - 1)[:, None] if positions is None
                  else positions)
    pool = state["pool"]
    if "mamba" in params:
        def mamba(lp, h, rows):
            return SSM.mamba_step(lp, cfg, h, rows, kernels=rt.kernels,
                                  tp=rt.tp_axis)

        def attn(lp, h, c):
            return _attn_block_decode(lp, cfg, h, cs, 0, pool["k"][c],
                                      pool["v"][c], bt, ctx, npage, noff, rt)
        x = _hybrid_stack(cfg, params, state, x, mamba, attn, run)
        return _logits(cfg, params, x, rt), state
    for i, (lp, w, cross) in enumerate(_decoder(cfg, params, state)):
        x = _attn_block_decode(lp, cfg, x, cs, w, pool["k"][i], pool["v"][i],
                               bt, ctx, npage, noff, rt, cross)
    return _logits(cfg, params, x, rt), state


def decode_multi(cfg, params, state, tokens, bt, ctx, rem, allow, gen=None,
                 *, horizon: int, table_width: int, page_size: int,
                 n_pages: int, eos_token: int, sample,
                 rt: Runtime = DEFAULT_RT):
    """Fused multi-step decode: ``horizon`` decode steps with on-device
    sampling and per-slot EOS/budget masking, no host sync inside.

    Device-resident slot state (all [B] unless noted): tokens — incoming
    token per slot; bt — [B, W] Va2Pa table (attention reads the leading
    ``table_width`` slots, write targets resolve against the full width);
    ctx — context INCLUDING the incoming token; rem — tokens the slot may
    still emit; allow — steps the slot may run this horizon (0 = idle).
    ``sample``: ``(gen, logits [B, V]) -> tokens [B]`` on device
    (``serving.sampling.make_scan_sampler``); ``gen`` is the sampler's
    ``torch.Generator`` (JAX's key chain; greedy ignores it), advanced in
    place by every step's draw. A sampler with ``takes_run`` (the legacy
    host callable, ``serving.sampling.make_callback_sampler``) also gets
    the step's ``run`` mask.

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
        nxt = (sample(gen, logits, run) if getattr(sample, "takes_run", False)
               else sample(gen, logits))
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
# speculative decode: the draft's proposal scan and the one-pass verify
# ---------------------------------------------------------------------------

def draft_propose(cfg, params, state, tokens, bt, ctx, allow, gen, *,
                  horizon: int, table_width: int, page_size: int,
                  n_pages: int, sample, need_q: bool,
                  rt: Runtime = DEFAULT_RT):
    """Draft side of a speculative round: up to ``horizon`` masked decode
    steps proposing the next tokens of every slot at once.

    The draft's (smaller) pool is indexed by the TARGET's block tables and
    page ids, so draft KV at a page and offset is a function of the token
    prefix alone. ``tokens``/``ctx`` are the target's slot state (ctx
    INCLUDING the pending token, whose draft KV step 0 writes at ctx-1);
    they are read, never written. Step ``i`` runs where ``i < clip(allow-1,
    0, horizon)``: a slot reserved for one token proposes nothing.
    ``sample`` is the engine's scan sampler, so the proposals follow the q
    the verifier assumes; ``need_q`` stacks the raw logits for residual
    rejection sampling (stochastic kinds). Returns ``(proposals [B,
    horizon] int32, qlogits [horizon, B, V] | None, state)``; entries of
    masked steps are garbage the verifier never accepts."""
    from repro_torch.kernels.ops import write_targets
    W = bt.shape[1]
    bt_attn = bt[:, :table_width] if table_width < W else bt
    nprop = (allow - 1).clamp(0, horizon)
    toks, qs = [], []
    for i in range(horizon):
        run = nprop > i
        npage, noff = write_targets(bt, ctx, run, page_size=page_size,
                                    n_pages=n_pages, ring_width=rt.ring_width)
        logits, state = decode_step(cfg, params, state, tokens, bt_attn,
                                    ctx, npage, noff, run=run, rt=rt)
        nxt = sample(gen, logits)
        tokens = torch.where(run, nxt, tokens)
        ctx = torch.where(run, ctx + 1, ctx)
        toks.append(nxt)
        qs.append(logits)
    B = tokens.shape[0]
    proposals = (torch.stack(toks, dim=1) if toks else torch.zeros(
        (B, 0), dtype=torch.int32, device=tokens.device))
    qlogits = None
    if need_q:
        qlogits = (torch.stack(qs) if qs else torch.zeros(
            (0, B, cfg.padded_vocab), dtype=torch.float32,
            device=tokens.device))
    return proposals, qlogits, state


def decode_verify(cfg, params, state, tokens, proposals, qlogits, bt, ctx,
                  rem, allow, gen, *, horizon: int, table_width: int,
                  page_size: int, n_pages: int, eos_token: int, verifier,
                  rt: Runtime = DEFAULT_RT):
    """One-pass speculative verify: the pending token and the draft's
    ``horizon`` proposals in ONE multi-query target forward, a prefix
    accepted, and the slot state advanced as ``decode_multi`` would have.

    The round forwards ``[pending, d_1..d_G]`` at positions ctx-1..ctx+G-1
    (attention-only stacks: a recurrent carry cannot roll back). Each
    layer writes the rows' K/V with ``write_prefill(ctx_start=ctx-1,
    valid_len=nprop+1)`` (idle and frozen slots: valid_len 0, the trash
    page), then ``kernels.ops.verify_attention`` scores the G+1 query rows
    against the paged pool in one split-K pass, row t masked to tok <
    ctx+t. Rollback is free: KV of rejected positions lies past the new
    ctx (masked) and the next round's writes start at the new ctx-1.

    ``verifier`` (``serving.sampling.make_verifier``) gives ``(candidates
    [B, G+1], accept_len [B])``; the emitted run is ``candidates[:e]``,
    ``e = accept_len + 1`` cut at the first EOS or budget stop, which
    freezes the slot as ``decode_multi`` does. Returns ``(toks [G+1, B],
    emit [G+1, B] bool, finished [B], state, tokens, ctx, rem, accept_len
    [B])``."""
    from repro_torch.core.paged_kv import write_prefill
    B = tokens.shape[0]
    C = horizon + 1
    dev = tokens.device
    run = allow > 0
    nprop = (allow - 1).clamp(0, horizon)
    seq = torch.cat([tokens[:, None], proposals.to(tokens.dtype)], dim=1)
    start = (ctx - 1).clamp_min(0)
    valid_len = torch.where(run, nprop + 1, 0)
    W = bt.shape[1]
    bt_attn = bt[:, :table_width] if table_width < W else bt
    x = L.embed(params["embed"], seq)                      # [B, C, D]
    cs = _cos_sin(cfg, start.long()[:, None]
                  + torch.arange(C, device=dev)[None])
    pool = state["pool"]
    grp = cfg.n_heads // cfg.n_kv_heads
    for i, (lp, w) in enumerate(zip(params["layers"], _window_array(cfg))):
        q, k, v = _qkv(lp, cfg, x, cs)                     # [B, C, H, dh]
        write_prefill(pool["k"][i], pool["v"][i], k, v, bt, ctx_start=start,
                      valid_len=valid_len)
        qr = q.transpose(1, 2).reshape(B, cfg.n_kv_heads, grp, C,
                                       cfg.d_head)
        a = ops.verify_attention(qr.contiguous(), pool["k"][i],
                                 pool["v"][i], bt_attn, ctx, window=w,
                                 kernels=rt.kernels)
        a = a.permute(0, 3, 1, 2, 4).reshape(B, C, cfg.q_dim)
        x = _block_tail(lp, cfg, x + L.dense(a, lp["attn"]["wo"]), rt)
    logits = _logits(cfg, params, x)                       # [B, C, V]

    cand, acc = verifier(gen, logits, qlogits, proposals, nprop, run)
    # EOS / budget truncation over the accepted run, as the fused scan's
    # per-step freeze: candidate j is EOS or spends the budget -> emit
    # exactly j+1 tokens and finish without advancing past them
    idx = torch.arange(C, device=dev)
    stop = (cand == eos_token) | (rem[:, None] - (idx + 1)[None] <= 0)
    stopped = (idx[None] <= acc[:, None]) & stop & run[:, None]
    any_stop = stopped.any(dim=1)
    first = torch.argmax(stopped.to(torch.int32), dim=1)
    e = torch.where(any_stop, first + 1, acc + 1)
    e = torch.where(run, e, 0).to(torch.int32)
    emit = idx[None] < e[:, None]                          # [B, C]
    fin = run & any_stop
    newtok = cand[torch.arange(B, device=dev), (e - 1).clamp_min(0).long()]
    tokens = torch.where(run, newtok, tokens)
    rem = torch.where(run, rem - e, rem)
    ctx = torch.where(run, ctx + e - fin.to(torch.int32), ctx)
    return (cand.T, emit.T, fin, state, tokens, ctx, rem,
            torch.where(run, acc, 0).to(torch.int32))


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also fills the paged pool
# ---------------------------------------------------------------------------

def _last_rows(x, last_idx):
    if last_idx is None:
        return x[:, -1]
    idx = torch.as_tensor(last_idx, device=x.device).long()
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _attn_block_prefill(lp, cfg, x, cs, w, pk, pv, bt, valid_len,
                        rt: Runtime, cross=None):
    """A whole-prompt attention block: writes the prompt's K/V pages
    (``valid_len`` keeps pad positions out; a ring pool takes only the
    last ``ring_width * page`` tokens, the ones it can hold, and ignores
    ``valid_len``), attends causally, then (enc-dec) to ``cross``."""
    from repro_torch.core.paged_kv import write_prefill
    lp = _fetch(rt, lp)
    B, S = x.shape[:2]
    q, k, v = _qkv(lp, cfg, x, cs)
    off = _seq_offset(rt, S)
    if rt.seq_axis is not None:     # the whole rows' K/V: the shard writes
        k = M.all_gather(k, rt.seq_axis, dim=1, tiled=True)   # its pages
        v = M.all_gather(v, rt.seq_axis, dim=1, tiled=True)
        S = k.shape[1]
    if rt.write_pool is not None:
        rt.write_pool(pk, pv, k, v, bt, valid_len)
    elif rt.ring_width:
        span = min(rt.ring_width * pk.shape[1], S)
        write_prefill(pk, pv, k[:, S - span:], v[:, S - span:], bt,
                      ctx_start=S - span, ring_width=rt.ring_width)
    else:
        write_prefill(pk, pv, k, v, bt, valid_len=valid_len)
    a = ops.attention_fwd(q, k, v, causal=True, window=w, q_offset=off,
                          kernels=rt.kernels)
    S = x.shape[1]
    x = x + L.dense(a.reshape(B, S, cfg.q_dim), lp["attn"]["wo"])
    if cross is not None:
        x = _cross_attn(lp, cfg, x, cross, rt)
    return _block_tail(lp, cfg, x, rt)


def _attn_block_chunk(lp, cfg, x, cs, w, pk, pv, bt, start, valid_len,
                      rt: Runtime, cross=None):
    """A chunk's attention block: writes the chunk's K/V at ``start``,
    gathers the pages and attends with ``q_offset=start``, then (enc-dec)
    to ``cross``."""
    from repro_torch.core.paged_kv import gather_kv, write_prefill
    B, C = x.shape[:2]
    q, k, v = _qkv(lp, cfg, x, cs)
    pk, pv = write_prefill(pk, pv, k, v, bt, ctx_start=start,
                           valid_len=valid_len)
    kf, vf = gather_kv(pk, pv, bt)             # [B, maxp*page, KVH, D]
    a = ops.attention_fwd(q, kf, vf, causal=True, window=w, q_offset=start,
                          kernels=rt.kernels)
    x = x + L.dense(a.reshape(B, C, cfg.q_dim), lp["attn"]["wo"])
    if cross is not None:
        x = _cross_attn(lp, cfg, x, cross, rt)
    return _block_tail(lp, cfg, x, rt)


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
        return _seq_whole(rt, lambda g: SSM.mamba_forward(
            _fetch(rt, lp), cfg, g, state=rows, chunk=rt.gla_chunk,
            mask=mask, kernels=rt.kernels), h, carry=True)
    return mamba


def _xlstm_prefill(cfg, params, state, x, rt: Runtime, mask):
    """The xLSTM stack over a prompt or a chunk (JAX's
    ``_xlstm_prefill_body``), shared by ``prefill`` and ``prefill_chunk``:
    the rows of ``state`` hold the carry in and the carry out."""
    def mlstm(lp, h, rows):
        return _seq_whole(rt, lambda g: SSM.mlstm_forward(
            _fetch(rt, lp), cfg, g, state=rows, chunk=rt.gla_chunk,
            mask=mask), h, carry=True)

    def slstm(lp, h, rows):
        return _seq_whole(rt, lambda g: SSM.slstm_forward(
            _fetch(rt, lp), cfg, g, state=rows, mask=mask), h, carry=True)
    return _xlstm_stack(cfg, params, state, x, mlstm, slstm)


def prefill(cfg, params, state, tokens, bt, *, positions=None,
            extra_embeds=None, frames=None, last_idx=None, valid_len=None,
            rt: Runtime = DEFAULT_RT):
    """Run the prompt through the model, writing its KV pages and
    (recurrent families) the recurrent rows of ``state``, which hold the
    rows' carry in.

    tokens [B, S] (padded to a shared S); ``last_idx`` [B] picks each
    request's true last position for the logits and ``valid_len`` [B]
    keeps pad positions out of the pool and the recurrent carry.
    ``positions``: rope ids [B, S] or M-RoPE ids [3, B, S] (default
    ``default_positions``); ``extra_embeds`` [B, S, D] are added to the
    token embeddings (the VLM's stub vision tower); ``frames`` [B, enc_seq,
    D] feed the enc-dec encoder, whose cross K/V rows are written into
    ``state``'s ``cross_k`` / ``cross_v`` in place. Returns (fp32 logits of
    the last position [B, V], state)."""
    B, S = tokens.shape
    x = L.embed(_fetch(rt, params["embed"]), tokens)
    if extra_embeds is not None:
        x = x + extra_embeds.to(x.dtype)
    off = _seq_offset(rt, S)
    # the recurrent layers' mask covers the whole rows (gathered in sp)
    S_all = S if rt.seq_axis is None else S * M.axis_size(rt.seq_axis)
    if "mlstm" in params:
        x = _xlstm_prefill(cfg, params, state, x, rt,
                           _prefill_mask(valid_len, S_all, x.device))
        return _logits(cfg, params, _last_hidden(rt, x, last_idx), rt), state
    if cfg.family == "encdec":
        pos = torch.arange(off, off + S, device=x.device)
        x = x + L.sinusoidal_at(pos, cfg.d_model).to(x.dtype)[None]
        if frames is None:
            raise ValueError(f"{cfg.name}: an enc-dec prefill needs "
                             "frames [B, enc_seq, D]")
        ck, cv = make_cross_kv(cfg, params, encode(cfg, params, frames, rt),
                               rt)
        if "cross_k" in state:          # the engine's rows, in place
            state["cross_k"].copy_(ck)
            state["cross_v"].copy_(cv)
        else:
            state["cross_k"], state["cross_v"] = ck, cv
    if positions is None:
        positions = default_positions(cfg, B, S, device=x.device) + off
    cs = _cos_sin(cfg, positions)
    pool = state["pool"]
    if "mamba" in params:
        def attn(lp, h, c):
            return _attn_block_prefill(lp, cfg, h, cs, 0, pool["k"][c],
                                       pool["v"][c], bt, valid_len, rt)
        x = _hybrid_stack(cfg, params, state, x, _mamba_prefill(
            cfg, rt, _prefill_mask(valid_len, S_all, x.device)), attn)
    else:
        for i, (lp, w, cross) in enumerate(_decoder(cfg, params, state)):
            x = _attn_block_prefill(lp, cfg, x, cs, w, pool["k"][i],
                                    pool["v"][i], bt, valid_len, rt, cross)
    return _logits(cfg, params, _last_hidden(rt, x, last_idx), rt), state


def prefill_chunk(cfg, params, state, tokens, bt, ctx_start, *,
                  last_idx=None, valid_len=None, rt: Runtime = DEFAULT_RT):
    """Chunked prefill continuation — the DCS-style interleave primitive.

    Processes tokens [B, C] at global positions ctx_start..ctx_start+C-1
    against context already held by earlier chunks: attention layers write
    the chunk's K/V (``write_prefill(ctx_start=...)``), gather their pages
    and attend with ``q_offset=ctx_start``; Mamba2 / mLSTM / sLSTM layers
    resume from the per-row carry in ``state`` (the previous chunk's
    returned state); enc-dec decoder chunks attend over the carried
    ``cross_k`` / ``cross_v`` rows (computed once at admission).
    ``ctx_start`` is a scalar or a [B] vector (each request at its own
    depth); ``valid_len`` keeps end-padding out of the pool and the carry.
    Returns (fp32 logits at last_idx (default C-1) [B, V], state)."""
    B, C = tokens.shape
    x = L.embed(params["embed"], tokens)
    if "mlstm" in params:
        x = _xlstm_prefill(cfg, params, state, x, rt,
                           _prefill_mask(valid_len, C, x.device))
        return _logits(cfg, params, _last_rows(x, last_idx)), state
    start = torch.as_tensor(ctx_start, dtype=torch.long, device=x.device)
    offset = start if start.ndim == 0 else start[:, None]
    pos = (torch.arange(C, device=x.device)[None] + offset).expand(B, C)
    if cfg.family == "encdec":
        x = x + L.sinusoidal_at(pos, cfg.d_model).to(x.dtype)
    cs = _cos_sin(cfg, pos)
    pool = state["pool"]
    if "mamba" in params:
        def attn(lp, h, c):
            return _attn_block_chunk(lp, cfg, h, cs, 0, pool["k"][c],
                                     pool["v"][c], bt, start, valid_len, rt)
        x = _hybrid_stack(cfg, params, state, x, _mamba_prefill(
            cfg, rt, _prefill_mask(valid_len, C, x.device)), attn)
    else:
        for i, (lp, w, cross) in enumerate(_decoder(cfg, params, state)):
            x = _attn_block_chunk(lp, cfg, x, cs, w, pool["k"][i],
                                  pool["v"][i], bt, start, valid_len, rt,
                                  cross)
    return _logits(cfg, params, _last_rows(x, last_idx)), state


# ---------------------------------------------------------------------------
# full-sequence forward and the training loss
# ---------------------------------------------------------------------------

def check_trainable(rt: Runtime, what: str) -> None:
    """Raise unless ``rt`` keeps the plain paths: no kernel of the port has
    a backward (repro's training path reaches no Pallas kernel either: it
    runs the jnp ``flash_attention`` and ``chunked_gla``, and autograd
    takes their gradients), so a train step never silently takes the
    plain route in place of a kernel."""
    if rt.kernels is not None and rt.kernels.enabled:
        raise ValueError(
            f"{what}: the port's kernels (K1-K4) have no backward; train "
            "with Runtime(kernels=None) or "
            "KernelConfig(use_kernels=False), the plain paths repro "
            "trains on")


def _remat(on: bool, fn, x):
    """``fn(x)``, recomputed in backward when ``on`` (JAX's
    ``jax.checkpoint`` around a scan body)."""
    if on and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def _attn_block_train(lp, cfg, x, cs, window, rt: Runtime, *,
                      causal: bool = True, enc_out=None):
    """A whole-sequence attention block (repro's ``_attn_mlp_block``):
    self-attention, (enc-dec) cross-attention to ``enc_out`` [B, T, D],
    the FFN. Builds no pool. Returns ``(x, aux)``, aux the MoE's
    load-balancing term (0 without experts)."""
    B, S = x.shape[:2]
    q, k, v = _qkv(lp, cfg, x, cs)
    if rt.seq_axis is not None:
        k = M.all_gather(k, rt.seq_axis, dim=1, tiled=True)
        v = M.all_gather(v, rt.seq_axis, dim=1, tiled=True)
    a = ops.attention_fwd(q, k, v, causal=causal, window=window,
                          q_offset=_seq_offset(rt, S), kernels=rt.kernels)
    x = x + L.dense(a.reshape(B, S, cfg.q_dim), lp["attn"]["wo"])
    if enc_out is not None:
        shape = (B, -1, cfg.n_kv_heads, cfg.d_head)
        cross = (L.dense(enc_out, lp["xattn"]["wk"]).reshape(shape),
                 L.dense(enc_out, lp["xattn"]["wv"]).reshape(shape))
        x = _cross_attn(lp, cfg, x, cross, rt)
    x, aux = _block_tail(lp, cfg, x, rt, with_aux=True)
    if not torch.is_tensor(aux):
        aux = x.new_zeros((), dtype=torch.float32)
    return x, aux


def forward_hidden(cfg, params, tokens, *, positions=None, extra_embeds=None,
                   frames=None, rt: Runtime = DEFAULT_RT):
    """Full-sequence forward -> (final hidden [B, S, D], MoE aux).

    The training path (repro's ``forward_hidden``): no pool, no recurrent
    rows; each layer recomputed in backward under ``rt.remat`` (a whole
    mLSTM + sLSTM cycle for xLSTM, each Mamba2 layer for the hybrid, whose
    shared attention blocks are not recomputed, as in JAX). Windows come
    per layer from ``_window_array``. ``positions``: rope ids [B, S] or
    M-RoPE ids [3, B, S]; ``extra_embeds`` [B, S, D] add to the token
    embeddings; ``frames`` [B, enc_seq, D] feed the enc-dec encoder.

    Attention goes through ``ops.attention_fwd`` and the Mamba2 scan
    through ``ops.mamba_mixer`` with ``rt.kernels``: the plain versions
    on the training path (``check_trainable``), where no kernel launches.
    """
    _check_family(cfg)
    emb = _fetch(rt, params["embed"])
    if torch.is_grad_enabled() and emb.requires_grad:
        check_trainable(rt, "forward_hidden")
    B, S = tokens.shape
    x = L.embed(emb, tokens)
    del emb
    if extra_embeds is not None:
        x = x + extra_embeds.to(x.dtype)
    dev = x.device
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if "mlstm" in params:
        def cycle(lm, ls):
            def fn(h):
                pm, ps = _fetch(rt, lm), _fetch(rt, ls)
                h = h + _seq_whole(rt, lambda g: SSM.mlstm_forward(
                    pm, cfg, g, chunk=rt.gla_chunk)[0], h)
                return h + _seq_whole(
                    rt, lambda g: SSM.slstm_forward(ps, cfg, g)[0], h)
            return fn
        for lm, ls in zip(_stacked_layers(params["mlstm"]),
                          _stacked_layers(params["slstm"])):
            x = _remat(rt.remat, cycle(lm, ls), x)
        return L.rms_norm(x, _fetch(rt, params["final_norm"]),
                          cfg.norm_eps), aux
    off = _seq_offset(rt, S)
    if cfg.family == "encdec":
        x = x + L.sinusoidal_at(torch.arange(off, off + S, device=dev),
                                cfg.d_model).to(x.dtype)[None]
    if positions is None:
        positions = default_positions(cfg, B, S, device=dev) + off
    cs = _cos_sin(cfg, positions)

    def attn(lp, w, enc_out=None):
        return lambda h: _attn_block_train(_fetch(rt, lp), cfg, h, cs, w,
                                           rt, enc_out=enc_out)
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError(f"{cfg.name}: an enc-dec forward needs frames "
                             "[B, enc_seq, D]")
        enc_out = encode(cfg, params, frames, rt)
        for lp in params["dec"]:
            x, a = _remat(rt.remat, attn(lp, 0, enc_out), x)
            aux = aux + a
    elif "mamba" in params:
        n_cyc, per_cyc = _hybrid_cycles(cfg)
        layers = _stacked_layers(params["mamba"])

        def mamba(lp):
            return lambda h: h + _seq_whole(rt, lambda g: SSM.mamba_forward(
                _fetch(rt, lp), cfg, g, chunk=rt.gla_chunk,
                kernels=rt.kernels)[0], h)
        for c in range(n_cyc):
            for lp in layers[c * per_cyc:(c + 1) * per_cyc]:
                x = _remat(rt.remat, mamba(lp), x)
            x, a = attn(params["attn_shared"], 0)(x)
            aux = aux + a
    else:
        for lp, w in zip(params["layers"], _window_array(cfg)):
            x, a = _remat(rt.remat, attn(lp, w), x)
            aux = aux + a
    return L.rms_norm(x, _fetch(rt, params["final_norm"]), cfg.norm_eps), aux


def forward(cfg, params, tokens, *, positions=None, extra_embeds=None,
            frames=None, rt: Runtime = DEFAULT_RT):
    """Full-sequence forward -> (fp32 logits [B, S, padded_vocab], aux)."""
    x, aux = forward_hidden(cfg, params, tokens, positions=positions,
                            extra_embeds=extra_embeds, frames=frames, rt=rt)
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    return L.lm_head(x, w, transpose=cfg.tie_embeddings), aux


def train_loss(cfg, params, batch, rt: Runtime = DEFAULT_RT, *,
               loss_chunk: int = 1024):
    """batch: ``tokens`` / ``targets`` [B, S], ``mask`` [B, S] (and the
    optional ``positions``, ``extra_embeds``, ``frames``); returns (loss,
    metrics): ``nll_sum``'s sum over the mask's tokens; a MoE adds ``0.01
    * aux / n_layers``. Raises on a ``Runtime`` with kernels
    (``check_trainable``)."""
    nll, aux, count = nll_sum(cfg, params, batch, rt, loss_chunk=loss_chunk)
    loss = nll / count.clamp_min(1.0)
    if cfg.is_moe:
        loss = loss + 0.01 * aux / max(1, cfg.n_layers)
    return loss, {"nll": loss, "tokens": count}


def nll_sum(cfg, params, batch, rt: Runtime = DEFAULT_RT, *,
            loss_chunk: int = 1024):
    """(summed masked cross-entropy, MoE aux, mask sum) of ``batch``.

    Cross-entropy in sequence chunks of ``loss_chunk`` (the whole sequence
    when that does not divide S, as in repro), each chunk's logits
    recomputed in backward, so the [B, S, V] logits never exist at once.
    A sharded train step divides the sum by the mesh's token count."""
    check_trainable(rt, "train_loss")
    hidden, aux = forward_hidden(cfg, params, batch["tokens"],
                                 positions=batch.get("positions"),
                                 extra_embeds=batch.get("extra_embeds"),
                                 frames=batch.get("frames"), rt=rt)
    w = _fetch(rt, params["embed"] if cfg.tie_embeddings
               else params["head"])
    tgt = batch["targets"].long()
    mask = batch["mask"].float()
    S = tgt.shape[1]
    c = min(loss_chunk, S)
    if S % c:
        c = S

    def chunk_nll(i):
        def fn(h_c):
            logits = L.lm_head(h_c, w, transpose=cfg.tie_embeddings)
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(-1, tgt[:, i:i + c, None])[..., 0]
            return ((lse - picked) * mask[:, i:i + c]).sum()
        return fn
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, c):
        nll = nll + _remat(True, chunk_nll(i), hidden[:, i:i + c])
    return nll, aux, mask.sum()
