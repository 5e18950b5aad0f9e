"""State-space and recurrent blocks: the chunkwise gated-linear-attention
engine, Mamba2 and xLSTM (mLSTM + sLSTM).

Port of ``repro/models/ssm.py``. Mamba2 and mLSTM are gated linear
attention: the state ``h_t = a_t h_{t-1} + g_t k_t v_t^T`` is computed
chunkwise in parallel (``chunked_gla``: attention-like products inside a
chunk, the state handed across chunks); ``gla_step`` is the exact
single-step recurrence. Mamba2's scan runs through ``kernels/ops.mamba_mixer``,
so on the card it is the hand-written chunk-scan kernel
(``kernels/ssm_scan.py``); decode is the same scan at ``S = 1``. The mLSTM
runs on the plain ``chunked_gla(normalize=True)`` (its exponential input
gate needs the normaliser ``n`` and stabiliser ``m``), as in JAX, at
``scan_geometry``'s chunk. The sLSTM mixes its memory through recurrent
weights, so it is sequential by construction: a Python loop of cell steps
over time (JAX's ``lax.scan``).

State of one Mamba2 layer, as in JAX: ``{"conv": [B, K-1, C], "ssm":
(C [B, nh, N, P], n [B, nh, N], m [B, nh])}``. ``n`` is accumulated but never
read by Mamba2 and ``m`` stays at its seed; both are carried so the state
equals the JAX state leaf for leaf. An mLSTM layer carries ``(C [B, H, dh,
dh], n [B, H, dh], m [B, H])`` with ``m`` seeded at ``NEG_INF``; an sLSTM
layer ``(c, n, m, h)``, each ``[B, D]``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (NEG_INF, dense, dense_col, dense_row,
                                       rms_norm)

F32 = torch.float32


# ---------------------------------------------------------------------------
# shared chunkwise gated linear attention
# ---------------------------------------------------------------------------

def chunked_gla(q, k, v, log_a, log_g, *, chunk: int = 128,
                normalize: bool = False, state=None):
    """Chunkwise-parallel gated linear attention.

    q, k [B, S, H, dk]; v [B, S, H, dv]; log_a [B, S, H] log-decay applied
    to the previous state at each step; log_g [B, S, H] log input gain.
    h_t = exp(log_a_t) h_{t-1} + exp(log_g_t) k_t v_t^T;  y_t = h_t^T q_t.

    ``normalize=True`` adds the mLSTM normalizer/stabilizer (n, m) so gains
    may be unbounded (exp input gate). Returns (y [B, S, H, dv] fp32,
    state) where state = (C [B, H, dk, dv], n [B, H, dk], m [B, H]).
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    n_chunks = s // chunk
    dev = q.device

    def r(x):
        return x.reshape(b, n_chunks, chunk, h, *x.shape[3:]).float()

    qc, kc, vc, la, lg = r(q), r(k), r(v), r(log_a), r(log_g)
    bcum = torch.cumsum(la, dim=2)                   # [B, K, c, H] inclusive
    btot = bcum[:, :, -1]                            # [B, K, H]

    if state is None:
        C = torch.zeros((b, h, dk, dv), dtype=F32, device=dev)
        n = torch.zeros((b, h, dk), dtype=F32, device=dev)
        m = torch.full((b, h), NEG_INF if normalize else 0.0, dtype=F32,
                       device=dev)
    else:
        C, n, m = (x.float() for x in state)

    idx = torch.arange(chunk, device=dev)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]   # [1,i,j,1]
    ys = []
    for c in range(n_chunks):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]
        bc, bt, lgb = bcum[:, c], btot[:, c], lg[:, c]
        # log weight of source j at query i: bc_i - bc_j + lg_j
        wlog = bc[:, :, None, :] - bc[:, None, :, :] + lgb[:, None, :, :]
        wlog = torch.where(causal, wlog, torch.full_like(wlog, NEG_INF))
        if normalize:
            m_intra = wlog.amax(dim=2)                              # [B,c,H]
            m_i = torch.maximum(m[:, None, :] + bc, m_intra)
            w_inter = torch.exp(m[:, None, :] + bc - m_i)
            wmat = torch.exp(wlog - m_i[:, :, None, :])
        else:
            m_i = torch.zeros_like(bc)
            w_inter = torch.exp(bc)
            wmat = torch.exp(wlog.clamp(NEG_INF, 60.0))
        scores = torch.einsum("bihd,bjhd->bijh", qb, kb) * wmat
        y_intra = torch.einsum("bijh,bjhv->bihv", scores, vb)
        y_inter = torch.einsum("bihd,bhdv->bihv", qb, C) * w_inter[..., None]
        y = y_intra + y_inter
        if normalize:
            den = scores.sum(dim=2) + torch.einsum(
                "bihd,bhd->bih", qb, n) * w_inter
            y = y / torch.maximum(den.abs(), torch.exp(-m_i))[..., None]
        ys.append(y)
        # ---- state handoff ----
        slog = bt[:, None, :] - bc + lgb                            # [B,c,H]
        if normalize:
            m_new = torch.maximum(m + bt, slog.amax(dim=1))
            sc = torch.exp(slog - m_new[:, None, :])
            carry_scale = torch.exp(m + bt - m_new)
        else:
            m_new = m
            sc = torch.exp(slog.clamp(NEG_INF, 60.0))
            carry_scale = torch.exp(bt)
        ks = kb * sc[..., None]
        C = C * carry_scale[..., None, None] + torch.einsum(
            "bjhd,bjhv->bhdv", ks, vb)
        n = n * carry_scale[..., None] + ks.sum(dim=1)
        m = m_new
    y = torch.stack(ys, dim=1).reshape(b, s, h, dv)
    return y, (C, n, m)


def gla_step(q, k, v, log_a, log_g, state, *, normalize: bool = False):
    """Exact single-step recurrence. q, k [B, H, dk]; v [B, H, dv]; log_a,
    log_g [B, H]; state as in ``chunked_gla``. Returns (y [B, H, dv],
    state)."""
    C, n, m = (x.float() for x in state)
    q, k, v = q.float(), k.float(), v.float()
    la, lg = log_a.float(), log_g.float()
    if normalize:
        m_new = torch.maximum(la + m, lg)
        fa = torch.exp(la + m - m_new)
        gi = torch.exp(lg - m_new)
    else:
        m_new = m
        fa = torch.exp(la)
        gi = torch.exp(lg.clamp(NEG_INF, 60.0))
    C_new = C * fa[..., None, None] + gi[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = n * fa[..., None] + gi[..., None] * k
    y = torch.einsum("bhd,bhdv->bhv", q, C_new)
    if normalize:
        den = torch.einsum("bhd,bhd->bh", q, n_new)
        y = y / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return y, (C_new, n_new, m_new)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def init_mamba(cfg, normal, zeros, dtype, device):
    """One Mamba2 layer's weights with the distributions of
    ``repro.models.ssm.init_mamba``. ``normal(shape, scale)`` and
    ``zeros(n)`` draw from the caller's seeded generator. Separate
    projections (not one fused in_proj), as in JAX."""
    D, di, N, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    conv_ch = di + 2 * N
    return {
        "ln": zeros(D),
        "wz": normal((D, di), 1 / math.sqrt(D)),
        "wx": normal((D, di), 1 / math.sqrt(D)),
        "wbc": normal((D, 2 * N), 1 / math.sqrt(D)),
        "wdt": normal((D, nh), 1 / math.sqrt(D)),
        "conv_w": normal((cfg.ssm_conv, conv_ch), 1 / math.sqrt(cfg.ssm_conv)),
        "conv_b": zeros(conv_ch),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=F32, device=device)),
        "D": torch.ones((nh,), dtype=F32, device=device),
        "dt_bias": torch.full((nh,), -4.6, dtype=F32, device=device),
        "norm": zeros(di),
        "out_proj": normal((di, D), 1 / math.sqrt(di * 2 * cfg.n_layers)),
    }


def _mamba_proj(p, cfg, x, tp=None):
    """Shared in-proj/split. x [B, S, D] -> z, xbc_raw, dt_raw (whole on
    a TP shard, ``tp``)."""
    z = dense_col(x, p["wz"], cfg.d_inner, tp)
    xbc = torch.cat([dense_col(x, p["wx"], cfg.d_inner, tp),
                     dense(x, p["wbc"])], dim=-1)
    dt_raw = dense(x, p["wdt"])
    return z, xbc, dt_raw


def _causal_conv(xbc, w, b):
    """Depthwise causal conv. xbc [B, S, C]; w [K, C]."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i].float()[None, None, :]
              for i in range(k))
    return F.silu(out + b.float()[None, None, :]).to(xbc.dtype)


def _mamba_ssm_inputs(p, cfg, xbc, dt_raw):
    di, N, nh, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, \
        cfg.ssm_head_dim
    xh = xbc[..., :di].reshape(*xbc.shape[:-1], nh, P)
    Bm = xbc[..., di:di + N]
    Cm = xbc[..., di + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    log_a = -torch.exp(p["A_log"]) * dt                 # [.., nh]
    return xh, Bm, Cm, dt, log_a


def mask_log_gates(log_a, log_g, mask):
    """Turn pad positions into identity recurrence steps: decay 1
    (``log_a=0``) and input gain 0 (``log_g=-inf``), so the GLA state passes
    through them unchanged. ``mask`` [B, S] bool (True = real token); the
    per-position outputs at pads are garbage and must not be read."""
    m = mask[..., None]
    return (torch.where(m, log_a, torch.zeros_like(log_a)),
            torch.where(m, log_g, torch.full_like(log_g, NEG_INF)))


def mask_log_gates_tail(log_a, log_g, valid_len):
    """``valid_len`` [B] form of :func:`mask_log_gates` for [B, S, H]
    gates: positions >= valid_len[b] become identity steps."""
    vl = torch.as_tensor(valid_len, device=log_a.device).long()
    live = torch.arange(log_a.shape[1], device=log_a.device)[None] \
        < vl[:, None]
    return mask_log_gates(log_a, log_g, live)


def _masked_tail(full, mask, width: int):
    """Last ``width`` *valid* entries of ``full`` = [carried tail | seq],
    where row b has ``mask[b].sum()`` valid seq positions (end-padding) and
    the carried-tail entries are always valid."""
    carried = full.shape[1] - mask.shape[1]
    vlen = mask.sum(dim=1).long()                               # [B]
    idx = vlen[:, None] + (carried - width) + torch.arange(
        width, device=full.device)[None, :]
    idx = idx.clamp(0, full.shape[1] - 1)
    return torch.gather(full, 1, idx[..., None].expand(-1, -1,
                                                       full.shape[2]))


# The shortest scan chunk a long sequence runs at. A length whose largest
# divisor up to ``chunk`` is shorter (a prime such as 1031 has only 1) is
# padded with identity steps to a multiple of it: at chunk 1 the scan would
# take one token a step (the kernel's step route on the card, a Python loop
# over the tokens on the plain path).
CHUNK_FLOOR = 32


def scan_geometry(S: int, chunk: int) -> tuple[int, int]:
    """(scan chunk, scanned length) for S positions at a chunk of at most
    ``chunk``: the largest chunk that divides S; where that is below
    ``CHUNK_FLOOR`` (and ``min(chunk, S)`` is not), S rounded up to a
    multiple of ``CHUNK_FLOOR`` and the largest chunk that divides that."""
    c = min(chunk, S)

    def divisor(n):
        d = c
        while n % d:
            d -= 1
        return d
    d = divisor(S)
    if d >= CHUNK_FLOOR or c < CHUNK_FLOOR:
        return d, S
    padded = -(-S // CHUNK_FLOOR) * CHUNK_FLOOR
    return divisor(padded), padded


def mamba_scan(Cm, Bm, xh, log_a, log_g, *, chunk: int, state=None,
               kernels=None):
    """The Mamba2 scan: Cm/Bm [B, S, N] are q/k shared by every head
    (stride-0 views over the heads, never copied per head), xh
    [B, S, H, P] the values, log_a/log_g [B, S, H]. Runs
    ``ops.mamba_mixer`` at ``scan_geometry(S, chunk)``; positions padded
    past S are identity steps (``valid_len`` S), so y [B, S, H, P] and the
    state equal the unpadded scan's."""
    from repro_torch.kernels import ops
    Bsz, S, nh = log_a.shape
    N = Cm.shape[-1]
    chunk, S_scan = scan_geometry(S, chunk)
    valid_len = None
    if S_scan > S:
        def pad(t):
            return torch.cat([t, t.new_zeros((Bsz, S_scan - S,
                                              *t.shape[2:]))], dim=1)
        Cm, Bm, xh, log_a, log_g = map(pad, (Cm, Bm, xh, log_a, log_g))
        valid_len = torch.full((Bsz,), S, device=log_a.device)
    q = Cm[:, :, None, :].expand(Bsz, S_scan, nh, N)
    k = Bm[:, :, None, :].expand(Bsz, S_scan, nh, N)
    y, ssm_state = ops.mamba_mixer(q, k, xh, log_a, log_g, chunk=chunk,
                                   state=state, valid_len=valid_len,
                                   kernels=kernels)
    return y[:, :S], ssm_state


def mamba_forward(p, cfg, x, state=None, *, chunk: int = 128, mask=None,
                  kernels=None, tp=None):
    """x [B, S, D] -> (y [B, S, D], state). state = {"conv": tail
    [B, K-1, C], "ssm": (C, n, m)}.

    ``mask`` [B, S] bool marks real tokens (end-padded rows of a
    length-bucketed batch): pad positions neither advance the SSM state nor
    enter the carried conv tail. The scan is ``mamba_scan``: through
    ``ops.mamba_mixer`` with ``kernels`` (the chunk-scan kernel when
    enabled, ``chunked_gla`` otherwise) at ``scan_geometry``'s chunk (JAX
    asserts that ``chunk`` divides S; the result does not depend on the
    chunking). ``tp``: a Megatron TP shard's axis (``wz`` / ``wx``
    column-parallel and gathered, ``out_proj`` row-parallel).
    """
    Bsz, S, _ = x.shape
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt_raw = _mamba_proj(p, cfg, xin, tp)
    carried = cfg.ssm_conv - 1
    if state is not None:
        conv_tail = state["conv"]
        xbc_full = torch.cat([conv_tail.to(xbc.dtype), xbc], dim=1)
        xbc_act = _causal_conv(xbc_full, p["conv_w"],
                               p["conv_b"])[:, conv_tail.shape[1]:]
    else:
        conv_tail = xbc.new_zeros((Bsz, carried, xbc.shape[-1]))
        xbc_full = torch.cat([conv_tail, xbc], dim=1)
        xbc_act = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    if mask is None:
        new_conv_tail = xbc_full[:, -carried:]
    else:
        new_conv_tail = _masked_tail(xbc_full, mask, carried)
    xh, Bm, Cm, dt, log_a = _mamba_ssm_inputs(p, cfg, xbc_act, dt_raw)
    log_g = torch.log(dt + 1e-20)
    if mask is not None:
        log_a, log_g = mask_log_gates(log_a, log_g, mask)
    y, ssm_state = mamba_scan(
        Cm, Bm, xh, log_a, log_g, chunk=chunk,
        state=state["ssm"] if state is not None else None, kernels=kernels)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, S, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm"], cfg.norm_eps)
    out = dense_row(y, p["out_proj"], cfg.d_inner, tp)
    return out, {"conv": new_conv_tail, "ssm": ssm_state}


def mamba_step(p, cfg, x, state, *, kernels=None, tp=None):
    """x [B, D] single token. state as returned by mamba_forward."""
    y, new_state = mamba_forward(p, cfg, x[:, None, :], state, chunk=1,
                                 kernels=kernels, tp=tp)
    return y[:, 0], new_state


def mamba_init_state(cfg, batch: int, dtype=F32, device=None, *,
                     lead: tuple[int, ...] = ()):
    """Zero Mamba2 state for ``batch`` rows; ``lead`` prepends axes (the
    model stacks the layers' states as ``[L, B, ...]``)."""
    nh, N, P = cfg.ssm_n_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_ch = cfg.d_inner + 2 * N

    def z(*shape, dt=F32):
        return torch.zeros((*lead, batch, *shape), dtype=dt, device=device)
    return {"conv": z(cfg.ssm_conv - 1, conv_ch, dt=dtype),
            "ssm": (z(nh, N, P), z(nh, N), z(nh))}


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------

def init_mlstm(cfg, normal, zeros, dtype, device):
    """One mLSTM layer's weights with the distributions of
    ``repro.models.ssm.init_mlstm`` (gate biases fp32, forget gates open)."""
    D, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "ln": zeros(D),
        "wu": normal((D, di), 1 / math.sqrt(D)),
        "wg": normal((D, di), 1 / math.sqrt(D)),
        "wq": normal((di, di), 1 / math.sqrt(di)),
        "wk": normal((di, di), 1 / math.sqrt(di)),
        "wv": normal((di, di), 1 / math.sqrt(di)),
        "wi": normal((di, H), 0.01),
        "bi": torch.zeros((H,), dtype=F32, device=device),
        "wf": normal((di, H), 0.01),
        "bf": torch.full((H,), 3.0, dtype=F32, device=device),
        "norm": zeros(di),
        "down": normal((di, D), 1 / math.sqrt(di * 2 * cfg.n_layers)),
    }


def _mlstm_qkvg(p, cfg, xin, tp=None):
    di, H = cfg.d_inner, cfg.n_heads
    dh = di // H
    u, g = dense_col(xin, p["wu"], di, tp), dense_col(xin, p["wg"], di, tp)
    shp = (*u.shape[:-1], H, dh)
    q = dense_col(u, p["wq"], di, tp).reshape(shp)
    k = dense_col(u, p["wk"], di, tp).reshape(shp) / math.sqrt(dh)
    v = dense_col(u, p["wv"], di, tp).reshape(shp)
    log_g = dense(u, p["wi"]).float() + p["bi"]              # input gate
    log_a = -F.softplus(-(dense(u, p["wf"]).float() + p["bf"]))  # log sigmoid
    return q, k, v, log_a, log_g, g


def mlstm_forward(p, cfg, x, state=None, *, chunk: int = 128, mask=None,
                  tp=None):
    """x [B, S, D] -> (y [B, S, D], (C, n, m)). ``mask`` [B, S] bool: pad
    positions are identity steps (the carry passes through unchanged);
    their outputs are garbage and must not be read.

    The scan runs at ``scan_geometry(S, chunk)``: JAX's chunk
    (``min(chunk, S)``) wherever it divides S, and where it does not (JAX
    asserts) the largest chunk that does, S padded with identity steps
    when that chunk would be shorter than ``CHUNK_FLOOR``. ``tp``: a
    Megatron TP shard's axis (``wu`` / ``wg`` / ``wq`` / ``wk`` / ``wv``
    column-parallel and gathered, ``down`` row-parallel)."""
    B, S, _ = x.shape
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v, log_a, log_g, g = _mlstm_qkvg(p, cfg, xin, tp)
    if mask is not None:
        log_a, log_g = mask_log_gates(log_a, log_g, mask)
    c, S_scan = scan_geometry(S, chunk)
    if S_scan > S:
        def pad(t):
            return torch.cat([t, t.new_zeros((B, S_scan - S, *t.shape[2:]))],
                             dim=1)
        q, k, v, log_a = map(pad, (q, k, v, log_a))
        log_g = torch.cat([log_g, log_g.new_full(
            (B, S_scan - S, log_g.shape[2]), NEG_INF)], dim=1)
    y, new_state = chunked_gla(q, k, v, log_a, log_g, chunk=c,
                               normalize=True, state=state)
    y = y[:, :S].reshape(B, S, cfg.d_inner).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps) * F.silu(g.float()).to(x.dtype)
    return dense_row(y, p["down"], cfg.d_inner, tp), new_state


def mlstm_step(p, cfg, x, state, *, tp=None):
    """x [B, D] single token; the scan at chunk 1, as in JAX."""
    y, new_state = mlstm_forward(p, cfg, x[:, None, :], state, chunk=1,
                                 tp=tp)
    return y[:, 0], new_state


def mlstm_init_state(cfg, batch: int, device=None, *,
                     lead: tuple[int, ...] = ()):
    """Fresh mLSTM carry ``(C, n, m)`` for ``batch`` rows (``m`` at
    ``NEG_INF``); ``lead`` prepends axes (the model stacks the layers'
    carries as ``[L, B, ...]``)."""
    H, dh = cfg.n_heads, cfg.d_inner // cfg.n_heads
    return (torch.zeros((*lead, batch, H, dh, dh), dtype=F32, device=device),
            torch.zeros((*lead, batch, H, dh), dtype=F32, device=device),
            torch.full((*lead, batch, H), NEG_INF, dtype=F32, device=device))


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): sequential by construction (memory mixing)
# ---------------------------------------------------------------------------

def init_slstm(cfg, normal, zeros, dtype, device):
    """One sLSTM layer's weights with the distributions of
    ``repro.models.ssm.init_slstm``: input weights ``w`` [D, 4D] for the
    (i, f, z, o) gates, fp32 biases ``b`` [4D] (forget gates open), the
    block-diagonal recurrent weights ``r`` [4, H, dh, dh]."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    b = torch.zeros((4 * D,), dtype=F32, device=device)
    b[D:2 * D] = 3.0
    return {
        "ln": zeros(D),
        "w": normal((D, 4 * D), 1 / math.sqrt(D)),
        "b": b,
        "r": normal((4, H, dh, dh), 1 / math.sqrt(dh)),
        "norm": zeros(D),
        "proj": normal((D, D), 1 / math.sqrt(D * 2 * cfg.n_layers)),
    }


def _slstm_cell(p, cfg, x_pre, state):
    """x_pre [B, 4D] input preactivations (bias included); state = (c, n,
    m, h), each [B, D]. ``p["r"]`` is read as ``[H, dh, 4 dh]`` (the four
    gates' recurrent weights side by side: one batched product a step)."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    c, n, m, hprev = state
    rec = torch.bmm(hprev.reshape(-1, H, dh).transpose(0, 1), p["r"])
    rec = rec.reshape(H, -1, 4, dh).permute(1, 2, 0, 3).reshape(-1, 4, D)
    pre = x_pre.reshape(-1, 4, D) + rec
    it, ft, zt, ot = pre.unbind(1)
    log_f = -F.softplus(-ft)
    m_new = torch.maximum(log_f + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(zt)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(ot) * (c_new / n_new.clamp_min(1e-6))
    return (c_new, n_new, m_new, h_new), h_new


def slstm_forward(p, cfg, x, state=None, *, mask=None):
    """x [B, S, D] -> (y [B, S, D], (c, n, m, h)). ``mask`` [B, S] bool:
    pad positions keep the previous carry (their emitted h is garbage and
    must not be read). The cell runs once a position, in fp32."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    x_pre = dense(xin, p["w"]).float() + p["b"]              # [B, S, 4D]
    cell = {"r": p["r"].float().permute(1, 2, 0, 3).reshape(H, dh, 4 * dh)}
    if state is None:
        state = slstm_init_state(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        new, h = _slstm_cell(cell, cfg, x_pre[:, t], state)
        if mask is not None:
            mt = mask[:, t, None]
            new = tuple(torch.where(mt, a, o) for a, o in zip(new, state))
        state = new
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    h = rms_norm(h, p["norm"], cfg.norm_eps)
    return dense(h, p["proj"]), state


def slstm_step(p, cfg, x, state):
    """x [B, D] single token. The serve plan cuts none of its weights
    (``w``, ``r``, ``proj``): a TP shard runs it whole."""
    y, state = slstm_forward(p, cfg, x[:, None, :], state)
    return y[:, 0], state


def slstm_init_state(cfg, batch: int, device=None, *,
                     lead: tuple[int, ...] = ()):
    """Fresh sLSTM carry ``(c, n, m, h)`` for ``batch`` rows (``m`` at
    ``NEG_INF``); ``lead`` as in ``mlstm_init_state``."""
    shape = (*lead, batch, cfg.d_model)

    def z():
        return torch.zeros(shape, dtype=F32, device=device)
    return (z(), z(), torch.full(shape, NEG_INF, dtype=F32, device=device),
            z())
