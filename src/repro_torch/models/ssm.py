"""State-space blocks: the chunkwise gated-linear-attention engine and Mamba2.

Port of the Mamba2 half of ``repro/models/ssm.py``. Mamba2 (and mLSTM,
still to port) are gated linear attention: the state
``h_t = a_t h_{t-1} + g_t k_t v_t^T`` is computed chunkwise in parallel
(``chunked_gla``: attention-like products inside a chunk, the state handed
across chunks). Mamba2's scan runs through ``kernels/ops.mamba_mixer``, so
on the card it is the hand-written chunk-scan kernel
(``kernels/ssm_scan.py``); decode is the same scan at ``S = 1``.

State of one Mamba2 layer, as in JAX: ``{"conv": [B, K-1, C], "ssm":
(C [B, nh, N, P], n [B, nh, N], m [B, nh])}``. ``n`` is accumulated but never
read by Mamba2 and ``m`` stays at its seed; both are carried so the state
equals the JAX state leaf for leaf.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import NEG_INF, dense, rms_norm

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


def _mamba_proj(p, cfg, x):
    """Shared in-proj/split. x [B, S, D] -> z, xbc_raw, dt_raw."""
    z = dense(x, p["wz"])
    xbc = torch.cat([dense(x, p["wx"]), dense(x, p["wbc"])], dim=-1)
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


def mamba_forward(p, cfg, x, state=None, *, chunk: int = 128, mask=None,
                  kernels=None):
    """x [B, S, D] -> (y [B, S, D], state). state = {"conv": tail
    [B, K-1, C], "ssm": (C, n, m)}.

    ``mask`` [B, S] bool marks real tokens (end-padded rows of a
    length-bucketed batch): pad positions neither advance the SSM state nor
    enter the carried conv tail. The scan goes through
    ``ops.mamba_mixer`` with ``kernels`` (the chunk-scan kernel when
    enabled, ``chunked_gla`` otherwise), at the largest chunk not above
    ``chunk`` that divides S (JAX asserts that ``chunk`` does; the result
    does not depend on the chunking).
    """
    from repro_torch.kernels import ops
    Bsz, S, _ = x.shape
    nh, N = cfg.ssm_n_heads, cfg.ssm_state
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt_raw = _mamba_proj(p, cfg, xin)
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
    # q/k are shared by every head: stride-0 views, never copied per head
    q = Cm[:, :, None, :].expand(Bsz, S, nh, N)
    k = Bm[:, :, None, :].expand(Bsz, S, nh, N)
    log_g = torch.log(dt + 1e-20)
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    if mask is not None:
        log_a, log_g = mask_log_gates(log_a, log_g, mask)
    y, ssm_state = ops.mamba_mixer(
        q, k, xh, log_a, log_g, chunk=chunk,
        state=state["ssm"] if state is not None else None, kernels=kernels)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, S, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm"], cfg.norm_eps)
    out = dense(y, p["out_proj"])
    return out, {"conv": new_conv_tail, "ssm": ssm_state}


def mamba_step(p, cfg, x, state, *, kernels=None):
    """x [B, D] single token. state as returned by mamba_forward."""
    y, new_state = mamba_forward(p, cfg, x[:, None, :], state, chunk=1,
                                 kernels=kernels)
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
