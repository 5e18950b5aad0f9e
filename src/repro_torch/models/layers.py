"""Core NN layers: norms, rotary embeddings, attention, MLPs, embeddings.

Port of ``repro/models/layers.py``. Everything is a plain function over
tensors and parameter dicts. Weights keep the JAX layout: a dense weight is
``[d_in, d_out]`` and ``dense(x, w) = x @ w``. Norm, softmax and attention
accumulators are fp32.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w in the compute dtype (w is [d_in, d_out]). ``w`` may be an
    int8 QTensor ``{"q", "s"}`` (``core/quant.py``): the int8 weight is
    widened to x's dtype for the product and the per-column scale applied
    to its output, as repro does."""
    if isinstance(w, dict):                      # int8 weight-only quant
        y = torch.matmul(x, w["q"].to(x.dtype))
        return (y * w["s"][..., 0, :].to(x.dtype)).to(x.dtype)
    return torch.matmul(x, w).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """RMS norm scaled by ``(1 + w)`` (zero-initialised weights)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":               # silu on the gate half
        return F.silu(x)
    if kind in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {kind!r}")


# ---------------------------------------------------------------------------
# rotary embeddings (half-split layout, as in repro)
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head // 2, dtype=np.float32)
                            * 2 / d_head))


@lru_cache(maxsize=16)
def _inv_freqs(d_head: int, theta: float, device: torch.device):
    # uploaded once per device: a host->device copy on every decode step
    # would synchronise the stream
    return torch.from_numpy(rope_freqs(d_head, theta)).to(device)


def rope_cos_sin(positions: torch.Tensor, d_head: int, theta: float):
    """positions [...] -> (cos, sin) of shape [..., d_head/2]."""
    inv = _inv_freqs(d_head, float(theta), positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, d_head: int, theta: float,
                  sections: tuple[int, ...]):
    """M-RoPE: positions [3, B, S] (t/h/w ids); ``sections`` sum to
    d_head/2. Frequency slot j takes its position from the axis whose
    section owns j, the sections contiguous (t, then h, then w), as in
    repro. Returns (cos, sin) [B, S, d_head/2]."""
    if sum(sections) != d_head // 2:
        raise ValueError(f"mrope sections {sections} do not sum to "
                         f"d_head/2 = {d_head // 2}")
    inv = _inv_freqs(d_head, float(theta), positions.device)
    pos = positions.float()
    bounds = np.cumsum((0,) + tuple(sections))
    ang = torch.cat([pos[a][..., None] * inv[bounds[a]:bounds[a + 1]]
                     for a in range(len(sections))], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, H, D]; cos/sin [B, S, D/2]. The first and second halves of
    the head dimension form the rotated pairs (not interleaved pairs)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention — chunked online softmax, GQA + sliding window
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset=0,
                    kv_chunk: int = 512) -> torch.Tensor:
    """Memory-bounded attention via online softmax over KV chunks — the
    plain version of the prefill flash-attention kernel
    (``kernels/flash_attention.py``).

    q [B, Sq, H, D]; k, v [B, Skv, KVH, D]. ``q_offset`` is the global
    position of q[0] relative to k[0], an int or a [B] tensor (each request
    its own resume depth). ``window`` > 0 restricts attention to the last
    ``window`` keys (inclusive of self); 0 = unwindowed. Returns
    [B, Sq, H, D] in q.dtype. K/V are never repeated to H heads; the
    probabilities drop to the KV dtype for the P.V product.
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kv_chunk = min(kv_chunk, skv)
    while skv % kv_chunk:          # largest divisor <= requested chunk
        kv_chunk -= 1
    dev = q.device
    qt = q.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4).float()
    off = (q_offset.long() if torch.is_tensor(q_offset)
           else torch.full((1,), int(q_offset), device=dev))
    q_pos = off.reshape(-1, 1) + torch.arange(sq, device=dev)[None]  # [1|B,Sq]
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32, device=dev)
    for start in range(0, skv, kv_chunk):
        kb = k[:, start:start + kv_chunk].float()
        vb = v[:, start:start + kv_chunk]
        kv_pos = start + torch.arange(kv_chunk, device=dev)[None, None, :]
        s = torch.einsum("bkgqd,bckd->bkgqc", qt, kb) * scale
        ok = torch.ones((1, sq, kv_chunk), dtype=torch.bool, device=dev)
        if causal:
            ok = ok & (kv_pos <= q_pos[:, :, None])
        if window and window > 0:
            ok = ok & (kv_pos > q_pos[:, :, None] - window)
        ok = ok[:, None, None]                          # [1|B,1,1,Sq,C]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         ctx_len: torch.Tensor, *, window: int = 0):
    """Single-token decode attention against a (contiguous) cache.

    q [B, H, D]; k, v [B, T, KVH, D]; ctx_len [B] = number of valid cache
    entries (the new token's K/V already appended). Reference path."""
    b, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kvh).float()
    v = _repeat_kv(v, h // kvh).float()
    s = torch.einsum("bhd,bthd->bht", q.float(), k) / math.sqrt(d)
    pos = torch.arange(t, device=q.device)[None, :]
    ok = pos < ctx_len.long()[:, None]
    if window:
        ok = ok & (pos >= ctx_len.long()[:, None] - window)
    s = torch.where(ok[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bthd->bhd", p, v).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP, attention projections, embeddings
# ---------------------------------------------------------------------------

def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = activate(dense(x, p["w1"]), act)
    if "w3" in p:
        h = h * dense(x, p["w3"])
    return dense(h, p["w2"])


def qkv_project(p, cfg, x: torch.Tensor):
    """x [B,S,D] -> q [B,S,H,dh], k,v [B,S,KVH,dh], with qk-norm if set."""
    b, s, _ = x.shape
    q = dense(x, p["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = dense(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = dense(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if "qn" in p:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    return q, k, v


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def lm_head(x: torch.Tensor, w, *, transpose: bool):
    """fp32 logits over the padded vocabulary. ``transpose`` for tied
    embeddings ([V, D] table). An untied head may be an int8 QTensor."""
    if isinstance(w, dict):
        return torch.matmul(x.float(), w["q"].float()) * w["s"][..., 0, :]
    wt = w.t() if transpose else w
    return torch.matmul(x.float(), wt.float())


# ---------------------------------------------------------------------------
# sinusoidal positions (the enc-dec family: no rope)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def _sin_div(d: int, device: torch.device):
    # made once per device, as ``_inv_freqs``: a decode step inside a
    # captured horizon computes its position on the card from ctx alone
    return torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) * (-math.log(10000.0) / d))


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal embedding at device positions [...] -> [..., d]
    float32: sin on even columns, cos on odd ones."""
    ang = positions.float()[..., None] * _sin_div(d, positions.device)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        *positions.shape, d)
