"""The plain reference's shared parts: matrix products in float32 (TF32
off) or, for the control, TF32; RMS norm scaled by ``1 + w``; rotary
embeddings on the halves of each head; causal grouped-query attention
(query head h reads KV head ``h // (H / KVH)``) over K/V that may start
with a handed-over context; the pre-norm attention block with its MLP.
Each architecture is a file of its own beside the configs,
``references/<name>.py`` (the config's ``reference`` key): its weight
layout and its forward, built from these. Nothing here imports the
program: the reference reads the config dict, the weights in the port's
layout (made again from the seed by ``harness.weights``) and the served
tokens.

The rotary frequencies are the float32 formula ``theta ** (arange(d/2,
float32) * 2 / d)`` in float32 arithmetic, as the config runs (a float64
table differs from it by one unit in the last place in most entries, and
at 36k positions that alone turns a head's angles by up to 4e-3 rad);
the angles are ``position * inv_freq`` in float32.

``tf32=True`` is the control: the same pass with every matrix product in
TF32 (on a card through ``allow_tf32``; on the CPU, which has no TF32,
by rounding each product's operands to TF32's 10-bit mantissa).
"""
from __future__ import annotations

import importlib.util
import math
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

_EMULATE = {"tf32": False}
Q_BLOCK = 256               # query rows of attention at a time


@contextmanager
def precision(tf32: bool, device):
    """Matrix products in float32 (``tf32=False``: TF32 off) or TF32."""
    cuda = torch.device(device).type == "cuda"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, _EMULATE["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _EMULATE["tf32"] = tf32 and not cuda
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _EMULATE["tf32"]) = saved


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to nearest (ties to even) at TF32's 10 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _EMULATE["tf32"]:
        a, b = tf32_round(a), tf32_round(b)
    return torch.matmul(a, b)


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def inv_freq(d_head: int, theta: float, device) -> torch.Tensor:
    inv = 1.0 / (float(theta) ** (np.arange(0, d_head // 2, dtype=np.float32)
                                  * 2 / d_head))
    return torch.from_numpy(inv.astype(np.float32)).to(device)


def rope(x, pos, theta):
    """x [n, heads, D] at integer positions ``pos`` [n]."""
    ang = pos.float()[:, None] * inv_freq(x.shape[-1], theta, x.device)
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def attention(q, k, v):
    """Causal attention of the last n = len(q) positions of k / v. q [n, H,
    D]; k, v [T, KVH, D]; query i sees keys 0 .. T - n + i."""
    n, H, D = q.shape
    T, KVH = k.shape[0], k.shape[1]
    G = H // KVH
    kt = k.permute(1, 2, 0)                    # [KVH, D, T]
    vt = v.permute(1, 0, 2)                    # [KVH, T, D]
    out = torch.empty_like(q)
    keys = torch.arange(T, device=q.device)
    for a in range(0, n, Q_BLOCK):
        b = min(n, a + Q_BLOCK)
        qb = q[a:b].reshape(b - a, KVH, G, D).permute(1, 2, 0, 3)
        s = mm(qb.reshape(KVH, G * (b - a), D), kt) / math.sqrt(D)
        s = s.view(KVH, G, b - a, T)
        last = T - n + torch.arange(a, b, device=q.device)
        s = s.masked_fill(keys[None, :] > last[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1).view(KVH, G * (b - a), T)
        o = mm(p, vt).view(KVH, G, b - a, D)
        out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, H, D)
    return out


def act(x, kind):
    if kind == "swiglu":
        return F.silu(x)
    if kind in ("gelu", "geglu"):
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(kind)


def attn_block(c, lp, x, pos, ctx_k=None, ctx_v=None):
    """x [n, D] at positions ``pos``; ``ctx_k`` / ``ctx_v`` [c, KVH, D]
    precede the new tokens."""
    n = x.shape[0]
    H, KVH, D = c["n_heads"], c["n_kv_heads"], c["d_head"]
    h = rms(x, lp["ln1"], c["norm_eps"])
    a = lp["attn"]
    q = rope(mm(h, a["wq"]).view(n, H, D), pos, c["rope_theta"])
    k = rope(mm(h, a["wk"]).view(n, KVH, D), pos, c["rope_theta"])
    v = mm(h, a["wv"]).view(n, KVH, D)
    if ctx_k is not None:
        k = torch.cat([ctx_k, k])
        v = torch.cat([ctx_v, v])
    x = x + mm(attention(q, k, v).reshape(n, H * D), a["wo"])
    h = rms(x, lp["ln2"], c["norm_eps"])
    m = lp["mlp"]
    u = act(mm(h, m["w1"]), c.get("act", "swiglu"))
    if "w3" in m:
        u = u * mm(h, m["w3"])
    return x + mm(u, m["w2"])


def logits(c, params, x):
    return mm(rms(x, params["final_norm"], c["norm_eps"]), params["head"])


def module_for(c: dict):
    """The architecture file ``references/<c["reference"]>.py``: its weight
    layout (``normal_leaves``, ``init_extra``) and its ``forward``."""
    name = c["reference"]
    path = Path(__file__).resolve().parents[1] / "references" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_ref_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forward_for(c: dict):
    """The config's ``forward(c, params, tokens, start, ctx_kv)``: the
    logits [n, V] at positions start .. start + n - 1 of ``tokens``,
    ``ctx_kv`` = (k, v) [L, start, KVH, D] the context in front of them
    (or None)."""
    return module_for(c).forward
