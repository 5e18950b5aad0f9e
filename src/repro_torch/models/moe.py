"""Mixture-of-Experts: top-k routing with capacity, virtual-expert layout.

Port of ``repro/models/moe.py`` (``moe_local``: every expert on one
device). Weights are stored as **virtual experts**: ``V = n_virtual``
slices where each real expert's d_ff is split across ``v = V / E``
consecutive virtual experts; their partial outputs are summed before the
combine. The serving engine builds ``V = E`` (v = 1).

Router math is fp32. Capacity per real expert follows GShard:
``C = ceil(T * top_k * capacity_factor / E)``, T counting every row the
caller passes (pad positions and idle decode slots included, as in repro);
choices past an expert's capacity are dropped and keep only the residual
path. Choices claim their expert's slots in token-major order over the
flattened ``(T * top_k)`` choices.

Everything here has static shapes and never reads a device value on the
host, so it runs inside a captured CUDA graph: the top k come from a
stable descending sort (``lax.top_k``'s order: ties to the lowest expert
index, which ``torch.topk`` does not promise), and a dropped choice is
scattered to a trash row past the ``[E, C, D]`` buffers (as ``mode="drop"``
became a trash page in the paged pool).

Expert weights may be int8 QTensors (``core/quant.py``). The training
path takes the load-balancing term with the output (``with_aux``);
``dispatch`` writes a fresh buffer, so autograd carries each kept
choice's gradient back to its row and a dropped one's (the trash row,
cut off) is zero, as ``mode="drop"`` gives in repro.

Not ported: ``moe_ep`` (expert parallelism over an all-to-all, ROADMAP
A.10).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activate, dense


def init_moe(cfg, normal, n_virtual: int | None = None) -> dict:
    """Router ``[D, E]`` and the virtual experts' ``w1`` / ``w3`` ``[V, D,
    ff/v]`` and ``w2`` ``[V, ff/v, D]``, with the distributions of
    ``repro.models.moe.init_moe``; ``normal(shape, scale)`` draws from the
    caller's seeded generator."""
    E, D, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    V = n_virtual or E
    v = V // E
    if v * E != V or ff % v:
        raise ValueError(f"{cfg.name}: {V} virtual experts do not split "
                         f"{E} experts of d_ff {ff}")
    ffv = ff // v
    p = {"router": normal((D, E), 0.02),
         "w1": normal((V, D, ffv), 1 / math.sqrt(D)),
         "w2": normal((V, ffv, D), 1 / math.sqrt(ff * 2 * cfg.n_layers))}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = normal((V, D, ffv), 1 / math.sqrt(D))
    return p


def _route(router_w, cfg, x):
    """x [T, D] -> (probs [T, E] fp32, top_p [T, K], top_e [T, K])."""
    probs = torch.softmax(dense(x, router_w).float(), dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt[:, :cfg.moe_top_k], idx[:, :cfg.moe_top_k]
    return (probs, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9),
            top_e)


def route(router_w, cfg, x):
    """x [T, D] -> (probs [T, K], experts [T, K])."""
    return _route(router_w, cfg, x)[1:]


def _balance(probs, top_e, E: int):
    """repro's load-balancing term: ``E * sum(mean probability * top-1
    share)`` over the experts."""
    top1 = F.one_hot(top_e[:, 0], E).float()
    return E * (probs.mean(0) * top1.mean(0)).sum()


def aux_loss(router_w, cfg, x):
    """repro's load-balancing loss for x [T, D]: the training term
    ``moe_local(..., with_aux=True)`` returns beside its output."""
    probs, _, top_e = _route(router_w, cfg, x)
    return _balance(probs, top_e, cfg.n_experts)


def capacity(cfg, T: int) -> int:
    return max(1, math.ceil(T * cfg.moe_top_k * cfg.capacity_factor
                            / cfg.n_experts))


def _dispatch_indices(top_e, E: int, C: int):
    """Flat (T*K) choices -> slot in the [E, C] buffers + keep mask."""
    flat_e = top_e.reshape(-1)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    slot = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    return slot, slot < C


def dispatch(x, top_e, slot, keep, E: int, C: int):
    """x [T, D] -> per-real-expert buffers [E, C, D]. Kept choices land at
    ``(expert, slot)``, each at most once; dropped ones at the trash row
    ``E * C``, which is cut off."""
    K = top_e.shape[1]
    D = x.shape[-1]
    row = torch.where(keep, top_e.reshape(-1) * C + slot, E * C)
    buf = x.new_zeros((E * C + 1, D))
    buf[row] = x.repeat_interleave(K, dim=0)
    return buf[:E * C].reshape(E, C, D)


def combine(buf, top_p, top_e, slot, keep):
    """buf [E, C, D] (v-slices pre-summed) -> y [T, D]."""
    T, K = top_e.shape
    picked = buf[top_e.reshape(-1), torch.where(keep, slot, 0)]
    w = (top_p.reshape(-1) * keep).to(buf.dtype)
    return (picked * w[:, None]).reshape(T, K, -1).sum(1)


def _emm(x, w):
    """Expert product ``bmm(x, w)``, fp32 out; ``w`` may be an int8
    QTensor (``core/quant.py``; its scale [V, 1, out] broadcasts)."""
    if isinstance(w, dict):
        return torch.bmm(x, w["q"].to(x.dtype)).float() * w["s"].float()
    return torch.bmm(x, w).float()


def expert_mlp(p, cfg, buf):
    """buf [V, C, D] through each virtual expert's MLP slice (partial
    out). The products' outputs are fp32 before the activation, as the
    einsums' ``preferred_element_type`` in repro."""
    h = activate(_emm(buf, p["w1"]), cfg.act).to(buf.dtype)
    if "w3" in p:
        h = h * _emm(buf, p["w3"]).to(buf.dtype)
    return _emm(h, p["w2"]).to(buf.dtype)


def moe_local(p, cfg, x, *, with_aux: bool = False):
    """x [B, S, D] -> y [B, S, D], or ``(y, aux)`` with ``with_aux`` (the
    training path: repro's ``moe_local`` and the load-balancing term of its
    ``route``). The virtual-expert count is read from the weights; at one
    virtual expert an expert (the serving layout) the buffers go through
    unrepeated."""
    B, S, D = x.shape
    E = cfg.n_experts
    w1 = p["w1"]["q"] if isinstance(p["w1"], dict) else p["w1"]
    V = w1.shape[0]
    v = V // E
    xt = x.reshape(-1, D)
    probs, top_p, top_e = _route(p["router"], cfg, xt)
    C = capacity(cfg, xt.shape[0])
    slot, keep = _dispatch_indices(top_e, E, C)
    buf = dispatch(xt, top_e, slot, keep, E, C)            # [E, C, D]
    if v == 1:
        summed = expert_mlp(p, cfg, buf)
    else:
        out = expert_mlp(p, cfg, buf.repeat_interleave(v, dim=0))
        summed = out.reshape(E, v, C, D).sum(1)
    y = combine(summed, top_p, top_e, slot, keep).reshape(B, S, D)
    return (y, _balance(probs, top_e, E)) if with_aux else y
