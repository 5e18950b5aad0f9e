"""AdamW with global-norm clipping and a warmup-cosine schedule.

Port of ``repro/training/optimizer.py`` over the port's parameter trees
(nested dicts and lists of tensors). Moments are fp32; the update is
computed in fp32 and cast back to each parameter's dtype. ``apply`` is
functional, as JAX's: it returns new tensors and leaves its inputs
untouched.

Weight decay is decoupled and applies to matrices only, as repro decides
it: by the rank of repro's leaf. repro stacks an attention stack's layers
into ``[L, ...]`` leaves, so its per-layer norm weights are ``[L, D]``
(rank 2, decayed) while ``final_norm`` is ``[D]`` (not decayed); the port
keeps those layers as a list of dicts, so a leaf under a list counts one
more axis (``_decays``). Mamba2 and xLSTM leaves are stacked in both
packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.model import tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> list:
    """The tensor leaves of nested dicts / lists / tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _decays(tree, lists: int = 0) -> list[bool]:
    """Per leaf: is repro's counterpart a matrix (rank >= 2, a list of
    layers counting as the stacked axis)?"""
    if isinstance(tree, dict):
        return [d for v in tree.values() for d in _decays(v, lists)]
    if isinstance(tree, (list, tuple)):
        return [d for v in tree for d in _decays(v, lists + 1)]
    return [tree.dim() + lists >= 2]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``, in fp32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params) -> dict:
    """Zero fp32 moments shaped like ``params`` and step 0 (an int32
    scalar on the params' device)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state, *, gnorm=None):
    """Returns (new_params, new_state, metrics). ``gnorm``: the clip's
    grad norm, when ``grads`` are a shard's slices of the whole grads
    (``global_norm(grads)`` else)."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    out_p, out_m, out_v = [], [], []
    for p, g, m, v, decay in zip(tree_leaves(params), tree_leaves(grads),
                                 tree_leaves(state["m"]),
                                 tree_leaves(state["v"]), _decays(params)):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        pf = p.float()
        if decay:                           # decoupled wd on matrices only
            u = u + cfg.weight_decay * pf
        out_p.append((pf - lr * u).to(p.dtype))
        out_m.append(m)
        out_v.append(v)
    new_state = {"m": tree_unflatten(state["m"], out_m),
                 "v": tree_unflatten(state["v"], out_v), "step": step}
    return (tree_unflatten(params, out_p), new_state,
            {"grad_norm": gnorm, "lr": lr})
