"""int8 weight-only quantization for serving.

Port of ``repro/core/quant.py``. Symmetric per-output-channel int8: a
weight ``[.., D_in, D_out]`` becomes ``{"q": int8 [.., D_in, D_out], "s":
f32 [.., 1, D_out]}`` (a QTensor). ``models.layers.dense``, ``lm_head``
and ``models.moe.expert_mlp`` take a QTensor where they take a weight and
dequantize per use: the int8 tensor is what a decode step reads.

``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q`` is
bit-equal to repro's for the same fp32 weight. The port's attention
stacks are lists of per-layer dicts where repro stacks ``[L, ..]``
leaves; a scale is taken over ``D_in`` per layer either way, so the
per-layer QTensors are the slices of repro's stacked ones.
"""
from __future__ import annotations

import torch

# weight names worth quantizing (large matmul operands on the serve path)
QUANT_NAMES = {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "wz", "wx",
               "wu", "wg", "out_proj", "down", "head", "up", "proj"}


def is_qtensor(w) -> bool:
    return isinstance(w, dict) and set(w) == {"q", "s"}


def quantize_tensor(w: torch.Tensor) -> dict:
    """[.., D_in, D_out] -> int8 + per-out-channel scale."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_tensor(qw: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (qw["q"].float() * qw["s"]).to(dtype)


def quantize_params(params, *, names=QUANT_NAMES, min_size: int = 1 << 16):
    """Quantize matching >= 2-D weight leaves; everything else passes
    through. Lists (the per-layer dicts) are walked like dicts; a leaf's
    size is counted as repro counts it, over every layer of its stack."""
    def walk(node, key=None, depth=1):
        if isinstance(node, dict):
            return {k: walk(v, k, depth) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key, depth * len(node)) for v in node)
        if (key in names and isinstance(node, torch.Tensor)
                and node.dim() >= 2 and node.numel() * depth >= min_size):
            return quantize_tensor(node)
        return node
    return walk(params)


def quantized_bytes(params) -> int:
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    return params.numel() * params.element_size()
