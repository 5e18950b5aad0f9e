"""The yardstick: the card's peaks and the operations and bytes the work
needs, computed from the config's shapes and the requests' contexts.

Counts are of the work, never of how a kernel does it: no splits,
partials, padding or launch geometry. Each input byte is read once and
each output byte written once. They follow the port's
``launch/kernel_bench.py`` (``attention_bound_us``) and
``launch/roofline.py`` (``model_flops``: 2 x params x tokens plus the
attention math), with one correction: K1's output is the merged head
output, not its split partials.
"""
from __future__ import annotations

from harness.weights import derived

# One NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).
HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12            # the fastest unit that takes fp32 operands
FP32_EXACT_FLOPS = 495e12 / 3  # 3xTF32: the fastest fp32-exact route
F32 = 4


def _attn_params(c: dict) -> int:
    """One attention block's matrices: q, k, v, o and the MLP."""
    D, F = c["d_model"], c["d_ff"]
    mult = 3 if c.get("act", "swiglu") in ("swiglu", "geglu") else 2
    return D * (c["q_dim"] + 2 * c["kv_dim"]) + c["q_dim"] * D + mult * D * F


def matmul_params(config: dict) -> tuple[int, int]:
    """(body, head): weights that enter a matrix product once per token,
    and the head's."""
    c = derived(config)
    return c["n_attn"] * _attn_params(c), c["d_model"] * c["padded_vocab"]


def weight_bytes(config: dict) -> int:
    """Bytes of the matrices a decode step reads once; norms and the
    embedding's rows are a small fraction and not counted."""
    return F32 * sum(matmul_params(config))


def kv_bytes(config: dict, ctx: int) -> int:
    """K and V of ``ctx`` tokens over every attention layer, read once."""
    c = derived(config)
    return 2 * F32 * ctx * c["kv_dim"] * c["n_attn"]


def decode_flops(config: dict, ctx: int) -> float:
    """One decode token at context ``ctx`` (incoming token included)."""
    c = derived(config)
    body, head = matmul_params(config)
    attn = 4.0 * ctx * c["q_dim"] * c["n_attn"]
    return 2.0 * (body + head) + attn


def prefill_flops(config: dict, S: int) -> float:
    """A prompt of ``S`` tokens, causal, logits at its last position."""
    c = derived(config)
    body, head = matmul_params(config)
    attn = 2.0 * S * (S + 1) * c["q_dim"] * c["n_attn"]
    return 2.0 * body * S + 2.0 * head + attn


def k1_work(config: dict, ctx: int) -> tuple[float, float]:
    """(bytes, flops) of K1 for one row at context ``ctx`` over every
    attention layer: live K and V once, q once, the merged output once;
    4 FLOP per (query head, live token, channel)."""
    c = derived(config)
    nbytes = kv_bytes(config, ctx) + 2 * F32 * c["q_dim"] * c["n_attn"]
    return float(nbytes), 4.0 * ctx * c["q_dim"] * c["n_attn"]


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak."""
    return max(nbytes / HBM_BYTES_S, flops / peak_flops)
