"""Greedy token sampling for the serving engine.

Port of the greedy part of ``repro/serving/sampling.py``: argmax with the
first-index tie-break, as ``jnp.argmax`` and ``np.argmax`` do. Stochastic
kinds (temperature, top-k) wait for ROADMAP C.2 — JAX's threefry streams
cannot be matched token for token, so they need distribution tests first.
"""
from __future__ import annotations

import numpy as np
import torch


def _greedy_only(kind: str) -> None:
    if kind in ("temperature", "top_k"):
        raise NotImplementedError(
            f"sampler {kind!r}: stochastic sampling is not ported yet "
            "(ROADMAP C.2)")
    if kind != "greedy":
        raise ValueError(f"unknown sampler {kind!r}")


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """logits [..., V] -> int32 token ids [...] (first-max tie-break)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_scan_sampler(kind: str = "greedy"):
    """``logits [B, V] -> tokens [B]`` on the logits' device, for the
    fused multi-step decode (``models.model.decode_multi``)."""
    _greedy_only(kind)
    return greedy_sample


class Sampler:
    """Batch sampler: ``sampler(logits)`` -> np.int32 tokens. Accepts [V]
    or [B, V] logits (numpy or tensor)."""

    def __init__(self, kind: str = "greedy"):
        _greedy_only(kind)
        self.kind = kind

    def __call__(self, logits) -> np.ndarray:
        out = greedy_sample(torch.as_tensor(logits)).cpu().numpy()
        return out


def make_sampler(kind: str = "greedy") -> Sampler:
    return Sampler(kind)
