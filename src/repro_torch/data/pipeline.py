"""Serving request traces with the paper's LongBench length statistics.

A numpy-only copy of ``request_trace`` and ``LONGBENCH_STATS`` from
``repro/data/pipeline.py``: the same seed gives the same trace in both
packages.
"""
from __future__ import annotations

import numpy as np

# Table 2 of the paper: input context length statistics (Qwen tokenizer).
LONGBENCH_STATS = {
    "qmsum":    {"mean": 13966, "std": 6182, "max": 30456, "min": 2651},
    "hotpotqa": {"mean": 13465, "std": 3921, "max": 17674, "min": 1917},
    "musique":  {"mean": 16362, "std": 1651, "max": 17917, "min": 6820},
}


def request_trace(task: str, n_requests: int, *, seed: int = 0,
                  max_context: int | None = None,
                  mean_new_tokens: int = 128) -> list[tuple[int, int]]:
    """[(prompt_len, max_new_tokens)] with the task's length distribution."""
    st = LONGBENCH_STATS[task]
    rng = np.random.default_rng(seed)
    lens = rng.normal(st["mean"], st["std"], size=n_requests)
    lens = np.clip(lens, st["min"], st["max"]).astype(np.int64)
    if max_context is not None:
        lens = np.minimum(lens, max_context - mean_new_tokens - 1)
    new = np.maximum(8, rng.poisson(mean_new_tokens, size=n_requests))
    return [(int(l), int(n)) for l, n in zip(lens, new)]
