"""Deterministic synthetic token streams and request traces.

A numpy-only copy of ``repro/data/pipeline.py``:

* ``TrainPipeline`` — deterministic, resumable token batches for the
  training driver, seeded per (step, host) so a restart replays the exact
  stream; bit-equal to repro's for every (step, host);
* ``request_trace`` and ``LONGBENCH_STATS`` — serving request traces with
  the paper's LongBench length statistics; the same seed gives the same
  trace in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Table 2 of the paper: input context length statistics (Qwen tokenizer).
LONGBENCH_STATS = {
    "qmsum":    {"mean": 13966, "std": 6182, "max": 30456, "min": 2651},
    "hotpotqa": {"mean": 13465, "std": 3921, "max": 17674, "min": 1917},
    "musique":  {"mean": 16362, "std": 1651, "max": 17917, "min": 6820},
}


@dataclass
class TrainPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Deterministic batch for (step, host) — resumable by
        construction."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S = self.host_batch, self.seq_len
        # zipf-ish marginals so the loss has learnable structure
        ranks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        toks = (ranks % (self.vocab_size - 2)) + 2
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "mask": np.ones((B, S), np.float32),
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
