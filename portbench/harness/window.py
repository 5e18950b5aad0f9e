"""What a run's measured window leaves for the metric readers.

A ``Track`` is one request as the benchmark saw it from outside the
engine: when it was due, and when its first and its last
token came back (the host clock after the tick or the collect that
brought them). ``Window`` holds the tracks, the engine's own timers and
counters at the window's two ends, and the device trace of a traced run.
The token counts at the two ends are taken on an idle card (the in-flight
horizon collected), so a token counted in the window was computed in it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Track:
    rid: int
    prompt_len: int
    max_new: int
    adopted: bool = False
    due_t: float | None = None        # open loop: scheduled arrival (abs)
    first_t: float | None = None
    last_t: float | None = None
    n: int = 0                        # tokens seen so far
    n_open: int = 0                   # tokens at the window's opening
    n_close: int = 0                  # tokens at its close
    first_in_window: bool = False

    @property
    def done(self) -> bool:
        return self.n >= self.max_new


@dataclass
class Window:
    seconds: float                    # wall time, opening to close
    t_open: float
    t_close: float
    config: dict
    tracks: list = field(default_factory=list)
    timing0: dict = field(default_factory=dict)
    timing1: dict = field(default_factory=dict)
    trace: object = None              # harness.trace.TraceSummary
    setup_s: float = 0.0

    def delta(self, key: str) -> float:
        return float(self.timing1[key]) - float(self.timing0[key])

    def output_tokens(self) -> int:
        return sum(t.n_close - t.n_open for t in self.tracks)

    def decode_spans(self):
        """(prompt_len, first, end) per track: the decode tokens of the
        window have output indices ``first .. end - 1``; the step emitting
        index j ran at context ``prompt_len + j`` (its incoming token
        included). Index 0 is the prefill's (or the handover's) token."""
        for t in self.tracks:
            a, b = max(t.n_open, 1), t.n_close
            if b > a:
                yield t.prompt_len, a, b

    def sum_over_ctx(self, fn) -> float:
        """Sum of ``fn(ctx)`` over every decode token of the window; ``fn``
        must be affine in ctx (the counts are)."""
        total = 0.0
        for P, a, b in self.decode_spans():
            n = b - a
            mean_ctx = P + (a + b - 1) / 2.0
            total += n * fn(mean_ctx)
        return total

    def prefilled(self) -> list:
        """Prompt lengths of the requests prefilled in the window."""
        return [t.prompt_len for t in self.tracks
                if t.first_in_window and not t.adopted]

    def due(self) -> list:
        """Open loop: the tracks due in the window."""
        return [t for t in self.tracks
                if t.due_t is not None and t.due_t < self.t_close]

    def ttfts(self) -> np.ndarray:
        """First token minus scheduled arrival, for every request due in
        the window; one still waiting counts the time it has waited."""
        return np.asarray([(t.first_t if t.first_t is not None
                            and t.first_t <= self.t_close else self.t_close)
                           - t.due_t for t in self.due()], dtype=np.float64)

    def tpots(self) -> np.ndarray:
        """(last - first) / (tokens - 1) over requests with >= 2 tokens."""
        return np.asarray([(t.last_t - t.first_t) / (t.n_close - 1)
                           for t in self.tracks if t.n_close >= 2
                           and t.first_t is not None], dtype=np.float64)
