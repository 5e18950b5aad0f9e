"""Injectable time sources for the serving stack.

A copy of ``repro/runtime/clock.py`` (framework-free).

The engine, scheduler and request tracker never call ``time.perf_counter``
directly any more — they read ``engine.clock`` (a zero-arg callable
returning seconds). The default is the wall clock; tests, trace replay and
the SLO bench inject a ``VirtualClock`` so deadline expiry, TTFT/TPOT and
goodput become deterministic functions of scheduling decisions alone (no
machine-speed dependence, no flaky deadline aborts under load).
"""
from __future__ import annotations

import time

#: the production default — module-level so call sites read one name
WALL_CLOCK = time.perf_counter


class VirtualClock:
    """Deterministic manual clock: time advances only when the driver says
    so. Callable (returns current virtual seconds), so it drops into any
    ``clock=`` slot interchangeably with ``time.perf_counter``."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        assert dt >= 0.0, dt
        self.t += float(dt)
        return self.t

    def advance_to(self, t: float) -> float:
        """Jump forward to absolute time ``t`` (no-op when in the past)."""
        self.t = max(self.t, float(t))
        return self.t
