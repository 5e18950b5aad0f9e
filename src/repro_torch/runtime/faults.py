"""The disabled fault injector the scheduler consults.

``core/scheduler.py`` asks ``self.faults.enabled`` / ``fire(kind, key)`` at
its decision points. The port serves without fault injection, so only the
shared no-op singleton of ``repro/runtime/faults.py`` is carried over:
``enabled`` is False and ``fire`` always declines.
"""
from __future__ import annotations


class _NullFaults:
    """Shared disabled singleton: ``fire`` always declines, counters stay
    empty, ``on_tick`` is a no-op — zero work on the hot path."""

    enabled = False
    tick = 0
    total_fired = 0
    counts: dict[str, int] = {}
    events: list = []

    def on_tick(self) -> None:
        pass

    def fire(self, kind: str, key: int = 0) -> bool:
        return False


NULL_FAULTS = _NullFaults()
