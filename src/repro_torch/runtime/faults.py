"""Deterministic, seeded fault injection for the serving engine.

A copy of ``repro/runtime/faults.py`` (framework-free): the same
hash, so one seed fires the same events in both packages.

Chaos testing only works if a failing run can be REPLAYED: every injection
decision here is a pure function of ``(seed, kind, tick, key)`` — a
splitmix-style integer hash, no RNG state, no call-order dependence — so
the same seed over the same trace fires the same faults at the same ticks
no matter how subsystems interleave their ``fire()`` calls. The injector
records every fired event (the chaos soak's uploaded artifact) and counts
per kind (telemetry's ``faults_*`` namespace reads them as pull bindings).

Fault kinds and where the engine wires them (see docs/robustness.md):

* ``alloc_exhaust`` — a request's per-tick page growth behaves as if the
  pool were dry: the scheduler preempts it (the real ``MemoryError`` path).
* ``swap_fail``    — a host-tier swap-in refuses; the radix match truncates
  at the last materializable node (prefill covers the rest).
* ``swap_stall``   — the cache's once-per-tick ``maintain()`` is skipped
  (the ping-pong drain stalls one tick).
* ``row_death``    — a serving row dies; its requests' KV is lost and they
  are drained into re-queued prefills via
  ``elastic.plan_request_migration``.
* ``nan_logits``   — a slot's collected horizon is treated as invalid
  (the NaN/garbage-logits case): the request is quarantined and terminal.
* ``slow_tick``    — a straggler tick: the host loop sleeps
  ``slow_tick_s`` (exercises watchdogs and overlap accounting).
* ``client_abort`` — a live request receives a client abort (the seeded
  stand-in for a user hanging up mid-stream).

Cluster-level kinds (fired by ``serving/cluster.py``'s router, not by an
engine — the cluster runs its own injector clock):

* ``engine_death``    — a pool engine dies at the tick boundary; its
  in-flight requests are re-routed (cold quiescent-frame re-prefill) or
  restored warm from the engine's last serving snapshot.
* ``handoff_torn``    — a cross-engine KV handoff is truncated in flight;
  the byte-stream length check rejects it and the router retries.
* ``handoff_corrupt`` — one byte of a handoff transfer flips; the manifest
  checksum rejects it before anything is applied.

Disabled fault injection is the shared ``NULL_FAULTS`` singleton:
``enabled`` is False and every ``fire()`` short-circuits — the engine's
outputs and device-sync count are bit-identical to a build without the
subsystem (tested), mirroring the telemetry NULL facade.
"""
from __future__ import annotations

from dataclasses import dataclass

KINDS = ("alloc_exhaust", "swap_fail", "swap_stall", "row_death",
         "nan_logits", "slow_tick", "client_abort",
         "engine_death", "handoff_torn", "handoff_corrupt")

_MASK = (1 << 64) - 1


def _hash01(seed: int, kind_ix: int, tick: int, key: int) -> float:
    """Uniform [0, 1) from the decision coordinates (splitmix64-style
    finalizer) — replayable regardless of call order."""
    h = (seed * 0x9E3779B97F4A7C15 + 0xD1B54A32D192ED03) & _MASK
    for v in (kind_ix + 1, tick + 1, key + 1):
        h = (h ^ (v & _MASK)) * 0xBF58476D1CE4E5B9 & _MASK
        h ^= h >> 31
    h = (h * 0x94D049BB133111EB) & _MASK
    h ^= h >> 29
    return (h >> 11) / float(1 << 53)


@dataclass
class FaultConfig:
    """Seeded fault plan. Probabilities are per decision point per tick
    (a kind whose probability is 0 never fires — an all-zero config is a
    live injector that never injects, useful for no-op identity tests)."""
    seed: int = 0
    alloc_exhaust_p: float = 0.0      # per (tick, growing request)
    swap_fail_p: float = 0.0          # per (tick, swap-in attempt)
    swap_stall_p: float = 0.0         # per tick
    row_death_p: float = 0.0          # per (tick, serving row)
    nan_logits_p: float = 0.0         # per (tick, collected slot)
    slow_tick_p: float = 0.0          # per tick
    slow_tick_s: float = 0.002        # straggler sleep when it fires
    client_abort_p: float = 0.0       # per (tick, live request)
    engine_death_p: float = 0.0       # per (tick, pool engine)
    handoff_torn_p: float = 0.0       # per (tick, handoff transmission)
    handoff_corrupt_p: float = 0.0    # per (tick, handoff transmission)
    start_tick: int = 0               # no injections before this tick
    max_faults: int = 0               # total fire budget (0 = unbounded)


class FaultInjector:
    """Live injector over a ``FaultConfig`` (see module docstring)."""

    enabled = True

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.tick = 0
        self.counts: dict[str, int] = {k: 0 for k in KINDS}
        self.total_fired = 0
        # fired-event log: the chaos soak's replay/debug artifact
        self.events: list[dict] = []
        self._p = {k: float(getattr(cfg, f"{k}_p")) for k in KINDS}
        self._ix = {k: i for i, k in enumerate(KINDS)}

    def on_tick(self) -> None:
        """Advance the injection clock — called once per engine tick."""
        self.tick += 1

    def fire(self, kind: str, key: int = 0) -> bool:
        """Deterministic injection decision for ``kind`` at the current
        tick, disambiguated by ``key`` (request id, row id, lookup count —
        anything deterministic across replays)."""
        p = self._p[kind]
        if p <= 0.0 or self.tick < self.cfg.start_tick:
            return False
        if self.cfg.max_faults and self.total_fired >= self.cfg.max_faults:
            return False
        if _hash01(self.cfg.seed, self._ix[kind], self.tick, int(key)) >= p:
            return False
        self.counts[kind] += 1
        self.total_fired += 1
        self.events.append({"kind": kind, "tick": self.tick,
                            "key": int(key)})
        return True


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


def make_faults(cfg) -> "FaultInjector | _NullFaults":
    """None/False -> the shared no-op; an injector passes through (so a
    driver can hand the same plan to several engines and read one event
    log); a ``FaultConfig`` builds a live injector."""
    if cfg is None or cfg is False:
        return NULL_FAULTS
    if isinstance(cfg, (FaultInjector, _NullFaults)):
        return cfg
    if isinstance(cfg, FaultConfig):
        return FaultInjector(cfg)
    raise TypeError(f"faults: expected FaultConfig/FaultInjector/None, "
                    f"got {type(cfg).__name__}")
