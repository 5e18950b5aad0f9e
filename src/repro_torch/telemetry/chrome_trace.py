"""Chrome-trace/Perfetto exporter for the serving tick pipeline.

A copy of ``repro/telemetry/chrome_trace.py`` (framework-free).

The fused tick (docs/serving.md § tick pipeline) is a DCS ping-pong at host
granularity: next-tick host work overlaps device compute, and the only
rendezvous is the horizon's token readback. That story is invisible in
aggregate timings — this exporter renders it as a Trace Event JSON the
Perfetto UI (ui.perfetto.dev) or ``chrome://tracing`` loads directly:

* pid 1 "engine" holds one thread track per pipeline stage — ``host work``
  (schedule / config assembly / overlap-window work), ``prefill``,
  ``dispatch`` (non-blocking horizon dispatches), ``sync`` (the blocking
  readback) and ``device (inferred)``, an async span from each horizon's
  dispatch to its collect. Dispatch/compute overlap shows as host/prefill
  slices sitting strictly inside the inferred device span of the
  *previous* horizon.
* pid 2 "requests" holds per-request lifecycle spans (queue -> prefill ->
  decode) emitted at finish by ``tracing.RequestTracker``, plus instant
  markers for preemptions.

Events are buffered host-side (bounded; drops are counted, never silently)
and written once by ``save`` — nothing here touches the device.

The clocks: ``otherData.clock`` holds the writer's ``perf_counter`` zero
and ``time.time_ns()`` read back to back at construction. ``ts + time_ns
/ 1000`` is a slice's start in microseconds of the wall clock, the clock
``torch.profiler`` stamps its events on; in a profiler's exported trace,
whose ``ts`` counts from its ``baseTimeNanoseconds``, a slice starts at
``ts + (time_ns - baseTimeNanoseconds) / 1000``.
"""
from __future__ import annotations

import json
import time

ENGINE_PID = 1
REQUEST_PID = 2

# fixed tids so the track order in the UI tells the pipeline story
TRACKS = {"host": 1, "prefill": 2, "dispatch": 3, "sync": 4, "device": 5}
TRACK_NAMES = {1: "host work", 2: "prefill", 3: "dispatch (async)",
               4: "sync rendezvous", 5: "device (inferred)"}


class TraceWriter:
    """Bounded buffer of Trace Event dicts; timestamps are microseconds on
    the ``time.perf_counter`` clock, zeroed at construction so traces start
    near t=0 (``t0_ns``: the wall clock at that zero)."""

    def __init__(self, max_events: int = 200_000):
        self.t0 = time.perf_counter()
        self.t0_ns = time.time_ns()
        self.max_events = max_events
        self.dropped = 0
        self.events: list[dict] = []
        for tid, name in TRACK_NAMES.items():
            self._meta(ENGINE_PID, tid, name)
        self._meta_named = {ENGINE_PID}
        self.events.append({"name": "process_name", "ph": "M",
                            "pid": ENGINE_PID, "tid": 0,
                            "args": {"name": "engine"}})

    def _meta(self, pid: int, tid: int, name: str) -> None:
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    def _us(self, t: float) -> float:
        return (t - self.t0) * 1e6

    def _push(self, ev: dict) -> bool:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return False
        self.events.append(ev)
        return True

    # ------------------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter()

    def slice(self, track: str, name: str, t_start: float, dur_s: float,
              args: dict | None = None) -> None:
        """Complete ('X') slice on an engine pipeline track."""
        ev = {"name": name, "ph": "X", "pid": ENGINE_PID,
              "tid": TRACKS[track], "ts": self._us(t_start),
              "dur": max(dur_s, 0.0) * 1e6}
        if args:
            ev["args"] = args
        self._push(ev)

    def span(self, track: str, name: str, span_id: int, t_start: float,
             t_end: float, args: dict | None = None) -> None:
        """Async ('b'/'e') span — used for the inferred device-busy window,
        which OVERLAPS host slices (a complete event could not)."""
        b = {"name": name, "cat": track, "ph": "b", "id": span_id,
             "pid": ENGINE_PID, "tid": TRACKS[track],
             "ts": self._us(t_start)}
        if args:
            b["args"] = args
        if self._push(b):
            self._push({"name": name, "cat": track, "ph": "e", "id": span_id,
                        "pid": ENGINE_PID, "tid": TRACKS[track],
                        "ts": self._us(t_end)})

    def request_span(self, req_id: int, name: str, t_start: float,
                     t_end: float, args: dict | None = None) -> None:
        """Per-request lifecycle slice on the requests pid (one tid per
        request, so each request reads as its own timeline row)."""
        if REQUEST_PID not in self._meta_named:
            self.events.append({"name": "process_name", "ph": "M",
                                "pid": REQUEST_PID, "tid": 0,
                                "args": {"name": "requests"}})
            self._meta_named.add(REQUEST_PID)
        key = (REQUEST_PID, req_id)
        if key not in self._meta_named:
            self._meta(REQUEST_PID, req_id, f"req {req_id}")
            self._meta_named.add(key)
        ev = {"name": name, "ph": "X", "pid": REQUEST_PID, "tid": req_id,
              "ts": self._us(t_start),
              "dur": max(t_end - t_start, 0.0) * 1e6}
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, req_id: int, name: str, t: float) -> None:
        self._push({"name": name, "ph": "i", "s": "t", "pid": REQUEST_PID,
                    "tid": req_id, "ts": self._us(t)})

    # ------------------------------------------------------------------
    def to_doc(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "clock": {"perf_counter_s": self.t0,
                                        "time_ns": self.t0_ns}}}

    def save(self, path: str) -> int:
        """Write the JSON document; returns the event count."""
        with open(path, "w") as f:
            json.dump(self.to_doc(), f)
        return len(self.events)


# ---------------------------------------------------------------------------
# schema validation (tests + CI smoke)
# ---------------------------------------------------------------------------
_PHASES = {"X", "B", "E", "b", "e", "n", "i", "I", "M", "C", "s", "t", "f"}


def validate_trace(doc: dict) -> dict:
    """Validate a Trace Event JSON document the way Perfetto's importer
    would: traceEvents must be a list of dicts with name/ph/pid/tid, 'X'
    events need numeric ts+dur, async begin/end must pair up per id.
    Returns summary stats; raises ValueError on violations."""
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("trace: missing traceEvents list")
    tracks: set[tuple] = set()
    opens: dict[tuple, int] = {}
    n_slices = 0
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"trace[{i}]: not an object")
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"trace[{i}]: missing {k!r}: {ev}")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"trace[{i}]: unknown phase {ev['ph']!r}")
        if ev["ph"] == "M":
            continue
        if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
            raise ValueError(f"trace[{i}]: bad ts: {ev}")
        tracks.add((ev["pid"], ev["tid"]))
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"trace[{i}]: 'X' without dur: {ev}")
            n_slices += 1
        elif ev["ph"] == "b":
            key = (ev.get("cat"), ev.get("id"))
            opens[key] = opens.get(key, 0) + 1
        elif ev["ph"] == "e":
            key = (ev.get("cat"), ev.get("id"))
            if opens.get(key, 0) <= 0:
                raise ValueError(f"trace[{i}]: 'e' without open 'b': {ev}")
            opens[key] -= 1
    dangling = {k: v for k, v in opens.items() if v}
    if dangling:
        raise ValueError(f"trace: unclosed async spans: {dangling}")
    return {"events": len(doc["traceEvents"]), "slices": n_slices,
            "tracks": sorted(tracks)}
