"""Unified telemetry for the serving stack.

A copy of ``repro/telemetry`` (framework-free host bookkeeping) wired
into the port's engine.

One facade object (``Telemetry``) wires the four pieces together and is
threaded through the engine as ``EngineConfig.telemetry``:

* ``registry``  — metrics registry (``telemetry.registry``): push
  instruments + pull bindings over the subsystems' existing counters,
  rendered as Prometheus text (served by ``telemetry.prom``);
* ``tracker``   — per-request lifecycle records (``telemetry.tracing``):
  TTFT / TPOT / queue time / preemptions / spec accepts, percentile
  summaries, optional JSONL export;
* ``trace``     — Chrome-trace/Perfetto tick timeline
  (``telemetry.chrome_trace``): host / prefill / dispatch / sync tracks
  plus the inferred device span, so DCS overlap is visible per tick;
* ``pim``       — live PIM counters (``telemetry.pim_counters``): modeled
  HBM bytes/token, DPA occupancy/waste, pow2-bucket high-water, channel
  utilization.

Disabled telemetry is the shared ``NULL`` singleton: ``enabled`` is False,
every event method is a bound no-op, the scheduler's ``events`` hook stays
unset and no binding, span or counter exists — the engine's behavior and
device-sync count are bit-identical to a build without telemetry (tested).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.telemetry.chrome_trace import TraceWriter, validate_trace
from repro_torch.telemetry.pim_counters import PIMCounters
from repro_torch.telemetry.registry import (LATENCY_BUCKETS, MetricsRegistry,
                                      NullRegistry, parse_exposition)
from repro_torch.telemetry.tracing import RequestRecord, RequestTracker, percentile

__all__ = [
    "TelemetryConfig", "Telemetry", "make_telemetry", "NULL",
    "MetricsRegistry", "NullRegistry", "parse_exposition", "LATENCY_BUCKETS",
    "TraceWriter", "validate_trace", "RequestTracker", "RequestRecord",
    "PIMCounters", "percentile",
]


@dataclass
class TelemetryConfig:
    metrics: bool = True              # registry + bindings + PIM counters
    trace: bool = False               # Perfetto tick timeline
    trace_path: str | None = None     # implies trace when set
    request_log: str | None = None    # JSONL per-request record export
    namespace: str = "repro"
    trace_max_events: int = 200_000
    pim_bytes_per_el: int = 2         # KV element width the PIM model uses


class Telemetry:
    """Live telemetry facade (see module docstring). Construct via
    ``make_telemetry`` so disabled configs collapse to the NULL no-op."""

    enabled = True

    def __init__(self, cfg: TelemetryConfig):
        self.cfg = cfg
        self.registry = (MetricsRegistry(cfg.namespace) if cfg.metrics
                         else NullRegistry(cfg.namespace))
        self.trace = (TraceWriter(cfg.trace_max_events)
                      if (cfg.trace or cfg.trace_path) else None)
        self.tracker = RequestTracker(self.registry, self.trace,
                                      cfg.request_log)
        self.pim: PIMCounters | None = None
        self._kv_bpt = 0.0

    # ------------------------------------------------------------------
    def attach_engine(self, engine) -> None:
        """Bind the engine's existing counters into the registry, build the
        PIM counters over its scheduler/allocator, and install the tracker
        as the scheduler's events hook. Called once from DecodeEngine
        construction; everything here is a pull binding — no hot-path cost,
        no device access."""
        engine.batcher.events = self.tracker
        # record timestamps must live in the engine's clock frame (virtual
        # clocks included), not the wall clock the tracker defaults to
        self.tracker.clock = engine.clock
        r = self.registry
        t = engine.timing
        r.bind("engine_steps_total", lambda: t.steps,
               "serving ticks run", kind="counter")
        r.bind("engine_device_syncs_total", lambda: t.device_syncs,
               "host<->device decode rendezvous", kind="counter")
        r.bind("engine_decode_tokens_total", lambda: t.decode_tokens,
               "tokens emitted by decode dispatches", kind="counter")
        r.bind("engine_host_seconds_total", lambda: t.host_s,
               "host scheduling + config-buffer assembly time",
               kind="counter")
        r.bind("engine_prefill_seconds_total", lambda: t.prefill_s,
               "prefill wall time", kind="counter")
        r.bind("engine_decode_seconds_total", lambda: t.decode_s,
               "decode dispatch + sync wall time", kind="counter")
        b = engine.batcher
        s = b.stats
        r.bind("sched_admitted_total", lambda: s.admitted,
               "requests admitted to slots", kind="counter")
        r.bind("sched_preempted_total", lambda: s.preempted,
               "requests preempted (pool exhausted)", kind="counter")
        r.bind("sched_priority_preempted_total",
               lambda: s.priority_preempted,
               "policy-driven preemptions for starved higher-priority "
               "requests (subset of sched_preempted_total)", kind="counter")
        r.bind("sched_completed_total", lambda: s.completed,
               "requests completed (EOS / budget)", kind="counter")
        r.bind("sched_dedup_deferred_total", lambda: s.dedup_deferred,
               "admissions deferred behind an in-flight same-prefix "
               "prefill", kind="counter")
        r.bind("sched_queue_depth", lambda: len(b.queue),
               "requests waiting for a slot")
        r.bind("sched_active_slots",
               lambda: sum(1 for x in b.slots if x is not None),
               "slots holding a request")
        r.bind("rstate_snapshots_total", lambda: engine.rstate_snapshots,
               "recurrent-state preemption snapshots taken", kind="counter")
        r.bind("rstate_restores_total", lambda: engine.rstate_restores,
               "recurrent-state snapshot restores", kind="counter")
        # ---- robustness namespace (PR 8): aborts / faults / degradation
        r.bind("sched_aborted_total", lambda: s.aborted,
               "requests torn down before a natural finish", kind="counter")
        r.bind("sched_migrated_total", lambda: s.migrated,
               "requests drained off dead rows into re-queued prefills",
               kind="counter")
        ab = engine.abort_counts
        for reason in ("client", "deadline", "nan", "shed", "chaos",
                       "handoff", "stale"):
            r.bind("aborts_total", lambda rr=reason: ab.get(rr, 0),
                   "terminal teardowns by reason", kind="counter",
                   labels={"reason": reason})
        r.bind("degraded_mode", lambda: engine.degraded_mode,
               "sticky degradation bitmask (1=horizon->1, 2=spec off, "
               "4=host tier dropped)")
        r.bind("engine_snapshot_saves_total",
               lambda: engine.snapshot_saves,
               "crash-consistent serving snapshots written", kind="counter")
        r.bind("engine_snapshot_restores_total",
               lambda: engine.snapshot_restores,
               "engine starts restored from a serving snapshot",
               kind="counter")
        r.bind("engine_snapshot_rejects_total",
               lambda: engine.snapshot_rejects,
               "torn/corrupt snapshot steps rejected before restore",
               kind="counter")
        if engine.faults.enabled:
            fc = engine.faults.counts
            r.bind("faults_injected_total",
                   lambda: engine.faults.total_fired,
                   "injected faults across all kinds", kind="counter")
            from repro_torch.runtime.faults import KINDS
            for kind in KINDS:
                r.bind("faults_total", lambda kk=kind: fc.get(kk, 0),
                       "injected faults by kind", kind="counter",
                       labels={"kind": kind})
        if engine.draft_cfg is not None:
            r.bind("spec_rounds_total", lambda: engine.spec_rounds,
                   "speculative verify passes", kind="counter")
            r.bind("spec_proposed_total", lambda: engine.spec_proposed,
                   "draft tokens proposed", kind="counter")
            r.bind("spec_accepted_total", lambda: engine.spec_accepted,
                   "draft tokens accepted", kind="counter")
        if r.enabled:
            self.pim = PIMCounters(r, engine.cfg, engine.batcher,
                                   bytes_per_el=self.cfg.pim_bytes_per_el)
            self._kv_bpt = self.pim.kv_bytes_per_token()

    # ---- engine-driven events (cheap host arithmetic only) ------------
    def on_submit(self, req_id: int, prompt_len: int, max_new: int,
                  t: float | None = None, spec=None) -> None:
        self.tracker.on_submit(req_id, prompt_len, max_new, t, spec=spec)

    def on_tokens(self, req_id: int, n: int, t: float) -> None:
        self.tracker.on_tokens(req_id, n, t)

    def on_spec(self, req_id: int, proposed: int, accepted: int) -> None:
        self.tracker.on_spec(req_id, proposed, accepted)

    def on_abort(self, req, slot: int, reason: str) -> None:
        """Engine-side terminal teardown (load shed happens before the
        scheduler ever sees the request, so the batcher's events hook
        can't cover it)."""
        self.tracker.on_abort(req, slot, reason)

    def on_horizon(self, token_ctx_sum: float) -> None:
        """One collected horizon: ``token_ctx_sum`` = sum over emitted
        tokens of the emitting slot's dispatch-time context length."""
        if self.pim is not None:
            self.pim.on_horizon(token_ctx_sum * self._kv_bpt)

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        return self.tracker.summary()

    def stats_line(self) -> str:
        """One-line periodic stats (serve.py's --stats-every)."""
        sm = self.summary()
        parts = [f"reqs={sm['finished']}", f"tokens={sm['tokens']}"]
        if "ttft_p50_ms" in sm:
            parts.append(f"ttft_p50={sm['ttft_p50_ms']:.1f}ms")
        if "tpot_p50_ms" in sm:
            parts.append(f"tpot_p50={sm['tpot_p50_ms']:.2f}ms")
        if self.registry.enabled:
            g = self.registry.get
            try:
                parts.append(f"pages={g('kv_pages_in_use', {'tier': 'device'}):.0f}")
                parts.append(f"chan_util={g('pim_channel_util'):.2f}")
            except KeyError:
                pass
        return "telemetry: " + " ".join(parts)

    def save_trace(self, path: str | None = None) -> int | None:
        if self.trace is None:
            return None
        return self.trace.save(path or self.cfg.trace_path)

    def close(self) -> None:
        self.tracker.close()


class _NullTelemetry:
    """Shared disabled singleton: same surface, every method a no-op, no
    registry entries, no scheduler events hook, no trace."""

    enabled = False
    trace = None
    tracker = None
    pim = None

    def __init__(self):
        self.cfg = TelemetryConfig(metrics=False)
        self.registry = NullRegistry()

    def attach_engine(self, engine) -> None:
        pass

    def on_submit(self, req_id, prompt_len, max_new, t=None,
                  spec=None) -> None:
        pass

    def on_tokens(self, req_id, n, t) -> None:
        pass

    def on_spec(self, req_id, proposed, accepted) -> None:
        pass

    def on_abort(self, req, slot, reason) -> None:
        pass

    def on_horizon(self, token_ctx_sum) -> None:
        pass

    def summary(self) -> dict:
        return {}

    def stats_line(self) -> str:
        return "telemetry: disabled"

    def save_trace(self, path=None):
        return None

    def close(self) -> None:
        pass


NULL = _NullTelemetry()


def make_telemetry(cfg) -> "Telemetry | _NullTelemetry":
    """None / falsy -> the shared no-op; an existing facade passes through
    (serve.py builds one and hands it to the engine); a config builds a
    live facade unless everything in it is off."""
    if cfg is None or cfg is False:
        return NULL
    if isinstance(cfg, (Telemetry, _NullTelemetry)):
        return cfg
    if isinstance(cfg, TelemetryConfig):
        if not (cfg.metrics or cfg.trace or cfg.trace_path
                or cfg.request_log):
            return NULL
        return Telemetry(cfg)
    if cfg is True:
        return Telemetry(TelemetryConfig())
    raise TypeError(f"telemetry: expected TelemetryConfig/bool/None, "
                    f"got {type(cfg).__name__}")
