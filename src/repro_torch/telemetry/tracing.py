"""Per-request lifecycle tracing: queue -> admission -> prefill -> decode
-> (preempt/resume)* -> finish.

A copy of ``repro/telemetry/tracing.py`` (framework-free).

The engine and scheduler push timestamped events; the tracker folds them
into one ``RequestRecord`` per request, exported on finish (optionally as
JSONL) and summarized as percentiles. TTFT / TPOT / queue time are computed
from the same clock the engine's wall timings use, so the bench-reported
latencies and the telemetry records are one source of truth
(benchmarks/serving_bench.py reads its TTFT/TPOT straight from here).

The tracker implements the scheduler's ``events`` protocol (``on_admit`` /
``on_preempt`` / ``on_finish``) — the batcher calls it at the exact
bookkeeping points, no polling. All host-side; nothing here syncs the
device (token timestamps ride the horizon readback the engine already
pays for).
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field


@dataclass
class RequestRecord:
    req_id: int
    prompt_len: int = 0
    max_new_tokens: int = 0
    submit_t: float = 0.0
    admit_t: float | None = None        # first admission
    first_token_t: float | None = None
    last_token_t: float | None = None
    finish_t: float | None = None
    tokens: int = 0                     # emitted (prefill first + decode)
    preemptions: int = 0
    resumes: int = 0                    # re-admissions after preemption
    cached_tokens: int = 0              # prefix-cache KV reused at admission
    spec_proposed: int = 0
    spec_accepted: int = 0
    preempt_ts: list = field(default_factory=list)
    finished: bool = False
    # terminal-but-not-finished: torn down before a natural finish (client
    # abort / deadline / NaN quarantine / load shed); reason in abort_reason
    aborted: bool = False
    abort_reason: str | None = None
    # SLO identity, copied from the submission spec (serving.Request):
    # targets are what the client asked for; tenant/priority identify the
    # traffic class in per-tier goodput breakdowns
    priority: int = 0
    tenant: str | None = None
    ttft_slo_s: float | None = None
    tpot_slo_s: float | None = None

    # ---- derived latencies (seconds) ----------------------------------
    @property
    def queue_s(self) -> float | None:
        return None if self.admit_t is None else self.admit_t - self.submit_t

    @property
    def ttft_s(self) -> float | None:
        return (None if self.first_token_t is None
                else self.first_token_t - self.submit_t)

    @property
    def tpot_s(self) -> float | None:
        """Mean time per output token after the first (decode cadence)."""
        if self.first_token_t is None or self.last_token_t is None \
                or self.tokens < 2:
            return None
        return (self.last_token_t - self.first_token_t) / (self.tokens - 1)

    @property
    def slo_ok(self) -> bool:
        """SLO attainment: the request finished AND met every target it
        declared (unset targets are vacuously met; a request too short to
        have a TPOT is judged on TTFT alone). Aborted/shed requests never
        attain — goodput counts work the client actually got in time."""
        if not self.finished:
            return False
        if self.ttft_slo_s is not None and (
                self.ttft_s is None or self.ttft_s > self.ttft_slo_s):
            return False
        if self.tpot_slo_s is not None and self.tpot_s is not None \
                and self.tpot_s > self.tpot_slo_s:
            return False
        return True

    @property
    def accept_len_mean(self) -> float | None:
        rounds = getattr(self, "_spec_rounds", 0)
        if not rounds:
            return None
        return 1.0 + self.spec_accepted / rounds

    def as_dict(self) -> dict:
        d = asdict(self)
        d["queue_s"] = self.queue_s
        d["ttft_s"] = self.ttft_s
        d["tpot_s"] = self.tpot_s
        d["slo_ok"] = self.slo_ok
        d["spec_rounds"] = getattr(self, "_spec_rounds", 0)
        return d


def percentile(vals: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not vals:
        return 0.0
    vs = sorted(vals)
    k = max(0, min(len(vs) - 1, int(round(q / 100.0 * (len(vs) - 1)))))
    return vs[k]


class RequestTracker:
    """Folds engine/scheduler events into per-request records."""

    def __init__(self, registry=None, trace=None, log_path: str | None = None,
                 clock=None):
        self.live: dict[int, RequestRecord] = {}
        self.records: list[RequestRecord] = []
        self.trace = trace
        # injectable time source (the telemetry facade rebinds this to the
        # engine's clock at attach, so record timestamps live in the same
        # frame as the engine's deadlines — virtual or wall)
        self.clock = clock or time.perf_counter
        self._log = open(log_path, "w") if log_path else None
        r = registry
        if r is not None and r.enabled:
            self.h_ttft = r.histogram(
                "request_ttft_seconds", "submit -> first emitted token")
            self.h_tpot = r.histogram(
                "request_tpot_seconds", "mean inter-token time after the "
                "first token")
            self.h_queue = r.histogram(
                "request_queue_seconds", "submit -> first admission")
            self.c_finished = r.counter(
                "requests_finished_total", "requests run to completion")
            self.c_aborted = r.counter(
                "requests_aborted_total", "requests torn down before a "
                "natural finish (abort / deadline / quarantine / shed)")
            self.c_tokens = r.counter(
                "request_tokens_total", "tokens emitted across all requests")
            self.c_slo = r.counter(
                "requests_slo_attained_total", "finished requests that met "
                "every SLO target they declared")
            r.bind("requests_live", lambda: len(self.live),
                   "submitted requests not yet finished")
            r.bind("goodput", lambda: self.goodput(),
                   "fraction of closed requests that finished within their "
                   "SLO targets")
        else:
            from repro_torch.telemetry.registry import _NULL
            self.h_ttft = self.h_tpot = self.h_queue = _NULL
            self.c_finished = self.c_tokens = self.c_aborted = _NULL
            self.c_slo = _NULL

    # ---- engine-side events -------------------------------------------
    def on_submit(self, req_id: int, prompt_len: int, max_new: int,
                  t: float | None = None, spec=None) -> None:
        rec = self.live[req_id] = RequestRecord(
            req_id, prompt_len, max_new,
            submit_t=self.clock() if t is None else t)
        if spec is not None:
            rec.priority = getattr(spec, "priority", 0)
            rec.tenant = getattr(spec, "tenant", None)
            rec.ttft_slo_s = getattr(spec, "ttft_slo_s", None)
            rec.tpot_slo_s = getattr(spec, "tpot_slo_s", None)

    def on_first_token(self, req_id: int, t: float) -> None:
        rec = self.live.get(req_id)
        if rec is not None and rec.first_token_t is None:
            rec.first_token_t = t

    def on_tokens(self, req_id: int, n: int, t: float) -> None:
        rec = self.live.get(req_id)
        if rec is None or n <= 0:
            return
        rec.tokens += n
        rec.last_token_t = t
        if rec.first_token_t is None:
            rec.first_token_t = t
        self.c_tokens.inc(n)

    def on_spec(self, req_id: int, proposed: int, accepted: int) -> None:
        rec = self.live.get(req_id)
        if rec is None:
            return
        rec.spec_proposed += proposed
        rec.spec_accepted += accepted
        rec._spec_rounds = getattr(rec, "_spec_rounds", 0) + 1

    # ---- scheduler ``events`` protocol --------------------------------
    def on_admit(self, req, slot: int) -> None:
        rec = self.live.get(req.req_id)
        if rec is None:
            return
        t = self.clock()
        if rec.admit_t is None:
            rec.admit_t = t
        else:
            rec.resumes += 1
        rec.cached_tokens += int(getattr(req, "cached_len", 0))

    def on_preempt(self, req, slot: int) -> None:
        rec = self.live.get(req.req_id)
        if rec is None:
            return
        t = self.clock()
        rec.preemptions += 1
        rec.preempt_ts.append(t)
        if self.trace is not None:
            self.trace.instant(req.req_id, "preempt", t)

    def on_abort(self, req, slot: int, reason: str = "abort") -> None:
        """Terminal teardown without a natural finish (scheduler
        ``abort_slot`` / ``abort_queued``, engine shed). The record is
        closed and exported like a finish — aborted requests must appear in
        the JSONL log and summaries, not vanish — but flagged ``aborted``
        and excluded from the finished counter."""
        rec = self.live.pop(req.req_id, None)
        if rec is None:
            return
        t = self.clock()
        rec.aborted = True
        rec.abort_reason = reason
        rec.finish_t = t
        self.records.append(rec)
        self.c_aborted.inc()
        if self.trace is not None:
            self.trace.instant(req.req_id, f"abort:{reason}", t)
        if self._log is not None:
            self._log.write(json.dumps(rec.as_dict()) + "\n")
            self._log.flush()

    def on_finish(self, req, slot: int) -> None:
        rec = self.live.pop(req.req_id, None)
        if rec is None:
            return
        rec.finished = True
        rec.finish_t = rec.last_token_t or self.clock()
        self.records.append(rec)
        self.c_finished.inc()
        if rec.slo_ok:
            self.c_slo.inc()
        if rec.ttft_s is not None:
            self.h_ttft.observe(rec.ttft_s)
        if rec.tpot_s is not None:
            self.h_tpot.observe(rec.tpot_s)
        if rec.queue_s is not None:
            self.h_queue.observe(rec.queue_s)
        if self.trace is not None and rec.admit_t is not None:
            self.trace.request_span(rec.req_id, "queue", rec.submit_t,
                                    rec.admit_t)
            if rec.first_token_t is not None:
                self.trace.request_span(
                    rec.req_id, "prefill", rec.admit_t, rec.first_token_t,
                    args={"prompt_len": rec.prompt_len,
                          "cached_tokens": rec.cached_tokens})
                self.trace.request_span(
                    rec.req_id, "decode", rec.first_token_t, rec.finish_t,
                    args={"tokens": rec.tokens,
                          "preemptions": rec.preemptions})
        if self._log is not None:
            self._log.write(json.dumps(rec.as_dict()) + "\n")
            self._log.flush()

    # -------------------------------------------------------------------
    def goodput(self) -> float:
        """SLO attainment over closed (finished + aborted) records: the
        fraction that finished within every target they declared. Aborted
        and shed requests count against goodput — work the client never
        got, or got too late, is not good throughput. 0.0 before any
        request closes."""
        if not self.records:
            return 0.0
        return sum(1 for r in self.records if r.slo_ok) / len(self.records)

    def summary(self) -> dict:
        """Percentile summary over finished records (seconds -> ms).
        Aborted records are counted but excluded from the latency
        percentiles — a request torn down mid-stream has no meaningful
        TPOT, and including partial TTFTs would skew the SLO numbers a
        no-abort run reports."""
        recs = [r for r in self.records if r.finished]
        ttft = [r.ttft_s for r in recs if r.ttft_s is not None]
        tpot = [r.tpot_s for r in recs if r.tpot_s is not None]
        queue = [r.queue_s for r in recs if r.queue_s is not None]
        out = {"finished": len(recs),
               "aborted": sum(1 for r in self.records if r.aborted),
               "preemptions": sum(r.preemptions for r in recs),
               "tokens": sum(r.tokens for r in recs),
               "slo_attained": sum(1 for r in self.records if r.slo_ok),
               "goodput": self.goodput()}
        for name, vals in (("ttft", ttft), ("tpot", tpot), ("queue", queue)):
            if not vals:
                continue
            out[f"{name}_mean_ms"] = 1e3 * sum(vals) / len(vals)
            for q in (50, 90, 99):
                out[f"{name}_p{q}_ms"] = 1e3 * percentile(vals, q)
        return out

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None
