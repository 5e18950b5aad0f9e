"""Deterministic seeded workload generator + trace replay for the SLO
serving bench.

The paper's long-context setting implies bursty, heavy-tailed,
multi-tenant traffic; all earlier benches drove synthetic steady-state
waves. This module generates *arrival traces* — request submit times,
per-tenant priority tiers and TTFT/TPOT targets, heavy-tail prompt/output
lengths, shared-prefix prompt families, and mid-stream client aborts —
as plain JSON, committed under ``benchmarks/traces/`` so every CI run
replays the identical workload.

Determinism contract: the trace stores *descriptions* (lengths, seeds,
groups), not token arrays; ``prompt_tokens`` materializes the same tokens
from (trace seed, prefix group, suffix seed) every time. Replay drives a
``repro_torch.runtime.clock.VirtualClock``: between engine ticks the clock advances by
a fixed modeled tick cost, so TTFT/TPOT/goodput are deterministic
functions of scheduling decisions alone — no machine-speed dependence.

The port's copy of ``benchmarks/workload.py`` (generator, trace loading,
prompt materialization and replay; its CLI and ``save_trace`` stay there):
``generate(default_slo_config())`` equals the committed
``benchmarks/traces/slo_default.json``.
"""
from __future__ import annotations

import json
import zlib
from dataclasses import asdict, dataclass, field

import numpy as np

from repro_torch.serving.request import Request

TRACE_VERSION = 1


@dataclass
class TenantSpec:
    """One traffic class: arrival share, priority tier, SLO targets and
    length distributions (lognormal — heavy right tail, the long-context
    shape LoL-PIM/L3 evaluate under)."""
    name: str
    weight: float = 1.0
    priority: int = 0
    ttft_slo_s: float | None = None     # submit -> first token target
    tpot_slo_s: float | None = None     # decode cadence target
    deadline_s: float | None = None     # hard teardown budget (0/None = off)
    # lognormal prompt-length params (of ln tokens) + clamp
    prompt_mu: float = 3.0
    prompt_sigma: float = 0.6
    prompt_min: int = 4
    prompt_max: int = 96
    # lognormal output-budget params + clamp
    new_mu: float = 2.2
    new_sigma: float = 0.5
    new_min: int = 2
    new_max: int = 24
    # shared-prefix families: each request draws one of ``n_groups``
    # prefix groups; ``prefix_frac`` of its prompt is the group's shared
    # run (radix-cache bait). 0 groups = fully cold prompts.
    n_groups: int = 0
    prefix_frac: float = 0.5


@dataclass
class WorkloadConfig:
    seed: int = 0
    n_requests: int = 48
    arrival: str = "poisson"            # "poisson" | "bursty"
    rate_rps: float = 40.0              # mean arrival rate
    # bursty: Markov-modulated on/off Poisson — bursts of ~burst_len
    # arrivals at burst_factor x rate, separated by idle gaps
    burst_len: int = 8
    burst_factor: float = 6.0
    # mid-stream client aborts: fraction of requests cancelled at
    # submit + U(abort_min_s, abort_max_s)
    abort_frac: float = 0.0
    abort_min_s: float = 0.05
    abort_max_s: float = 0.5
    vocab: int = 0                      # 0 = engine decides at replay
    tenants: list = field(default_factory=list)


def _draw_len(rng, mu, sigma, lo, hi) -> int:
    return int(np.clip(round(float(rng.lognormal(mu, sigma))), lo, hi))


def _arrival_times(rng, cfg: WorkloadConfig) -> np.ndarray:
    n = cfg.n_requests
    if cfg.arrival == "poisson":
        gaps = rng.exponential(1.0 / cfg.rate_rps, size=n)
    elif cfg.arrival == "bursty":
        # on/off modulation: within a burst, gaps shrink by burst_factor;
        # between bursts, one long idle gap restores the mean rate
        gaps = np.empty(n)
        i = 0
        while i < n:
            blen = min(n - i, 1 + int(rng.geometric(1.0 / cfg.burst_len)))
            gaps[i:i + blen] = rng.exponential(
                1.0 / (cfg.rate_rps * cfg.burst_factor), size=blen)
            i += blen
            if i < n:
                gaps[i - 1] += rng.exponential(
                    cfg.burst_len / cfg.rate_rps)
        assert i == n
    else:
        raise ValueError(f"unknown arrival process {cfg.arrival!r}")
    return np.cumsum(gaps)


def generate(cfg: WorkloadConfig) -> dict:
    """Build a trace dict (JSON-serializable) from a seeded config. Every
    draw comes from one ``default_rng(seed)`` stream in a fixed order, so
    the same config always yields byte-identical traces."""
    assert cfg.tenants, "WorkloadConfig needs at least one TenantSpec"
    tenants = [t if isinstance(t, TenantSpec) else TenantSpec(**t)
               for t in cfg.tenants]
    rng = np.random.default_rng(cfg.seed)
    times = _arrival_times(rng, cfg)
    weights = np.asarray([t.weight for t in tenants], float)
    weights /= weights.sum()
    events = []
    for i in range(cfg.n_requests):
        t = tenants[int(rng.choice(len(tenants), p=weights))]
        plen = _draw_len(rng, t.prompt_mu, t.prompt_sigma,
                         t.prompt_min, t.prompt_max)
        mnew = _draw_len(rng, t.new_mu, t.new_sigma, t.new_min, t.new_max)
        group = int(rng.integers(t.n_groups)) if t.n_groups else -1
        prefix_len = int(plen * t.prefix_frac) if group >= 0 else 0
        ev = {"t": round(float(times[i]), 6), "kind": "submit",
              "req_id": i, "tenant": t.name, "priority": t.priority,
              "prompt_len": plen, "max_new": mnew,
              "prefix_group": group, "prefix_len": prefix_len,
              "suffix_seed": int(rng.integers(1 << 31)),
              "ttft_slo_s": t.ttft_slo_s, "tpot_slo_s": t.tpot_slo_s,
              "deadline_s": t.deadline_s}
        events.append(ev)
        if cfg.abort_frac and rng.random() < cfg.abort_frac:
            dt = float(rng.uniform(cfg.abort_min_s, cfg.abort_max_s))
            events.append({"t": round(ev["t"] + dt, 6), "kind": "abort",
                           "req_id": i})
    events.sort(key=lambda e: (e["t"], e["req_id"],
                               0 if e["kind"] == "submit" else 1))
    return {"trace": "slo-workload", "version": TRACE_VERSION,
            "seed": cfg.seed, "config": asdict(cfg), "events": events}


def load_trace(path: str) -> dict:
    with open(path) as f:
        trace = json.load(f)
    assert trace.get("version") == TRACE_VERSION, trace.get("version")
    return trace


# ---------------------------------------------------------------------
def prompt_tokens(trace: dict, ev: dict, vocab: int) -> np.ndarray:
    """Materialize a submit event's prompt tokens: the shared prefix is a
    pure function of (trace seed, tenant, prefix group) — every request in
    the group opens with the identical run, so the radix cache shares it —
    and the suffix of the event's own ``suffix_seed``. Tokens stay in
    [1, vocab) so an ``eos_token=0`` engine never sees a natural EOS."""
    seed = int(trace["seed"])
    plen, k = ev["prompt_len"], ev["prefix_len"]
    out = np.empty((plen,), np.int32)
    if k:
        grng = np.random.default_rng(
            [seed, zlib.crc32(ev["tenant"].encode()), ev["prefix_group"]])
        out[:k] = grng.integers(1, vocab, size=k)
    srng = np.random.default_rng([seed, ev["suffix_seed"]])
    out[k:] = srng.integers(1, vocab, size=plen - k)
    return out


def request_of(trace: dict, ev: dict, vocab: int):
    """submit event -> serving.Request spec."""
    return Request(ev["req_id"], prompt_tokens(trace, ev, vocab),
                   ev["max_new"], deadline_s=ev.get("deadline_s"),
                   priority=ev.get("priority", 0),
                   ttft_slo_s=ev.get("ttft_slo_s"),
                   tpot_slo_s=ev.get("tpot_slo_s"),
                   tenant=ev.get("tenant"),
                   prefix_group=ev.get("prefix_group"))


def replay(trace: dict, eng, clock, *, tick_s: float, vocab: int,
           max_ticks: int = 200_000) -> dict:
    """Replay a trace against an engine on a virtual clock: deliver every
    event whose time has come, run one engine tick, advance the clock by
    the modeled per-tick cost. When the engine is idle the clock jumps to
    the next arrival (no idle-spinning ticks). Returns deterministic
    replay counters; latencies/goodput come from the engine's telemetry.
    """
    evs = trace["events"]
    i, n = 0, len(evs)
    c = {"arrivals": 0, "accepted": 0, "shed": 0, "abort_events": 0,
         "ticks": 0}
    while True:
        now = clock()
        while i < n and evs[i]["t"] <= now + 1e-12:
            ev = evs[i]
            i += 1
            if ev["kind"] == "submit":
                c["arrivals"] += 1
                if eng.submit(request_of(trace, ev, vocab)):
                    c["accepted"] += 1
                else:
                    c["shed"] += 1
            else:
                c["abort_events"] += 1
                eng.abort(ev["req_id"], "client")
        idle = eng.batcher.done() and eng._inflight is None
        if idle:
            if i >= n:
                break
            clock.advance_to(evs[i]["t"])
            continue
        eng.tick()
        clock.advance(tick_s)
        c["ticks"] += 1
        if c["ticks"] > max_ticks:
            raise RuntimeError(f"replay exceeded {max_ticks} ticks")
    c["virtual_s"] = round(clock(), 6)
    return c


# ---------------------------------------------------------------------
def default_slo_config() -> WorkloadConfig:
    """The committed two-tenant overload mix (traces/slo_default.json):
    an interactive tier (tight TTFT, short prompts, priority 2) sharing
    the engine with a batch tier (long heavy-tail prompts, loose SLOs,
    priority 0) at an offered load that forces queueing — the shape where
    FCFS head-of-line blocking kills interactive goodput and SLO-aware
    admission + preemption recovers it."""
    return WorkloadConfig(
        seed=7, n_requests=48, arrival="bursty", rate_rps=60.0,
        burst_len=6, burst_factor=8.0,
        abort_frac=0.10, abort_min_s=0.3, abort_max_s=0.9,
        tenants=[
            TenantSpec("interactive", weight=3.0, priority=2,
                       ttft_slo_s=0.18, tpot_slo_s=0.035,
                       prompt_mu=2.8, prompt_sigma=0.45,
                       prompt_min=4, prompt_max=48,
                       new_mu=1.9, new_sigma=0.4, new_min=2, new_max=12,
                       n_groups=3, prefix_frac=0.5),
            TenantSpec("batch", weight=1.0, priority=0,
                       ttft_slo_s=1.5, tpot_slo_s=0.08,
                       prompt_mu=4.0, prompt_sigma=0.5,
                       prompt_min=24, prompt_max=96,
                       new_mu=3.2, new_sigma=0.3, new_min=16, new_max=32,
                       n_groups=1, prefix_frac=0.4),
        ])
