"""The port's telemetry against repro's, on the CPU, on a ``VirtualClock``.

Both engines read one virtual clock advanced by the same amount each tick,
so every timestamp is a function of scheduling alone and the records are
exact: the tracker's per-request records and summaries, and every registry
sample (engine, scheduler, cache and host-tier bindings, the live PIM
counters, the latency histograms) equal repro's, wall-clock seconds aside,
across prefill modes, horizons, preemption, speculative decoding and the
prefix cache with a host tier. Telemetry off and on give the same tokens,
device syncs and decode tokens; the port's trace and Prometheus exports
from ``launch.serve --trace-out --request-log --metrics-port 0`` pass
repro's own ``validate_trace`` and ``parse_exposition``. Under a
``torch.profiler`` run every phase of a tick is an ``engine.<name>`` span,
the readback apart from the fold, on the clock the trace's ``otherData``
pair maps the Perfetto slices onto; with no profiler recording, no span is
entered.
"""
import json
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JMDL
from repro.runtime.clock import VirtualClock as JaxClock
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro.telemetry import TelemetryConfig as JaxTelemetryConfig
from repro.telemetry import parse_exposition as jax_parse_exposition
from repro.telemetry import validate_trace as jax_validate_trace
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.clock import VirtualClock
from repro_torch.serving import DecodeEngine, EngineConfig, Request
from repro_torch.serving import engine as engine_mod
from repro_torch.telemetry import (NULL, Telemetry, TelemetryConfig,
                                   make_telemetry, parse_exposition,
                                   percentile, prom, validate_trace)
from repro_torch.telemetry.chrome_trace import ENGINE_PID, TRACKS

PAGE = 4
BUDGETS = [3, 12, 5, 12, 2, 9]
TICK_S = 0.01
# EngineTiming's wall-clock accumulators: the machine, not the workload
# (the serial host path and the launch are the port's own)
WALL = ("engine_host_seconds_total", "engine_prefill_seconds_total",
        "engine_decode_seconds_total", "engine_serial_host_seconds_total",
        "engine_launch_seconds_total")


@pytest.fixture(scope="module")
def models():
    jcfg = replace(jax_reduced(jax_get_config("llama3.2-1b")),
                   dtype="float32")
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    jp = JMDL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, jp, cfg, params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), "cpu")


def _run(models, which, K=4, mode="batched", *, telemetry=True, n_pages=96,
         cache=False, host_pages=0, budgets=BUDGETS, nreq=6, spec=False,
         trace=False, virtual=True):
    """Serve on a VirtualClock advanced TICK_S a tick (``virtual=False``:
    the wall clock, the trace's frame); returns (outputs, engine)."""
    jcfg, jp, cfg, params = models
    kw = dict(n_slots=3, page_size=PAGE, n_pages=n_pages, max_context=64,
              eos_token=-1, prefill_mode=mode, prefill_chunk=5,
              decode_horizon=1 if spec else K, prefix_cache=cache,
              host_pages=host_pages, spec_horizon=3)
    if which == "jax":
        clock = JaxClock() if virtual else None
        tel = JaxTelemetryConfig(metrics=True, trace=trace) \
            if telemetry else None
        eng = JaxEngine(jcfg, JaxEngineConfig(
            use_pallas=False, clock=clock, telemetry=tel,
            draft_config=jcfg if spec else None, **kw), jp,
            draft_params=jp if spec else None)
        req = JaxRequest
    else:
        clock = VirtualClock() if virtual else None
        tel = TelemetryConfig(metrics=True, trace=trace) \
            if telemetry else None
        eng = DecodeEngine(cfg, EngineConfig(
            clock=clock, telemetry=tel, draft_config=cfg if spec else None,
            **kw), params, device="cpu", draft_params=params if spec else None)
        req = Request
    rng = np.random.default_rng(3)
    for r in range(nreq):
        p = rng.integers(0, 256, size=int(rng.integers(3, 20)))
        eng.submit(req(r, p, budgets[r % len(budgets)]))
    for _ in range(3000):
        if eng._inflight is None and eng.batcher.done():
            break
        eng.tick()
        if clock is not None:
            clock.advance(TICK_S)
    return {k: list(v) for k, v in eng.outputs.items()}, eng


def _samples(eng) -> dict:
    return {k: v for k, v in eng.tel.registry.collect().items()
            if not any(w in k for w in WALL)}


def _records(eng) -> list:
    return [asdict(r) for r in eng.tel.tracker.records]


def _assert_matches_repro(models, **kw):
    jout, jeng = _run(models, "jax", **kw)
    out, eng = _run(models, "torch", **kw)
    assert out == jout
    assert _records(eng) == _records(jeng)
    assert eng.tel.summary() == jeng.tel.summary()
    assert _samples(eng) == _samples(jeng)
    return out, eng


# ---------------------------------------------------------------------------
# exactness against repro on the virtual clock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,mode", [(1, "batched"), (4, "slot"),
                                    (4, "batched"), (4, "chunked")])
def test_records_and_counters_match_repro(models, K, mode):
    """Per-request records, the summary and every registry sample (PIM
    counters included) equal repro's; and the registry equals the
    subsystems' own counters."""
    outs, eng = _assert_matches_repro(models, K=K, mode=mode)
    g = eng.tel.registry.get
    t, st = eng.timing, eng.batcher.stats
    assert g("engine_decode_tokens_total") == t.decode_tokens
    assert g("engine_device_syncs_total") == t.device_syncs
    assert g("sched_completed_total") == st.completed == len(outs)
    assert g("request_tokens_total") == sum(len(v) for v in outs.values())
    assert g("kv_pages_in_use", {"tier": "device"}) == 0
    for r in eng.tel.tracker.records:
        legacy = eng.first_tok_t[r.req_id] - eng.submit_t[r.req_id]
        assert r.ttft_s == legacy
    bpt = eng.tel.pim.kv_bytes_per_token()
    v = g("pim_modeled_hbm_bytes_total")
    assert v > 0 and v / bpt == round(v / bpt)


def test_preemption_counters_match_repro(models):
    outs, eng = _assert_matches_repro(models, n_pages=10, nreq=2,
                                      budgets=[12, 12])
    st = eng.batcher.stats
    assert st.preempted > 0 and st.completed == 2
    assert sum(r.preemptions for r in eng.tel.tracker.records) \
        == st.preempted


def test_spec_counters_match_repro(models):
    outs, eng = _assert_matches_repro(models, spec=True)
    assert eng.spec_accepted == eng.spec_proposed > 0
    assert eng.tel.registry.get("spec_accepted_total") == eng.spec_accepted


def test_cache_and_host_tier_counters_match_repro(models):
    outs, eng = _assert_matches_repro(models, cache=True, host_pages=16)
    g = eng.tel.registry.get
    assert g("kv_cache_lookups") == eng.cache.stats.lookups > 0
    assert g("kv_pages_total", {"tier": "host"}) == eng.cache.host.capacity


# ---------------------------------------------------------------------------
# no-op sink, dispatch, exports
# ---------------------------------------------------------------------------

def test_disabled_telemetry_identity(models):
    """Telemetry adds no rendezvous: tokens, device syncs and decode tokens
    equal with it off and on (trace included); off installs nothing."""
    base, e_off = _run(models, "torch", telemetry=False)
    got, e_on = _run(models, "torch", trace=True)
    assert got == base
    assert e_on.timing.device_syncs == e_off.timing.device_syncs
    assert e_on.timing.decode_tokens == e_off.timing.decode_tokens
    assert e_off.tel is NULL and not e_off.tel.enabled
    assert e_off.batcher.events is None
    assert e_off.tel.registry.render() == "\n"
    assert e_off.tel.save_trace() is None
    e_off.tel.close()


def test_make_telemetry_dispatch_and_percentile():
    assert make_telemetry(None) is NULL
    assert make_telemetry(False) is NULL
    assert make_telemetry(TelemetryConfig(metrics=False)) is NULL
    live = make_telemetry(TelemetryConfig(metrics=True))
    assert isinstance(live, Telemetry) and live.enabled
    assert make_telemetry(live) is live
    with pytest.raises(TypeError):
        make_telemetry(42)
    vs = [50.0, 10.0, 40.0, 20.0, 30.0]
    assert (percentile(vs, 0), percentile(vs, 50), percentile(vs, 100)) == \
        (10.0, 30.0, 50.0)
    with pytest.raises(ValueError):
        parse_exposition("# TYPE h histogram\nh_sum 1\nh_count 1\n")


def test_trace_has_pipeline_tracks(models):
    """Host / dispatch / sync slices on their tracks, the inferred device
    span a horizon, per-request spans: valid for repro's validator too.
    On the wall clock: the trace's timestamps are ``time.perf_counter``'s,
    and the request spans take the engine clock's, as in repro."""
    outs, eng = _run(models, "torch", K=8, trace=True, virtual=False)
    doc = eng.tel.trace.to_doc()
    info = validate_trace(doc)
    assert jax_validate_trace(doc) == info
    for track in ("host", "dispatch", "sync", "device"):
        assert (ENGINE_PID, TRACKS[track]) in info["tracks"], track
    dev = [e for e in doc["traceEvents"]
           if e.get("ph") == "b" and e.get("tid") == TRACKS["device"]]
    assert len(dev) == eng.timing.device_syncs
    req = {e["name"] for e in doc["traceEvents"]
           if e.get("pid") != ENGINE_PID and e.get("ph") == "X"}
    assert {"queue", "prefill", "decode"} <= req


def test_serve_exports_pass_repro_validators(tmp_path):
    """``launch.serve --device cpu --metrics-port 0 --trace-out
    --request-log``: repro's ``parse_exposition`` accepts the scraped
    Prometheus text, repro's ``validate_trace`` the Perfetto file, and the
    request log reconciles with the registry."""
    trace_path = tmp_path / "t.perfetto.json"
    log_path = tmp_path / "records.jsonl"
    n = 6
    serve.main(["--requests", str(n), "--slots", "3", "--pages", "48",
                "--page", "8", "--max-context", "128", "--mean-new", "8",
                "--prefill-mode", "chunked", "--chunk", "16",
                "--decode-horizon", "4", "--device", "cpu",
                "--metrics-port", "0", "--trace-out", str(trace_path),
                "--request-log", str(log_path)])
    srv = prom.LAST_SERVER
    assert srv is not None
    try:
        text = srv.scrape()
    finally:
        assert srv.close()
    samples = jax_parse_exposition(text)
    assert samples == parse_exposition(text)
    for required in ("repro_engine_decode_tokens_total",
                     "repro_engine_device_syncs_total",
                     'repro_kv_pages_total{tier="device"}',
                     "repro_pim_modeled_hbm_bytes_total",
                     "repro_pim_channel_util",
                     "repro_request_ttft_seconds_count"):
        assert required in samples, required
    assert samples["repro_requests_finished_total"] == n
    info = jax_validate_trace(json.loads(trace_path.read_text()))
    for track in ("host", "dispatch", "sync", "device"):
        assert (ENGINE_PID, TRACKS[track]) in info["tracks"], track
    recs = [json.loads(x) for x in log_path.read_text().splitlines() if x]
    assert len(recs) == n and all(r["finished"] for r in recs)
    assert sum(r["tokens"] for r in recs) == \
        samples["repro_request_tokens_total"]


# ---------------------------------------------------------------------------
# the tick's phases as profiler spans, and the serial host path
# ---------------------------------------------------------------------------

SERIAL = ("fold", "faults", "schedule", "config", "dispatch")


@pytest.fixture(scope="module")
def profiled(models):
    """A horizon-4 serve with the Perfetto trace on, under a CPU profiler:
    (outputs, engine, the ``engine.*`` spans as (name, start_ns, end_ns)
    in start order)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs, eng = _run(models, "torch", K=4, trace=True, virtual=False,
                         nreq=4)
    spans = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("engine."))
    return outs, eng, sorted(spans, key=lambda x: x[1])


def _ticks(items, start):
    """Split time-ordered (name, start, end) items into ticks, each opened
    by its ``start`` item."""
    ticks = []
    for it in items:
        if it[0] == start:
            ticks.append([])
        if ticks:
            ticks[-1].append(it)
    return ticks


def test_profiler_spans_hold_each_phase(profiled):
    """Each tick that collected a horizon and dispatched the next holds
    ``engine.collect``, ``.fold``, ``.schedule``, ``.config`` and
    ``.dispatch`` in that order, one after another; the launch lies inside
    the dispatch."""
    _, eng, spans = profiled
    top = [s for s in spans if s[0] != "engine.launch"]
    launches = [s for s in spans if s[0] == "engine.launch"]
    ticks = _ticks(top, "engine.overlap")
    assert len(ticks) == eng.timing.steps
    full = [t for t in ticks if {"engine.collect", "engine.dispatch"}
            <= {n for n, _, _ in t}]
    assert len(full) >= 3
    want = ["engine." + n for n in ("collect", "fold", "schedule", "config",
                                    "dispatch")]
    for t in full:
        assert [n for n, _, _ in t if n in want] == want
        for (_, _, end), (_, start, _) in zip(t, t[1:]):
            assert end <= start
    dispatches = [s for s in top if s[0] == "engine.dispatch"]
    assert len(launches) == len(dispatches) == eng.timing.device_syncs
    for (_, s0, e0), (_, s1, e1) in zip(dispatches, launches):
        assert s0 <= s1 <= e1 <= e0


def test_trace_clock_pair_lines_up_with_profiler(profiled):
    """``otherData.clock`` puts each Perfetto ``dispatch`` slice within 2 ms
    of the profiler's ``engine.dispatch`` span of the same tick."""
    _, eng, spans = profiled
    doc = eng.tel.trace.to_doc()
    clock = doc["otherData"]["clock"]
    assert clock["perf_counter_s"] == eng.tel.trace.t0
    offset_us = clock["time_ns"] / 1000
    slices = [e["ts"] + offset_us for e in doc["traceEvents"]
              if e.get("ph") == "X" and e["name"] == "dispatch"]
    prof = [s / 1000 for n, s, _ in spans if n == "engine.dispatch"]
    assert len(slices) == len(prof) > 0
    assert max(abs(a - b) for a, b in zip(slices, prof)) < 2000


def test_serial_and_launch_counters(profiled):
    """``serial_s`` covers the fold, faults, schedule, config and dispatch
    of every tick that dispatched; ``launch_s`` lies inside it; the fold
    is timed apart from the readback."""
    _, eng, _ = profiled
    doc = eng.tel.trace.to_doc()
    sl = sorted(((e["name"], e["ts"], e["ts"] + e["dur"])
                 for e in doc["traceEvents"] if e.get("ph") == "X"
                 and e.get("pid") == ENGINE_PID), key=lambda x: x[1])
    phases = 0.0
    for t in _ticks(sl, "overlap"):
        if any(n == "dispatch" for n, _, _ in t):
            phases += sum(e - s for n, s, e in t if n in SERIAL) / 1e6
    T = eng.timing
    assert phases > 0
    assert T.serial_s >= phases - 1e-9
    assert 0 < T.launch_s <= T.serial_s
    assert T.fold_s > 0
    g = eng.tel.registry.get
    assert g("engine_serial_host_seconds_total") == T.serial_s
    assert g("engine_launch_seconds_total") == T.launch_s


def test_no_span_without_profiler(models, profiled, monkeypatch):
    """With no profiler recording the tick enters no span; tokens and
    device syncs equal an engine's without telemetry, and the profiled
    engine's."""
    made, span = [], engine_mod._Span

    def counting(name):
        made.append(name)
        return span(name)

    monkeypatch.setattr(engine_mod, "_Span", counting)
    got, eng = _run(models, "torch", K=4, trace=True, virtual=False,
                    nreq=4)
    assert made == []
    base, e_off = _run(models, "torch", K=4, telemetry=False, nreq=4)
    p_out, p_eng, _ = profiled
    assert got == base == p_out
    assert eng.timing.device_syncs == e_off.timing.device_syncs \
        == p_eng.timing.device_syncs
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with eng._phase("host_s", "host", "schedule"):
            pass
    assert made == ["engine.schedule"]
