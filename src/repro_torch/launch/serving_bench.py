"""Serving throughput and host overhead per prefill mode and decode horizon,
through the port's engine.

    python -m repro_torch.launch.serving_bench --device cpu --json serving.json

The port's counterpart of ``benchmarks/serving_bench.py``: the same seeded
trace, engine configurations and sections, and the same 12 rows in the same
order, with the same keys and ``trace`` tags as ``BENCH_serving.json``:

* ``prefill`` — reduced llama3.2-1b in slot, batched and chunked prefill
  (8 requests of 8-63 tokens, 8 new each), horizon 1;
* ``decode`` — the decode-dominated trace (64 new tokens) in batched prefill
  at fused horizons 1, 4 and 8;
* ``recurrent`` — reduced xlstm-350m in slot, batched and chunked prefill;
* ``disagg`` — a 1 prefill + 1 decode ``EngineCluster`` over the prefill
  trace (``disagg_1p1d``), with the router's handoff counters;
* ``spec`` (``--draft``, the default) — the oracle pair
  (``models.convert.oracle_draft_pair``: the target's layers past the first
  write back zeros, the draft is its 1-layer slice) at horizon 8 alone and
  with speculative decoding at ``SPEC_HORIZON``.

The bench's own checks hold as in the reference: greedy outputs equal across
the prefill modes, the horizons, the cluster and speculative decoding; every
handoff applied; the oracle's mean accept length above 1.
``benchmarks/check_regression.py --baseline BENCH_serving.json`` reads the
JSON: its counters (``tokens``, ``syncs_per_token``, ``accept_len_mean``,
the robustness and handoff counters) are functions of the trace and the
scheduling alone, so they must equal the baseline's; its normalized timings
compare each row with its section's first row.

Weights are the port's seeded ``init_params`` (seed 0) at the reduced
configurations; with EOS off and the oracle accepting every proposal by
construction, the counters do not depend on them. The engines run on the
card unless ``--device cpu``; without a card ``cuda`` raises. ``--smoke``
shrinks the trace (4 requests, 6 new tokens, 1 warm-up request).
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import model as MDL
from repro_torch.models.convert import oracle_draft_pair
from repro_torch.serving import (ClusterConfig, DecodeEngine, EngineCluster,
                                 EngineConfig, Request)
from repro_torch.telemetry import TelemetryConfig
from repro_torch.telemetry.tracing import percentile

HORIZONS = (1, 4, 8)
SPEC_HORIZON = 15


class Weights:
    """The bench's weights on one device, built on first use: each arch's
    reduced fp32 configuration with seeded params, and the oracle pair."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._plain: dict[str, tuple] = {}
        self._oracle: dict[str, tuple] = {}

    def plain(self, arch: str):
        """``(cfg, params)``."""
        if arch not in self._plain:
            cfg = replace(reduced(get_config(arch)), dtype="float32")
            self._plain[arch] = (cfg, MDL.init_params(cfg, 0, torch.float32,
                                                      self.device))
        return self._plain[arch]

    def oracle(self, arch: str):
        """``(cfg, target_params, draft_cfg, draft_params)``."""
        if arch not in self._oracle:
            cfg, params = self.plain(arch)
            self._oracle[arch] = (cfg, *oracle_draft_pair(cfg, params))
        return self._oracle[arch]


def _engine_config(mode: str, **kw) -> EngineConfig:
    return EngineConfig(n_slots=4, page_size=8, n_pages=160, max_context=128,
                        eos_token=-1, prefill_mode=mode, **kw)


def bench(mode: str, *, weights: Weights, arch: str = "llama3.2-1b",
          requests: int = 8, chunk: int = 16, horizon: int = 1,
          new_tokens: int = 8, max_prompt: int = 64, warmup: int = 2,
          oracle: bool = False, spec: int | None = None) -> dict:
    """One engine over the seeded trace (``benchmarks/serving_bench.py::
    bench``). ``warmup`` requests (ids >= 1000) run first, so the timed
    phase measures steady-state dispatch, not first calls and graph
    captures; decode throughput is the timed phase's decode tokens over
    its non-prefill wall. ``oracle`` swaps in the oracle target (and
    replays the timed trace's own lengths as warm-up); ``spec`` adds its
    draft at that proposal horizon."""
    if oracle or spec is not None:
        cfg, params, dcfg, dparams = weights.oracle(arch)
    else:
        cfg, params = weights.plain(arch)
        dcfg = dparams = None
    ecfg = _engine_config(
        mode, prefill_chunk=chunk, decode_horizon=horizon,
        draft_config=dcfg if spec is not None else None,
        spec_horizon=spec if spec is not None else 4,
        telemetry=TelemetryConfig(metrics=True))
    eng = DecodeEngine(cfg, ecfg, params, device=weights.device,
                       draft_params=dparams if spec is not None else None)
    wlens = None
    if oracle or spec is not None:
        rng = np.random.default_rng(0)
        wlens = [int(rng.integers(8, max_prompt)) for _ in range(requests)]
    rng = np.random.default_rng(7)
    for i in range(warmup if wlens is None else len(wlens)):
        n = wlens[i] if wlens is not None else int(rng.integers(8, max_prompt))
        eng.submit(Request(1000 + i, rng.integers(0, cfg.vocab_size, size=n),
                           new_tokens))
    eng.run(10_000)
    tm0 = dict(eng.timing.as_dict())
    rng = np.random.default_rng(0)
    for i in range(requests):
        plen = int(rng.integers(8, max_prompt))
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, size=plen),
                           new_tokens))
    t0 = time.perf_counter()
    eng.run(10_000)
    dt = time.perf_counter() - t0
    outs = {k: v for k, v in eng.outputs.items() if k < 1000}
    toks = sum(len(v) for v in outs.values())
    tm = eng.timing.as_dict()
    dtoks = tm["decode_tokens"] - tm0["decode_tokens"]
    dpre = tm["prefill_s"] - tm0["prefill_s"]
    syncs = tm["device_syncs"] - tm0["device_syncs"]
    # latencies from the telemetry records; the engine's first_tok_t /
    # submit_t must agree exactly (one clock)
    recs = [r for r in eng.tel.tracker.records if r.req_id < 1000]
    assert len(recs) == len(outs), (len(recs), len(outs))
    for r in recs:
        legacy = eng.first_tok_t[r.req_id] - eng.submit_t[r.req_id]
        assert abs(r.ttft_s - legacy) < 1e-9, (r.req_id, r.ttft_s, legacy)
    ttft = [r.ttft_s for r in recs]
    tpot = [r.tpot_s for r in recs if r.tpot_s is not None]
    extra = {}
    if spec is not None:
        # draft-overhead fraction: the param-weighted share of forward work
        # spent proposing (draft steps against target verify positions)
        pd = MDL.param_count_actual(dparams)
        pt = MDL.param_count_actual(params)
        dwork = eng.spec_proposed * pd
        twork = (eng.spec_proposed + eng.spec_rounds) * pt
        extra = {"accept_len_mean":
                 1 + eng.spec_accepted / max(1, eng.spec_rounds),
                 "spec_rounds": eng.spec_rounds,
                 "spec_horizon": spec,
                 "draft_overhead_frac": dwork / max(1, dwork + twork)}
    return {"mode": eng.prefiller.name, "arch": arch, "horizon": horizon,
            **extra,
            "tok_s": toks / max(dt, 1e-9),
            "decode_tok_s": dtoks / max(dt - dpre, 1e-9),
            "ttft_ms": 1e3 * float(np.mean(ttft)) if ttft else 0.0,
            "ttft_p50_ms": 1e3 * percentile(ttft, 50),
            "ttft_p99_ms": 1e3 * percentile(ttft, 99),
            "tpot_ms": 1e3 * float(np.mean(tpot)) if tpot else 0.0,
            "tpot_p50_ms": 1e3 * percentile(tpot, 50),
            "decode_step_us": 1e6 * (tm["decode_s"] - tm0["decode_s"])
            / max(1, dtoks),
            "host_us": 1e6 * (tm["host_s"] - tm0["host_s"])
            / max(1, tm["steps"] - tm0["steps"]),
            "host_s": tm["host_s"],
            "decode_s": tm["decode_s"], "prefill_s": tm["prefill_s"],
            "device_syncs": syncs,
            "syncs_per_token": syncs / max(1, dtoks),
            "tokens": toks, "wall_s": dt,
            "aborted": len(eng.aborted),
            "faults_injected": eng.faults.total_fired,
            "outputs": {k: list(v) for k, v in outs.items()}}


def bench_disagg(*, weights: Weights, arch: str = "llama3.2-1b",
                 requests: int = 8, new_tokens: int = 8,
                 max_prompt: int = 64, warmup: int = 2) -> dict:
    """A 1 prefill + 1 decode ``EngineCluster`` over the prefill section's
    trace: every request crosses the handoff once; the row carries the
    router's counters (``benchmarks/serving_bench.py::bench_disagg``)."""
    cfg, params = weights.plain(arch)
    cl = EngineCluster(cfg, _engine_config("batched"),
                       ClusterConfig(n_prefill=1, n_decode=1), params,
                       device=weights.device)
    rng = np.random.default_rng(7)
    for i in range(warmup):
        cl.submit(Request(1000 + i, rng.integers(
            0, cfg.vocab_size, size=int(rng.integers(8, max_prompt))),
            new_tokens))
    cl.run(10_000)
    warm_handoffs = cl.counters["handoffs"]
    warm_ok = cl.counters["handoff_ok"]
    rng = np.random.default_rng(0)
    for i in range(requests):
        plen = int(rng.integers(8, max_prompt))
        cl.submit(Request(i, rng.integers(0, cfg.vocab_size, size=plen),
                          new_tokens))
    t0 = time.perf_counter()
    cl.run(10_000)
    dt = time.perf_counter() - t0
    outs = {k: list(v) for k, v in cl.outputs.items() if k < 1000}
    toks = sum(len(v) for v in outs.values())
    c = cl.counters
    return {"mode": "disagg_1p1d", "arch": arch, "horizon": 1,
            "tok_s": toks / max(dt, 1e-9),
            "tokens": toks, "wall_s": dt,
            "aborted": len(cl.aborted),
            "faults_injected": cl.faults.total_fired,
            "handoffs": c["handoffs"] - warm_handoffs,
            "handoff_ok": c["handoff_ok"] - warm_ok,
            "handoff_retries": c["handoff_retries"],
            "handoff_redispatches": c["handoff_redispatches"],
            "redispatched_requests": c["redispatched_requests"],
            "engine_deaths": c["engine_deaths"],
            "shed": c["shed"],
            "outputs": outs}


def run(emit, *, smoke: bool = False, draft: bool = True, device=None,
        weights: Weights | None = None) -> list[dict]:
    """Every section in ``BENCH_serving.json``'s row order; ``emit(name,
    us, derived)`` gets the reference's progress lines. Returns the rows,
    each with its ``outputs``."""
    w = weights if weights is not None else Weights(device)
    kw = dict(requests=4, new_tokens=6, warmup=1) if smoke else {}
    hkw = dict(kw, new_tokens=6 if smoke else 64)   # decode-dominated trace
    results = []

    def keep(r, trace):
        r["trace"] = trace        # check_regression keys rows on it
        results.append(r)
        return r

    base = keep(bench("slot", weights=w, horizon=1, **kw), "prefill")
    emit("serving_prefill_slot", base["host_us"],
         f"tok/s={base['tok_s']:.1f} prefill_s={base['prefill_s']:.2f}")
    for mode in ("batched", "chunked"):
        r = keep(bench(mode, weights=w, horizon=1, **kw), "prefill")
        assert r["outputs"] == base["outputs"], \
            f"{mode} prefill changed greedy outputs"
        emit(f"serving_prefill_{mode}", r["host_us"],
             f"tok/s={r['tok_s']:.1f} prefill_s={r['prefill_s']:.2f} "
             f"speedup={r['tok_s'] / max(base['tok_s'], 1e-9):.2f}x")
    h1 = None
    for h in HORIZONS:
        r = keep(bench("batched", weights=w, horizon=h, **hkw), "decode")
        if h1 is None:
            h1 = r
        assert r["outputs"] == h1["outputs"], \
            f"decode_horizon={h} changed greedy outputs"
        emit(f"serving_horizon_{h}", r["decode_step_us"],
             f"decode_tok/s={r['decode_tok_s']:.0f} tok/s={r['tok_s']:.1f} "
             f"ttft_ms={r['ttft_ms']:.1f} "
             f"syncs/tok={r['syncs_per_token']:.3f} "
             f"speedup="
             f"{r['decode_tok_s'] / max(h1['decode_tok_s'], 1e-9):.2f}x")
    # the attention-free xLSTM: state-carrying batched and chunked prefill
    # against the per-slot recompute path
    rkw = dict(kw, arch="xlstm-350m")
    rbase = keep(bench("slot", weights=w, horizon=1, **rkw), "recurrent")
    emit("serving_recurrent_slot", rbase["host_us"],
         f"tok/s={rbase['tok_s']:.1f} ttft_ms={rbase['ttft_ms']:.1f} "
         f"prefill_s={rbase['prefill_s']:.2f}")
    for mode in ("batched", "chunked"):
        r = keep(bench(mode, weights=w, horizon=1, **rkw), "recurrent")
        assert r["outputs"] == rbase["outputs"], \
            f"recurrent {mode} prefill changed greedy outputs"
        emit(f"serving_recurrent_{mode}", r["host_us"],
             f"tok/s={r['tok_s']:.1f} ttft_ms={r['ttft_ms']:.1f} "
             f"prefill_s={r['prefill_s']:.2f} "
             f"speedup={r['tok_s'] / max(rbase['tok_s'], 1e-9):.2f}x "
             f"ttft_speedup={rbase['ttft_ms'] / max(r['ttft_ms'], 1e-9):.2f}x")
    dr = keep(bench_disagg(weights=w, **kw), "disagg")
    assert dr["outputs"] == base["outputs"], \
        "disaggregated serving changed greedy outputs"
    assert dr["handoffs"] == dr["handoff_ok"], \
        (dr["handoffs"], dr["handoff_ok"])
    emit("serving_disagg_1p1d", dr["tok_s"],
         f"tok/s={dr['tok_s']:.1f} handoffs={dr['handoffs']} "
         f"ok={dr['handoff_ok']} retries={dr['handoff_retries']} "
         f"redispatches={dr['handoff_redispatches']} "
         f"deaths={dr['engine_deaths']}")
    if draft:
        sbase = keep(bench("batched", weights=w, horizon=8, oracle=True,
                           **hkw), "spec")
        emit("serving_spec_target", sbase["decode_step_us"],
             f"decode_tok/s={sbase['decode_tok_s']:.0f} "
             f"syncs/tok={sbase['syncs_per_token']:.3f} speedup=1.00x")
        r = keep(bench("batched", weights=w, horizon=1, spec=SPEC_HORIZON,
                       oracle=True, **hkw), "spec")
        assert r["outputs"] == sbase["outputs"], \
            "speculative decode changed greedy outputs"
        assert r["accept_len_mean"] > 1.0, \
            f"oracle draft accept_len_mean={r['accept_len_mean']:.2f} <= 1"
        emit("serving_spec_draft", r["decode_step_us"],
             f"decode_tok/s={r['decode_tok_s']:.0f} "
             f"accept_len={r['accept_len_mean']:.2f} "
             f"draft_frac={r['draft_overhead_frac']:.3f} "
             f"syncs/tok={r['syncs_per_token']:.3f} "
             f"speedup="
             f"{r['decode_tok_s'] / max(sbase['decode_tok_s'], 1e-9):.2f}x")
    return results


def write_json(results, path: str) -> None:
    rows = [{k: v for k, v in r.items() if k != "outputs"} for r in results]
    with open(path, "w") as f:
        json.dump({"bench": "serving", "rows": rows}, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny trace")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the rows in BENCH_serving.json's shape")
    ap.add_argument("--draft", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="include the speculative section (the oracle pair; "
                         "--no-draft skips it)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    def emit(name, us, derived):
        print(f"{name},{us:.2f},{derived}", flush=True)

    results = run(emit, smoke=args.smoke, draft=args.draft,
                  device=args.device)
    if args.json:
        write_json(results, args.json)
        print(f"# wrote {args.json}")
    print("# serving_bench OK")
    return results


if __name__ == "__main__":
    main()
