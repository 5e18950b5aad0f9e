"""Goodput under the committed SLO workload: FCFS vs EDF vs SLO-aware
scheduling through the port's engine.

    python -m repro_torch.launch.slo_bench --device cpu --json slo.json

The port's counterpart of ``benchmarks/slo_bench.py``: it replays
``benchmarks/traces/slo_default.json`` (two-tenant bursty overload,
heavy-tail lengths, client aborts; ``data/workload.py``) through
``DecodeEngine`` once per policy, on a ``VirtualClock`` advanced by a fixed
modeled cost per tick, at the bench's configuration (reduced llama3.2-1b,
fp32, 4 slots, 8-token pages, 160 pages, batched prefill, no EOS). Every
counter of a row is then a function of scheduling alone, so the rows must
equal ``BENCH_slo.json``'s exactly (``benchmarks/check_regression.py``
gates them, kind ``slo``). The run asserts what the reference asserts:
outputs agree across policies on their common prefix, ``slo`` beats
``fcfs`` on goodput, and priority preemption happened.

``--json PATH`` writes ``BENCH_slo.json``'s shape. Weights are random from
a seed unless ``bench(params=...)`` gets them (the tests pass ``repro``'s
``PRNGKey(0)`` weights, converted); with no EOS the rows do not depend on
them. The engine runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import replace
from pathlib import Path

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import workload
from repro_torch.models import model as MDL
from repro_torch.runtime.clock import VirtualClock
from repro_torch.serving import DecodeEngine, EngineConfig
from repro_torch.telemetry import TelemetryConfig

DEFAULT_TRACE = str(Path(__file__).resolve().parents[3] / "benchmarks"
                    / "traces" / "slo_default.json")
POLICY_SET = ("fcfs", "edf", "slo")
ARCH = "llama3.2-1b"
TICK_S = 0.01   # modeled per-tick cost (one decode step across slots)


def bench_config():
    return replace(reduced(get_config(ARCH)), dtype="float32")


def bench_policy(policy: str, trace: dict, *, cfg, params, device,
                 use_kernels=None) -> dict:
    """One engine and one policy over the trace on a fresh VirtualClock.
    Returns the row, with the outputs (stripped before JSON)."""
    clock = VirtualClock()
    ecfg = EngineConfig(n_slots=4, page_size=8, n_pages=160, max_context=128,
                        eos_token=-1, prefill_mode="batched",
                        sched_policy=policy, clock=clock,
                        use_kernels=use_kernels,
                        telemetry=TelemetryConfig(metrics=True))
    eng = DecodeEngine(cfg, ecfg, params, device=device)
    c = workload.replay(trace, eng, clock, tick_s=TICK_S,
                        vocab=cfg.vocab_size)
    tr = eng.tel.tracker
    tenants = sorted({r.tenant for r in tr.records if r.tenant})
    per_tenant = {}
    for t in tenants:
        recs = [r for r in tr.records if r.tenant == t
                and (r.finished or r.aborted)]
        per_tenant[t] = (sum(1 for r in recs if r.slo_ok), len(recs))
    st = eng.batcher.stats
    row = {"policy": policy, "trace": trace["trace"], "arch": ARCH,
           "tick_s": TICK_S,
           "goodput": round(tr.goodput(), 6),
           **{f"goodput_{t}": round(ok / max(1, n), 6)
              for t, (ok, n) in per_tenant.items()},
           "slo_attained": sum(1 for r in tr.records if r.slo_ok),
           "completed": sum(1 for r in tr.records if r.finished),
           **c,
           "aborted_client": eng.abort_counts["client"],
           "aborted_deadline": eng.abort_counts["deadline"],
           "preempted": st.preempted,
           "priority_preempted": st.priority_preempted,
           "tokens": sum(len(v) for v in eng.outputs.values())}
    row["outputs"] = {k: list(v) for k, v in eng.outputs.items()}
    return row


def bench(*, trace_path: str = DEFAULT_TRACE, params=None, device=None,
          use_kernels=None) -> list[dict]:
    """The three policies' rows (each with its ``outputs``), checked as the
    reference checks them."""
    trace = workload.load_trace(trace_path)
    cfg = bench_config()
    if params is None:
        params = MDL.init_params(cfg, 0, torch.float32, device)
    rows = [bench_policy(p, trace, cfg=cfg, params=params, device=device,
                         use_kernels=use_kernels)
            for p in POLICY_SET]
    by = {r["policy"]: r for r in rows}
    # a request's greedy tokens are a function of its prompt alone; a
    # client-aborted run holds a prefix of the full sequence
    base = by["fcfs"]["outputs"]
    for r in rows[1:]:
        for k in sorted(base.keys() & r["outputs"].keys()):
            a, b = base[k], r["outputs"][k]
            n = min(len(a), len(b))
            assert a[:n] == b[:n], (r["policy"], k, a, b)
    assert by["slo"]["goodput"] > by["fcfs"]["goodput"], \
        ("slo policy must beat fcfs on goodput",
         by["slo"]["goodput"], by["fcfs"]["goodput"])
    assert by["slo"]["priority_preempted"] > 0, \
        "trace never exercised priority preemption"
    return rows


def write_json(rows, path: str) -> None:
    slim = [{k: v for k, v in r.items() if k != "outputs"} for r in rows]
    with open(path, "w") as f:
        json.dump({"bench": "slo", "rows": slim}, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=DEFAULT_TRACE)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the rows in BENCH_slo.json's shape")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = bench(trace_path=args.trace, device=args.device)
    for r in rows:
        print(f"slo_{r['policy']},{r['goodput']:.4f},"
              + " ".join([f"goodput={r['goodput']:.3f}"]
                         + [f"{k.split('goodput_')[1]}={r[k]:.3f}"
                            for k in r if k.startswith("goodput_")]
                         + [f"completed={r['completed']}/{r['arrivals']}",
                            f"preempt={r['priority_preempted']}",
                            f"ticks={r['ticks']}"]), flush=True)
    if args.json:
        write_json(rows, args.json)
        print(f"# wrote {args.json}")
    print("# slo_bench OK")
    return rows


if __name__ == "__main__":
    main()
