"""Observability smoke: one in-process serve run with every telemetry
surface on, then each export format validated end to end.

Port of ``benchmarks/telemetry_smoke.py``. Runs
``repro_torch.launch.serve.serve`` with ``--metrics-port 0`` (an ephemeral
Prometheus endpoint), ``--trace-out`` and ``--request-log``, then

* scrapes the live endpoint over real HTTP and runs the text through the
  strict ``parse_exposition`` validator (the per-tier PIM pool samples
  must be present);
* loads the written chrome-trace JSON and runs ``validate_trace`` over it
  (the engine's host, dispatch and sync tracks and the inferred device
  span must all be there);
* parses the JSONL request records and cross-checks their token totals
  and finished count against the scraped counters.

The artifacts (``trace.json``, ``records.jsonl``, ``metrics.txt``) stay in
``--outdir``. Exit code 0: every format valid. Runs on the card unless
``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.telemetry_smoke \\
        --outdir tel_smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="tel_smoke",
                    help="where trace.json / records.jsonl / metrics.txt land")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    trace_path = os.path.join(args.outdir, "trace.json")
    log_path = os.path.join(args.outdir, "records.jsonl")
    metrics_path = os.path.join(args.outdir, "metrics.txt")

    from repro_torch.launch import serve
    from repro_torch.telemetry import parse_exposition, prom, validate_trace
    from repro_torch.telemetry.chrome_trace import ENGINE_PID, TRACKS

    # small but non-trivial: preemption pressure (few pages), a fused
    # horizon (dispatch / sync / device tracks), chunked prefill
    serve.serve(["--requests", str(args.requests), "--slots", "3",
                 "--pages", "48", "--page", "8", "--max-context", "128",
                 "--mean-new", "12", "--prefill-mode", "chunked",
                 "--chunk", "16", "--decode-horizon", "4",
                 "--device", args.device,
                 "--metrics-port", "0", "--trace-out", trace_path,
                 "--request-log", log_path])

    # ---- Prometheus: scrape over real HTTP, validate strictly ----------
    srv = prom.LAST_SERVER
    assert srv is not None, "serve did not start a metrics server"
    text = srv.scrape()
    srv.close()
    with open(metrics_path, "w") as f:
        f.write(text)
    samples = parse_exposition(text)
    for required in ("repro_engine_decode_tokens_total",
                     "repro_engine_device_syncs_total",
                     'repro_kv_pages_total{tier="device"}',
                     "repro_pim_modeled_hbm_bytes_total",
                     "repro_pim_channel_util",
                     "repro_requests_finished_total",
                     "repro_request_ttft_seconds_count"):
        assert required in samples, f"missing sample {required}"
    assert samples["repro_requests_finished_total"] == args.requests
    print(f"[smoke] prometheus: {len(samples)} samples valid ({srv.url})")

    # ---- chrome trace: load + validate tracks --------------------------
    with open(trace_path) as f:
        doc = json.load(f)
    info = validate_trace(doc)
    for track in ("host", "dispatch", "sync", "device"):
        assert (ENGINE_PID, TRACKS[track]) in info["tracks"], \
            f"missing engine track {track}"
    assert info["slices"] > 0
    print(f"[smoke] trace: {info['events']} events, {info['slices']} "
          f"slices, {len(info['tracks'])} tracks -> {trace_path}")

    # ---- request records: JSONL parses, totals reconcile ---------------
    with open(log_path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert len(recs) == args.requests, (len(recs), args.requests)
    assert all(r["finished"] for r in recs)
    toks = sum(r["tokens"] for r in recs)
    assert toks == samples["repro_request_tokens_total"], \
        (toks, samples["repro_request_tokens_total"])
    assert all(r["ttft_s"] is not None and r["ttft_s"] >= 0 for r in recs)
    print(f"[smoke] records: {len(recs)} requests, {toks} tokens "
          f"-> {log_path}")
    print("# telemetry_smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
