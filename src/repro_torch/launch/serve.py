"""End-to-end serving driver: continuous-batching greedy decode with the DPA
paged cache over a LongBench-like request trace.

  python -m repro_torch.launch.serve --requests 6 --slots 3 --page 8 \
      --pages 64 --max-context 128 --mean-new 8 --device cpu

runs a reduced config (d_model 64) on the CPU; on a card (the default
device), ``--full-width`` serves the configuration at its published widths
and depth with random weights from a seed. ``--arch`` picks any registered configuration
(``repro_torch.configs.list_configs()``): ``llama3.2-1b`` (default), the
paper's ``qwen1.5-7b`` / ``-14b`` / ``-72b``, ``internlm2-1.8b``,
``yi-34b``, ``gemma3-27b``, the MoE stacks ``mixtral-8x22b`` and
``phi3.5-moe-42b-a6.6b``, the Mamba2 + shared-attention hybrid
``zamba2-1.2b`` or the attention-free ``xlstm-350m``. Prompts are random
token ids
whose lengths follow the task's LongBench distribution, scaled into
``--max-context``; ``--shared-frac f`` opens each prompt with a common
system prompt covering that fraction of it, the traffic
``--prefix-cache`` (radix prefix sharing) and ``--host-pages N`` (a host
offload tier) pay off on. The run ends with ``completed=N/N`` and the page
balance (``max=0 min=0`` once every page is released or held by the
prefix cache's tree), then the ``kvcache:`` counters when the cache is on.
``--draft ARCH --spec-horizon G`` serves with speculative decoding: a
1-layer draft of ``ARCH`` (reduced with the target, or at its published
widths with ``--full-width``; random weights from seed 1) proposes up to G
tokens a slot each tick and one multi-query target pass verifies them; the
run then ends with a ``spec:`` line (rounds, accepted / proposed, mean
accept length).

The first line reports the allocation mode, the achieved average batch
(the paper's Fig. 4(b) metric) and the peak of device pages in use.
``--static`` switches to baseline-PIM static allocation (every admission
reserves ``max_context / page + 1`` pages) for the paper's §5.4 lazy (DPA)
against static comparison (``examples/serve_longbench_torch.py``);
``--sched-policy`` (alias ``--policy``) picks the admission policy and
``--no-decode-bucket`` turns off the pow2 bucketing of the decode table
width.

``--disagg`` serves through a disaggregated prefill/decode pool
(``--engines P+D``, ``serving/cluster.py``) on one device: prefill-role
engines hand each finished prefill's KV pages (and a hybrid's carry) to a
decode-role engine as a checksummed handoff blob, with the router's
retries, timeouts, engine-death recovery (``--snapshot-dir`` /
``--snapshot-every`` make it warm) and backpressure (``--max-queue``
bounds the decode backlog). ``--fault-engine-death`` /
``--fault-handoff-corrupt`` / ``--fault-handoff-torn`` drive the router's
seeded injector. It ends with a ``cluster:`` line of the router's
counters; greedy tokens equal the single engine's.

Telemetry (``repro_torch.telemetry``): ``--metrics-port N`` serves
Prometheus text on ``http://127.0.0.1:N/metrics`` (0 = an ephemeral port,
printed at startup), ``--trace-out trace.perfetto.json`` writes the tick
pipeline's Perfetto timeline, ``--request-log records.jsonl`` one JSON
record per finished request, ``--stats-every S`` a summary line every S
seconds. Without these flags telemetry is the shared no-op.

Lifecycle and faults: ``--max-queue`` sheds past a bounded queue,
``--deadline`` tears requests down past a per-request deadline,
``--degrade-after`` sets the degradation ladder's threshold,
``--nan-guard`` quarantines out-of-range ids, ``--snapshot-dir`` /
``--snapshot-every`` write crash-consistent serving snapshots and
``--restore`` resumes the newest one instead of submitting the trace. The
``--fault-*`` probabilities arm the seeded injector (``--fault-seed``); a
run with faults, aborts or snapshots ends with a ``robustness:`` line.
"""
from __future__ import annotations

import argparse
import threading
import time
from dataclasses import replace

import numpy as np

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.data.pipeline import LONGBENCH_STATS, request_trace
from repro_torch.runtime.faults import FaultConfig
from repro_torch.serving import (ClusterConfig, DecodeEngine, EngineCluster,
                                 EngineConfig, Request)
from repro_torch.serving.policies import available_policies
from repro_torch.telemetry import TelemetryConfig, make_telemetry
from repro_torch.telemetry.prom import MetricsServer


def make_serve_tel_cfg(args):
    """The TelemetryConfig from the CLI flags, or None when every
    telemetry flag is off."""
    want_metrics = args.metrics_port >= 0 or args.stats_every > 0
    if not (want_metrics or args.trace_out or args.request_log):
        return None
    return TelemetryConfig(metrics=True, trace_path=args.trace_out or None,
                           request_log=args.request_log or None)


def make_serve_telemetry(args):
    """The Telemetry facade from the CLI flags; the shared no-op when
    every telemetry flag is off."""
    return make_telemetry(make_serve_tel_cfg(args))


def make_serve_faults(args):
    """FaultConfig from the --fault-* flags; None when no probability is
    set (the engine keeps the shared no-op injector)."""
    ps = dict(alloc_exhaust_p=args.fault_alloc, swap_fail_p=args.fault_swap,
              row_death_p=args.fault_row_death, nan_logits_p=args.fault_nan,
              slow_tick_p=args.fault_slow_tick,
              client_abort_p=args.fault_abort)
    if not any(ps.values()):
        return None
    return FaultConfig(seed=args.fault_seed, **ps)


def make_cluster_faults(args):
    """The router's FaultConfig (engine death, handoff damage) from the
    --fault-engine-death / --fault-handoff-* flags; None when all are 0."""
    ps = dict(engine_death_p=args.fault_engine_death,
              handoff_corrupt_p=args.fault_handoff_corrupt,
              handoff_torn_p=args.fault_handoff_torn)
    if not any(ps.values()):
        return None
    return FaultConfig(seed=args.fault_seed, **ps)


def model_configs(args):
    """The served configuration and the draft's (or None), fp32."""
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduced(cfg)
    cfg = replace(cfg, dtype="float32")
    draft_cfg = None
    if args.draft:
        d = get_config(args.draft)
        d = replace(d, n_layers=1) if args.full_width else reduced(d,
                                                                   layers=1)
        draft_cfg = replace(d, dtype="float32")
    return cfg, draft_cfg


def engine_config(args, draft_cfg, telemetry=None) -> EngineConfig:
    return EngineConfig(n_slots=args.slots, page_size=args.page,
                        n_pages=args.pages, max_context=args.max_context,
                        static_alloc=args.static,
                        eos_token=-1, prefill_mode=args.prefill_mode,
                        prefill_chunk=args.chunk,
                        sched_policy=args.sched_policy,
                        decode_bucket=not args.no_decode_bucket,
                        decode_horizon=args.decode_horizon,
                        use_kernels={"on": None, "off": False}[args.kernel],
                        kernel_splits=args.kernel_splits,
                        prefix_cache=args.prefix_cache,
                        host_pages=args.host_pages,
                        reserve_gentle=args.reserve_gentle,
                        state_resume=not args.no_state_resume,
                        draft_config=draft_cfg,
                        spec_horizon=args.spec_horizon,
                        telemetry=telemetry,
                        faults=make_serve_faults(args),
                        max_queue=args.max_queue,
                        default_deadline_s=args.deadline,
                        degrade_after=args.degrade_after,
                        nan_guard=True if args.nan_guard else None,
                        snapshot_dir=args.snapshot_dir or None,
                        snapshot_every=args.snapshot_every)


def build_engine(args, telemetry=None) -> DecodeEngine:
    cfg, draft_cfg = model_configs(args)
    return DecodeEngine(cfg, engine_config(args, draft_cfg, telemetry),
                        device=args.device)


def submit_trace(eng, args) -> None:
    """Submit the LongBench-like trace to an engine or a cluster."""
    for req in trace_requests(args, eng.cfg.vocab_size):
        eng.submit(req)


def trace_requests(args, vocab_size: int) -> list[Request]:
    """The run's requests: LongBench-like prompt lengths, random ids from
    seed 0."""
    rng = np.random.default_rng(0)
    # scale the LongBench length distribution into max_context so its
    # variability survives (paper Table 2 / §5.4)
    factor = (args.max_context / 2) / LONGBENCH_STATS[args.task]["mean"]
    trace = request_trace(args.task, args.requests, seed=0,
                          mean_new_tokens=args.mean_new)
    # common system prompt: every request opens with the same token run —
    # the multi-tenant traffic shape radix prefix sharing pays off on
    system = rng.integers(0, vocab_size,
                          size=args.max_context) if args.shared_frac else None
    reqs = []
    for i, (plen, new) in enumerate(trace):
        plen = max(1, min(int(plen * factor), args.max_context - new - 1))
        prompt = rng.integers(0, vocab_size, size=plen)
        if system is not None:
            k = min(int(plen * args.shared_frac), plen - 1)
            prompt[:k] = system[:k]
        reqs.append(Request(i, prompt, new))
    return reqs


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_configs())
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--task", default="musique")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--pages", type=int, default=256)
    ap.add_argument("--max-context", type=int, default=512)
    ap.add_argument("--mean-new", type=int, default=24)
    ap.add_argument("--prefill-mode", default="batched",
                    choices=["slot", "batched", "chunked"])
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--static", action="store_true",
                    help="baseline-PIM static allocation: every admission "
                         "reserves max_context / page + 1 pages (default: "
                         "lazy, DPA)")
    # choices come from the policy registry (serving.policies)
    ap.add_argument("--sched-policy", "--policy", dest="sched_policy",
                    default="fcfs", choices=available_policies())
    ap.add_argument("--no-decode-bucket", action="store_true",
                    help="no pow2 live-page bucketing of the decode block "
                         "table width")
    ap.add_argument("--shared-frac", type=float, default=0.0,
                    help="fraction of each prompt drawn from a common "
                         "system prompt")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix sharing across requests")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host offload tier capacity in pages (0 = none)")
    ap.add_argument("--reserve-gentle", action="store_true",
                    help="horizon reservation declines to evict radix-"
                         "cached pages, shortening the horizon instead")
    ap.add_argument("--no-state-resume", action="store_true",
                    help="hybrids: no preemption snapshots of the recurrent "
                         "carry (+ written KV); a preempted request "
                         "re-prefills")
    ap.add_argument("--decode-horizon", type=int, default=8,
                    help="fused decode steps per engine tick (one host sync "
                         "per horizon); 1 = per-token")
    ap.add_argument("--draft", default="",
                    help="speculative decoding: arch name of a 1-layer "
                         "draft model proposing tokens the target verifies "
                         "in one multi-query pass (greedy outputs stay "
                         "token-identical)")
    ap.add_argument("--spec-horizon", type=int, default=4,
                    help="max draft proposals per slot per tick (emits up "
                         "to spec-horizon+1 tokens per sync)")
    ap.add_argument("--kernel", default="on", choices=["on", "off"],
                    help="attention through the CUDA kernels (their plain "
                         "versions on the CPU) or the plain reference paths")
    ap.add_argument("--kernel-splits", type=int, default=1,
                    help="split-K partitions of the decode page axis")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true",
                    help="the configuration's published widths and depth "
                         "(default: reduced to d_model 64)")
    # ---- telemetry ----
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve Prometheus text on this port (0 = "
                         "ephemeral, printed; -1 = off)")
    ap.add_argument("--trace-out", default="",
                    help="write a Perfetto/chrome-trace JSON of the tick "
                         "pipeline to this path")
    ap.add_argument("--request-log", default="",
                    help="append one JSON record per finished request to "
                         "this path")
    ap.add_argument("--stats-every", type=float, default=0.0,
                    help="print a telemetry stats line every S seconds "
                         "while serving (0 = off)")
    # ---- disaggregation (serving/cluster.py) ----
    ap.add_argument("--disagg", action="store_true",
                    help="serve through a disaggregated prefill/decode "
                         "engine pool (EngineCluster) with checksummed KV "
                         "handoff instead of one colocated engine")
    ap.add_argument("--engines", default="1+1",
                    help="pool shape for --disagg: P+D prefill/decode "
                         "engine counts (e.g. 2+2)")
    # ---- lifecycle and faults ----
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue: shed beyond this many "
                         "waiting requests (0 = unbounded)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="default per-request deadline in seconds; expired "
                         "requests are torn down at the next tick (0 = "
                         "none)")
    ap.add_argument("--degrade-after", type=int, default=3,
                    help="fault events before the degradation ladder drops "
                         "a tier (spec off, horizon 1, host tier); 0 "
                         "disables")
    ap.add_argument("--nan-guard", action="store_true",
                    help="quarantine requests whose sampled ids go out of "
                         "range (armed anyway when faults are injected)")
    ap.add_argument("--snapshot-dir", default="",
                    help="write crash-consistent serving snapshots here")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot cadence in engine ticks (0 = off)")
    ap.add_argument("--restore", action="store_true",
                    help="restore the newest snapshot from --snapshot-dir "
                         "before serving (resumes in-flight requests)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault injector")
    for flag, kind in (("--fault-alloc", "page-pool exhaustion"),
                       ("--fault-swap", "host swap-in failure"),
                       ("--fault-row-death", "serving-row death"),
                       ("--fault-nan", "NaN-logits quarantine"),
                       ("--fault-slow-tick", "straggler tick"),
                       ("--fault-abort", "client abort"),
                       ("--fault-engine-death", "pool engine death "
                        "(--disagg)"),
                       ("--fault-handoff-corrupt", "handoff byte flip "
                        "(--disagg)"),
                       ("--fault-handoff-torn", "handoff truncation "
                        "(--disagg)")):
        ap.add_argument(flag, type=float, default=0.0,
                        help=f"per-decision injection probability: {kind}")
    return ap.parse_args(argv)


def run_until_done(eng) -> int:
    """Tick ``eng`` (an engine or a cluster) until it drains; returns the
    peak of device pages in use over its engines, read after every
    tick."""
    cluster = isinstance(eng, EngineCluster)
    peak = 0
    for _ in range(100_000):
        if (eng.done() if cluster
                else eng._inflight is None and eng.batcher.done()):
            break
        eng.tick()
        engines = [h.eng for h in eng.handles] if cluster else [eng]
        peak = max(peak, sum(e.alloc.pages_in_use for e in engines))
    if eng.device.type == "cuda":
        import torch
        torch.cuda.synchronize(eng.device)
    return peak


def serve_cluster(args) -> dict:
    """--disagg: route the trace through an EngineCluster pool
    (``--engines P+D``) on ``--device`` instead of one engine. Greedy
    tokens equal the single engine's; the summary adds the router's
    handoff and recovery counters. Returns the run's stats."""
    try:
        n_p, n_d = (int(x) for x in args.engines.split("+"))
    except ValueError:
        raise SystemExit(f"--engines wants P+D (e.g. 1+1), "
                         f"got {args.engines!r}")
    tel_cfg = make_serve_tel_cfg(args)
    cfg, draft_cfg = model_configs(args)
    ccfg = ClusterConfig(n_prefill=n_p, n_decode=n_d,
                         max_backlog=args.max_queue,
                         snapshot_dir=args.snapshot_dir or None,
                         snapshot_every=args.snapshot_every,
                         faults=make_cluster_faults(args),
                         telemetry=tel_cfg)
    # the router sheds past --max-queue; the engines keep no bound of
    # their own
    ecfg = replace(engine_config(args, draft_cfg, tel_cfg), max_queue=0)
    cl = EngineCluster(cfg, ecfg, ccfg, device=args.device)
    if cl.tel.enabled and args.metrics_port >= 0:
        srv = MetricsServer(cl.tel.registry, args.metrics_port)
        print(f"[serve] metrics: {srv.url}", flush=True)
    submit_trace(cl, args)
    t0 = time.perf_counter()
    peak = run_until_done(cl)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in cl.outputs.values())
    done = sum(1 for r in cl.reqs.values() if r["state"] == "done")
    c, T = cl.counters, cl.transfer
    print(f"[serve] mode=disagg engines={n_p}p+{n_d}d device={cl.device} "
          f"arch={cfg.name} prefill={args.prefill_mode} "
          f"alloc={'static' if args.static else 'lazy(DPA)'} "
          f"completed={done}/{args.requests} aborted={len(cl.aborted)} "
          f"tokens={toks} tok/s={toks / max(dt, 1e-9):.1f} "
          f"peak_pages={peak}", flush=True)
    print(f"[serve] cluster: handoffs={c['handoffs']} ok={c['handoff_ok']} "
          f"retries={c['handoff_retries']} timeouts={c['handoff_timeouts']} "
          f"redispatches={c['handoff_redispatches']} "
          f"redrives={c['handoff_redrives']} deaths={c['engine_deaths']} "
          f"restores={c['engine_restores']} "
          f"redispatched_requests={c['redispatched_requests']} "
          f"shed={c['shed']} degraded_mode={cl.degraded_mode} "
          f"handoff MB={T.applied_bytes / 1e6:.2f}", flush=True)
    for h in cl.handles:
        if h.alive:
            bal = h.eng.alloc.shard_balance()
            print(f"[serve] engine {h.ix} ({h.role}): page balance per "
                  f"shard: max={bal.max()} min={bal.min()}", flush=True)
    if cl.tel.enabled:
        print(f"[serve] {cl.tel.stats_line()}", flush=True)
        cl.tel.close()
    return {"completed": done, "aborted": dict(cl.aborted), "tokens": toks,
            "wall_s": dt, "peak_pages": peak, "cluster": cl.stats_dict(),
            "outputs": {k: list(v) for k, v in cl.outputs.items()}}


def serve(argv=None) -> dict:
    """Run the CLI and return the run's stats: ``completed``,
    ``avg_batch``, ``peak_pages``, ``tokens``, ``wall_s``, ``decode_tok_s``,
    ``decode_steps``, ``prefill_calls``, ``graph_captures`` and the greedy
    ``outputs`` (a ``--disagg`` run: the router's ``cluster`` counters in
    place of the batch and decode figures)."""
    args = parse_args(argv)
    if args.disagg:
        return serve_cluster(args)

    tel = make_serve_telemetry(args)
    eng = build_engine(args, telemetry=tel)
    srv = None
    if tel.enabled and args.metrics_port >= 0:
        srv = MetricsServer(tel.registry, args.metrics_port)
        print(f"[serve] metrics: {srv.url}", flush=True)
    stop_stats = None
    if tel.enabled and args.stats_every > 0:
        stop_stats = threading.Event()

        def _ticker():
            while not stop_stats.wait(args.stats_every):
                print(f"[serve] {tel.stats_line()}", flush=True)

        threading.Thread(target=_ticker, name="stats-line",
                         daemon=True).start()
    if args.restore and args.snapshot_dir:
        step = eng.restore_snapshot()
        print(f"[serve] restored snapshot step={step} from "
              f"{args.snapshot_dir}" if step is not None else
              f"[serve] no snapshot in {args.snapshot_dir}; cold start",
              flush=True)
    else:
        submit_trace(eng, args)
    t0 = time.perf_counter()
    peak = run_until_done(eng)
    dt = time.perf_counter() - t0
    if stop_stats is not None:
        stop_stats.set()
    st = eng.batcher.stats
    toks = sum(len(v) for v in eng.outputs.values())
    tm = eng.timing.as_dict()
    print(f"[serve] mode={'static' if args.static else 'lazy(DPA)'} "
          f"device={eng.device} arch={eng.cfg.name} "
          f"prefill={eng.prefiller.name} policy={eng.batcher.policy.name} "
          f"completed={st.completed}/{args.requests} "
          f"avg_batch={st.avg_batch:.2f} peak_pages={peak} "
          f"preempted={st.preempted} "
          f"tokens={toks} tok/s={toks / max(dt, 1e-9):.1f} "
          f"host_us/step={tm['host_us_per_step']:.0f} "
          f"horizon={args.decode_horizon} "
          f"syncs/tok={tm['syncs_per_token']:.3f}", flush=True)
    print(f"[serve] decode step ms="
          f"{1e3 * tm['decode_s'] / max(1, tm['decode_steps']):.3f} "
          f"graph captures={tm['graph_captures']} "
          f"capture ms={1e3 * tm['capture_s']:.1f} "
          f"({'CUDA graphs' if eng.horizons.graphs else 'eager'})",
          flush=True)
    held = ""
    if eng.cache is not None:
        cs = eng.cache.stats_dict()     # the run's counters, before the
        # tree gives back its pages: they are cached, not leaked, and the
        # balance is read without them
        tree_pages = eng.cache.tree.device_pages()
        eng.cache.reclaim(eng.alloc.n_pages)
        held = f" (after the prefix cache returned {tree_pages} tree pages)"
    bal = eng.alloc.shard_balance()
    print(f"[serve] page balance per shard: max={bal.max()} min={bal.min()}"
          + held, flush=True)
    if eng.has_rstate:
        print(f"[serve] rstate: snapshots={eng.rstate_snapshots} "
              f"restores={eng.rstate_restores}", flush=True)
    if eng.spec:
        acc = 1 + eng.spec_accepted / max(1, eng.spec_rounds)
        print(f"[serve] spec: draft={args.draft} rounds={eng.spec_rounds} "
              f"accepted={eng.spec_accepted}/{eng.spec_proposed} "
              f"accept_len_mean={acc:.2f}", flush=True)
    if eng.faults.enabled or eng.aborted or eng.degraded_mode \
            or eng.snapshot_saves:
        print(f"[serve] robustness: aborted={len(eng.aborted)} "
              f"{dict(eng.abort_counts)} faults={eng.faults.total_fired} "
              f"migrated={st.migrated} degraded_mode={eng.degraded_mode} "
              f"snapshots={eng.snapshot_saves}", flush=True)
    if eng.cache is not None:
        print(f"[serve] kvcache: hits={cs['hits']}/{cs['lookups']} "
              f"reused_tokens={cs['hit_tokens']} cow={cs['cow_copies']} "
              f"evicted={cs['evicted_pages']} "
              f"swap_out={cs.get('swapped_out_pages', 0)} "
              f"swap_in={cs.get('swapped_in_pages', 0)}", flush=True)
    if tel.enabled:
        print(f"[serve] {tel.stats_line()}", flush=True)
        sm = tel.summary()
        if "ttft_p50_ms" in sm:
            print(f"[serve] latency: ttft p50/p90/p99 = "
                  f"{sm['ttft_p50_ms']:.1f}/{sm['ttft_p90_ms']:.1f}/"
                  f"{sm['ttft_p99_ms']:.1f} ms  tpot p50 = "
                  f"{sm.get('tpot_p50_ms', 0):.2f} ms", flush=True)
        n = tel.save_trace()
        if n is not None:
            print(f"[serve] trace: {args.trace_out} ({n} events)",
                  flush=True)
        tel.close()
    return {"completed": st.completed, "avg_batch": st.avg_batch,
            "peak_pages": peak, "tokens": toks, "wall_s": dt,
            "decode_tok_s": tm["decode_tokens"] / max(tm["decode_s"], 1e-9),
            "decode_steps": tm["decode_steps"],
            "prefill_calls": tm["prefill_calls"],
            "graph_captures": tm["graph_captures"],
            "outputs": {k: list(v) for k, v in eng.outputs.items()}}


def main(argv=None) -> int:
    """The CLI; returns the number of completed requests."""
    return serve(argv)["completed"]


if __name__ == "__main__":
    main()
