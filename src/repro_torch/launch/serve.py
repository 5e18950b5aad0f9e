"""End-to-end serving driver: continuous-batching greedy decode with the DPA
paged cache over a LongBench-like request trace.

  python -m repro_torch.launch.serve --requests 6 --slots 3 --page 8 \
      --pages 64 --max-context 128 --mean-new 8 --device cpu

runs a reduced config (d_model 64) on the CPU; on a card (the default
device), ``--full-width`` serves the configuration at its published widths
and depth with random weights from a seed. ``--arch`` picks
``llama3.2-1b`` (default) or the Mamba2 + shared-attention hybrid
``zamba2-1.2b``. Prompts are random token ids
whose lengths follow the task's LongBench distribution, scaled into
``--max-context``. The run ends with ``completed=N/N`` and the page
balance (``max=0 min=0`` once every page is released).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import LONGBENCH_STATS, request_trace
from repro_torch.serving import DecodeEngine, EngineConfig, Request


def build_engine(args) -> DecodeEngine:
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = reduced(cfg)
    cfg = replace(cfg, dtype="float32")
    ecfg = EngineConfig(n_slots=args.slots, page_size=args.page,
                        n_pages=args.pages, max_context=args.max_context,
                        eos_token=-1, prefill_mode=args.prefill_mode,
                        prefill_chunk=args.chunk,
                        decode_horizon=args.decode_horizon,
                        use_kernels={"on": None, "off": False}[args.kernel],
                        kernel_splits=args.kernel_splits)
    return DecodeEngine(cfg, ecfg, device=args.device)


def submit_trace(eng: DecodeEngine, args) -> None:
    rng = np.random.default_rng(0)
    # scale the LongBench length distribution into max_context so its
    # variability survives (paper Table 2 / §5.4)
    factor = (args.max_context / 2) / LONGBENCH_STATS[args.task]["mean"]
    trace = request_trace(args.task, args.requests, seed=0,
                          mean_new_tokens=args.mean_new)
    for i, (plen, new) in enumerate(trace):
        plen = max(1, min(int(plen * factor), args.max_context - new - 1))
        prompt = rng.integers(0, eng.cfg.vocab_size, size=plen)
        eng.submit(Request(i, prompt, new))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
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
    ap.add_argument("--decode-horizon", type=int, default=8,
                    help="fused decode steps per engine tick (one host sync "
                         "per horizon); 1 = per-token")
    ap.add_argument("--kernel", default="on", choices=["on", "off"],
                    help="attention through the CUDA kernels (their plain "
                         "versions on the CPU) or the plain reference paths")
    ap.add_argument("--kernel-splits", type=int, default=1,
                    help="split-K partitions of the decode page axis")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true",
                    help="the configuration's published widths and depth "
                         "(default: reduced to d_model 64)")
    args = ap.parse_args(argv)

    eng = build_engine(args)
    submit_trace(eng, args)
    t0 = time.perf_counter()
    eng.run(100_000)
    if eng.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = eng.batcher.stats
    toks = sum(len(v) for v in eng.outputs.values())
    tm = eng.timing.as_dict()
    print(f"[serve] device={eng.device} arch={eng.cfg.name} "
          f"prefill={eng.prefiller.name} policy={eng.batcher.policy.name} "
          f"completed={st.completed}/{args.requests} "
          f"avg_batch={st.avg_batch:.2f} preempted={st.preempted} "
          f"tokens={toks} tok/s={toks / max(dt, 1e-9):.1f} "
          f"host_us/step={tm['host_us_per_step']:.0f} "
          f"horizon={args.decode_horizon} "
          f"syncs/tok={tm['syncs_per_token']:.3f}", flush=True)
    bal = eng.alloc.shard_balance()
    print(f"[serve] page balance per shard: max={bal.max()} min={bal.min()}",
          flush=True)
    return st.completed


if __name__ == "__main__":
    main()
