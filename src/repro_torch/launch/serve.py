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
``phi3.5-moe-42b-a6.6b``, or the Mamba2 + shared-attention hybrid
``zamba2-1.2b``. Prompts are random token ids
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
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.data.pipeline import LONGBENCH_STATS, request_trace
from repro_torch.serving import DecodeEngine, EngineConfig, Request


def build_engine(args) -> DecodeEngine:
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
    ecfg = EngineConfig(n_slots=args.slots, page_size=args.page,
                        n_pages=args.pages, max_context=args.max_context,
                        eos_token=-1, prefill_mode=args.prefill_mode,
                        prefill_chunk=args.chunk,
                        decode_horizon=args.decode_horizon,
                        use_kernels={"on": None, "off": False}[args.kernel],
                        kernel_splits=args.kernel_splits,
                        prefix_cache=args.prefix_cache,
                        host_pages=args.host_pages,
                        reserve_gentle=args.reserve_gentle,
                        state_resume=not args.no_state_resume,
                        draft_config=draft_cfg,
                        spec_horizon=args.spec_horizon)
    return DecodeEngine(cfg, ecfg, device=args.device)


def submit_trace(eng: DecodeEngine, args) -> None:
    rng = np.random.default_rng(0)
    # scale the LongBench length distribution into max_context so its
    # variability survives (paper Table 2 / §5.4)
    factor = (args.max_context / 2) / LONGBENCH_STATS[args.task]["mean"]
    trace = request_trace(args.task, args.requests, seed=0,
                          mean_new_tokens=args.mean_new)
    # common system prompt: every request opens with the same token run —
    # the multi-tenant traffic shape radix prefix sharing pays off on
    system = rng.integers(0, eng.cfg.vocab_size,
                          size=args.max_context) if args.shared_frac else None
    for i, (plen, new) in enumerate(trace):
        plen = max(1, min(int(plen * factor), args.max_context - new - 1))
        prompt = rng.integers(0, eng.cfg.vocab_size, size=plen)
        if system is not None:
            k = min(int(plen * args.shared_frac), plen - 1)
            prompt[:k] = system[:k]
        eng.submit(Request(i, prompt, new))


def main(argv=None):
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
    if eng.cache is not None:
        print(f"[serve] kvcache: hits={cs['hits']}/{cs['lookups']} "
              f"reused_tokens={cs['hit_tokens']} cow={cs['cow_copies']} "
              f"evicted={cs['evicted_pages']} "
              f"swap_out={cs.get('swapped_out_pages', 0)} "
              f"swap_in={cs.get('swapped_in_pages', 0)}", flush=True)
    return st.completed


if __name__ == "__main__":
    main()
