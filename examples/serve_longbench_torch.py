"""Serving scenario on the PyTorch/CUDA port: continuous batching over a
LongBench-statistics trace, lazy (DPA) against static allocation (the
paper's §5.4 experiment end to end), plus chunked prefill (DCS-style
overlap), the KV-cache hierarchy (radix prefix sharing and a host offload
tier) on a shared system-prompt workload, and a disaggregated 1 prefill +
1 decode engine pool with its KV handoff.

    PYTHONPATH=src python examples/serve_longbench_torch.py            # card
    PYTHONPATH=src python examples/serve_longbench_torch.py --device cpu

Each run goes through ``repro_torch.launch.serve`` (reduced llama3.2-1b,
random fp32 weights from seed 0) and prints its ``[serve]`` lines; the
average batches come from ``serve.serve``, which returns the run's stats.
"""
import argparse

from repro_torch.launch.serve import serve

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ["--device", ap.parse_args().device]
    # memory-constrained regime: static allocation reserves
    # max_context / page + 1 = 33 pages a request, so the 72-page pool holds
    # just 2 static requests, while lazy admission fits many short ones
    common = ["--requests", "10", "--slots", "6", "--page", "8",
              "--pages", "72", "--max-context", "256", "--mean-new", "10"]
    common += dev
    print("=== lazy (DPA) ===")
    lazy = serve(common)
    print("=== static (baseline PIM) ===")
    static = serve(common + ["--static"])
    print(f"\navg-batch gain from lazy allocation: "
          f"{lazy['avg_batch'] / max(static['avg_batch'], 1e-9):.2f}x "
          f"(peak pages {lazy['peak_pages']} lazy, {static['peak_pages']} "
          f"static; paper Fig. 4(b): up to 3.8x in the memory-constrained "
          f"regime); greedy tokens "
          f"{'equal' if lazy['outputs'] == static['outputs'] else 'DIFFER'}")
    print("=== lazy + chunked prefill (DCS-style overlap) ===")
    serve(common + ["--prefill-mode", "chunked", "--chunk", "16"])
    print("=== disaggregated: 1 prefill + 1 decode engine, KV handoff ===")
    disagg = serve(common + ["--disagg", "--engines", "1+1",
                             "--decode-horizon", "1"])
    print(f"disagg greedy tokens "
          f"{'equal' if disagg['outputs'] == lazy['outputs'] else 'DIFFER'}"
          f" to the colocated run's")

    # multi-tenant shared-system-prompt traffic: 90% of every prompt is the
    # same system prefix. With the prefix cache the engine prefills it once
    # and later admissions borrow the pages (prefill of the suffix only);
    # the host tier keeps evicted prefixes one swap away
    shared = common + ["--shared-frac", "0.9"]
    print("\n=== shared system prompt, no sharing (baseline) ===")
    serve(shared)
    print("=== shared system prompt + radix prefix cache ===")
    serve(shared + ["--prefix-cache"])
    print("=== + host offload tier (64 host pages) ===")
    serve(shared + ["--prefix-cache", "--host-pages", "64"])
