"""The KV-cache hierarchy under shared-prefix traffic, through the port's
engine: radix prefix sharing and the host offload tier.

    python -m repro_torch.launch.kvcache_bench --device cpu --json kv.json

The port's counterpart of ``benchmarks/kvcache_bench.py``, at its
configuration (reduced llama3.2-1b, fp32, 8 slots, 8-token pages, context
544, ``step()`` per token). Waves of 8 requests of 512 tokens, 8 new each,
whose prompts open with a share (0 / 50 / 90%) of one system prompt; the
first waves warm the radix tree, the last is measured, with the prefix
cache and without it on 1024 pages: TTFT from the wave's submission, wave
tok/s, peak device pages, cache hits and reused tokens. Outputs must be
equal with and without the cache; at 90% the cache must hit at least 16
times and hold fewer pages. Its TTFT ratio is printed and kept in the row,
not asserted: the reference's 2x is a CPU timing, and on the card a wave's
prefill costs about the same with and without the cache. Then two tenants
with their own system prompts take turns on a 40-page pool with a 128-page
host tier and no same-tick dedup: their admitted KV must exceed the pool,
and the host tier must take pages out and bring them back.

The system prompts are 512 ids drawn inside the vocabulary from the seeds
5000 and 7000 (``system_prompt``); the reference's ids 5000-5511 and
7000-7511 lie outside the reduced vocabulary of 256. The cache's counters
depend on the ids and the scheduling alone.

``--json PATH`` writes ``{"bench": "kvcache", "rows": [...]}``, one row a
share level and one for the host tier. Weights are the port's seeded
``init_params`` unless ``run`` / ``bench`` get ``params``. The engines run
on the card unless ``--device cpu``.
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
from repro_torch.serving import DecodeEngine, EngineConfig, Request

PAGE = 8
SHARES = (0.0, 0.5, 0.9)
SYSTEM_SEEDS = (5000, 7000)     # one system prompt a tenant


def bench_config():
    return replace(reduced(get_config("llama3.2-1b")), dtype="float32")


def system_prompt(cfg, tenant: int = 0) -> np.ndarray:
    """Tenant ``tenant``'s 512-token system prompt, ids in the vocabulary."""
    rng = np.random.default_rng(SYSTEM_SEEDS[tenant])
    return rng.integers(0, cfg.vocab_size, size=512).astype(np.int32)


def _make_engine(cfg, params, *, cache, n_pages, host_pages=0, dedup=True,
                 device=None):
    ecfg = EngineConfig(n_slots=8, page_size=PAGE, n_pages=n_pages,
                        max_context=544, eos_token=-1,
                        prefix_cache=cache, host_pages=host_pages,
                        prefill_dedup=dedup)
    return DecodeEngine(cfg, ecfg, params, device=device)


def _wave(eng, cfg, wave_id, *, system, shared_frac, requests=8,
          prompt_len=512, new_tokens=8):
    """Submit one wave, drain it with ``step()``, and measure each
    request's TTFT, the wave's tok/s and its peak pages."""
    rng = np.random.default_rng(wave_id)
    k = int(prompt_len * shared_frac)
    ids = []
    for i in range(requests):
        rid = 1000 * wave_id + i
        tail = rng.integers(0, cfg.vocab_size, size=prompt_len - k)
        eng.submit(Request(rid, np.concatenate([system[:k], tail]).astype(
            np.int32), new_tokens))
        ids.append(rid)
    first_tok: dict[int, float] = {}
    peak_pages = peak_kv = 0
    finished = None
    t0 = time.perf_counter()
    for _ in range(10_000):
        if eng.batcher.done():
            break
        finished = eng.step(finished)
        now = time.perf_counter()
        for rid in ids:
            if eng.outputs[rid] and rid not in first_tok:
                first_tok[rid] = now - t0
        peak_pages = max(peak_pages, eng.alloc.pages_in_use)
        peak_kv = max(peak_kv, sum(len(eng.alloc.pages_of(r.req_id))
                                   for r in eng.batcher.slots
                                   if r is not None))
    dt = time.perf_counter() - t0
    toks = sum(len(eng.outputs[r]) for r in ids)
    return {"ttft": float(np.mean([first_tok[r] for r in ids])),
            "tok_s": toks / max(dt, 1e-9), "peak_pages": peak_pages,
            "peak_kv": peak_kv, "tokens": toks,
            "outputs": {r: list(eng.outputs[r]) for r in ids}}


def bench(*, shared_frac, cache, n_pages=1024, waves=3, params=None,
          device=None):
    """``waves`` waves at one share level (the last one measured); the
    result carries the engine under ``eng``."""
    cfg = bench_config()
    dev = resolve_device(device)
    if params is None:
        params = MDL.init_params(cfg, 0, torch.float32, dev)
    eng = _make_engine(cfg, params, cache=cache, n_pages=n_pages, device=dev)
    system = system_prompt(cfg)
    last = None
    for w in range(1, waves + 1):
        last = _wave(eng, cfg, w, system=system, shared_frac=shared_frac)
    last["eng"] = eng
    return last


def run(emit, *, params=None, device=None) -> list[dict]:
    """The share sweep and the host-tier scenario with the reference's
    checks but its CPU TTFT ratio; ``emit(name, us, derived)`` gets its
    lines. Returns the rows."""
    dev = resolve_device(device)
    cfg = bench_config()
    if params is None:
        params = MDL.init_params(cfg, 0, torch.float32, dev)
    rows = []
    for frac in SHARES:
        base = bench(shared_frac=frac, cache=False, params=params,
                     device=dev)
        got = bench(shared_frac=frac, cache=True, params=params, device=dev)
        assert got["outputs"] == base["outputs"], \
            f"prefix sharing changed greedy outputs at {frac}"
        st = got["eng"].cache.stats
        row = {"name": f"kvcache_shared{int(frac * 100)}",
               "shared_frac": frac, "ttft_us": 1e6 * got["ttft"],
               "base_ttft_us": 1e6 * base["ttft"],
               "ttft_x": base["ttft"] / max(got["ttft"], 1e-9),
               "tok_s": got["tok_s"], "base_tok_s": base["tok_s"],
               "peak_pages": got["peak_pages"],
               "base_peak_pages": base["peak_pages"],
               "hits": st.hits, "reused_tokens": st.hit_tokens,
               "tokens": got["tokens"]}
        emit(row["name"], row["ttft_us"],
             f"ttft_x={row['ttft_x']:.2f} "
             f"tok/s={got['tok_s']:.1f} vs {base['tok_s']:.1f} "
             f"pages={got['peak_pages']} vs {base['peak_pages']} "
             f"reused_tokens={row['reused_tokens']}")
        rows.append(row)
        if frac == 0.9:
            assert row["hits"] >= 16, "90%-shared waves should hit the cache"
            assert got["peak_pages"] < base["peak_pages"], \
                "sharing should hold fewer device pages"
        del base, got

    # capacity tier: two tenants' working set exceeds the 40-page pool;
    # watermark pressure offloads the cold tenant's prefix to the host tier
    # and its next wave swaps it back in (same-tick dedup off: the pressure
    # comes from cold bursts landing at once)
    eng = _make_engine(cfg, params, cache=True, n_pages=40, host_pages=128,
                       dedup=False, device=dev)
    sys_a, sys_b = system_prompt(cfg, 0), system_prompt(cfg, 1)
    peak_kv = 0
    for w, system in ((1, sys_a), (2, sys_b), (3, sys_a), (4, sys_b)):
        r = _wave(eng, cfg, w, system=system, shared_frac=0.9,
                  prompt_len=64)
        peak_kv = max(peak_kv, r["peak_kv"])
    ts = eng.cache.host.stats
    row = {"name": "kvcache_offload_tier", "ttft_us": 1e6 * r["ttft"],
           "tok_s": r["tok_s"], "admitted_kv_pages": peak_kv,
           "pool_pages": 40, "swapped_out_pages": ts.swapped_out_pages,
           "swapped_in_pages": ts.swapped_in_pages}
    emit(row["name"], row["ttft_us"],
         f"admitted_kv={peak_kv}p pool=40p "
         f"swap_out={ts.swapped_out_pages} swap_in={ts.swapped_in_pages} "
         f"tok/s={r['tok_s']:.1f}")
    rows.append(row)
    assert peak_kv > 40, "batch KV should exceed the device pool"
    assert ts.swapped_out_pages > 0 and ts.swapped_in_pages > 0
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the rows as JSON")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(lambda n, us, d: print(f"{n},{us:.2f},{d}", flush=True),
               device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"bench": "kvcache", "rows": rows}, f, indent=2)
        print(f"# wrote {args.json}")
    print("# kvcache_bench OK")
    return rows


if __name__ == "__main__":
    main()
