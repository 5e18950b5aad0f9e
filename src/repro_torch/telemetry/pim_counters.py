"""Live PIM counters: the quantities ``kernel_bench`` / ``pim_model``
model offline, emitted during serving.

A copy of ``repro/telemetry/pim_counters.py`` over the port's
``core/pim_model.py`` and ``kernels/backend.py``.

PIMphony's mechanisms are utilization arguments, so the counters mirror
them one-to-one:

* **modeled HBM bytes/token** (TCP's bandwidth story) — what a decode step
  streams for the current batch/contexts, via
  ``kernels.backend.decode_hbm_bytes`` (same formula as kernel_bench's
  MB/token column), plus a cumulative modeled-bytes counter the engine
  feeds with per-horizon (tokens x context) products;
* **live vs pool occupancy** (DPA's capacity story) — pages in use, pages
  the live contexts actually need, and the waste a static max-context
  reservation would have cost instead;
* **pow2 decode-table bucket** high-water — the live width the fused
  decode actually dispatches with (``serving.prefill.decode_table_bucket``);
* **channel-utilization proxy** (ITPP) — ``pim_model.attn_channel_util``
  over the live (batch, mean context) from the scheduler's host snapshot.

Everything reads host-side scheduler/allocator state through pull
bindings: scrapes cost a few numpy reductions and the hot path pays
nothing. No device syncs anywhere in this module.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import pim_model
from repro_torch.kernels.backend import decode_hbm_bytes


class PIMCounters:
    """Binds the live PIM gauges for one engine; the engine calls
    ``on_horizon`` at each collect (host-side snapshot already in hand) and
    ``observe_bucket`` when it re-buckets the decode table."""

    def __init__(self, registry, model_cfg, batcher, *,
                 bytes_per_el: int = 2, system: pim_model.System | None = None):
        self.cfg = model_cfg
        self.batcher = batcher
        self.alloc = batcher.alloc
        self.el = int(bytes_per_el)
        self.llm = pim_model.LLM(
            model_cfg.name, model_cfg.n_layers, model_cfg.d_model,
            model_cfg.n_heads, model_cfg.n_kv_heads, model_cfg.d_head,
            model_cfg.d_ff, bytes_per_el=self.el)
        # one-node full LoL-PIM geometry unless the caller scales it
        self.system = system or pim_model.lol_pim(1)
        self.bucket_hw = 0
        self.pages_hw = 0
        r = registry
        self.c_bytes = r.counter(
            "pim_modeled_hbm_bytes_total",
            "modeled KV bytes streamed by decode (sum over emitted tokens "
            "of context x kv_bytes_per_token)")
        r.bind("pim_hbm_bytes_per_token", self._bytes_per_token,
               "modeled KV bytes one decode step streams at the live mean "
               "context")
        r.bind("pim_channel_util", self._channel_util,
               "ITPP channel-utilization proxy at the live (batch, mean "
               "context)")
        r.bind("kv_pages_total", lambda: self.alloc.n_pages,
               "device KV page pool size", labels={"tier": "device"})
        r.bind("kv_pages_in_use", lambda: self.alloc.pages_in_use,
               "device KV pages allocated (requests + cache tree)",
               labels={"tier": "device"})
        r.bind("kv_pages_in_use_peak", self._pages_peak,
               "high-water of device KV pages in use",
               labels={"tier": "device"})
        r.bind("kv_live_tokens", self._live_tokens,
               "tokens of KV the live contexts actually hold")
        r.bind("dpa_page_waste_ratio", self._waste_ratio,
               "allocated-but-unused fraction of in-use pages (lazy "
               "allocation's rounding waste)")
        r.bind("dpa_static_pages_saved", self._static_saved,
               "pages a static max-context reservation would hold beyond "
               "the lazy allocation, for the live batch")
        r.bind("decode_table_bucket", lambda: self._bucket(),
               "pow2 block-table width the next decode dispatch uses")
        r.bind("decode_table_bucket_highwater", lambda: self.bucket_hw,
               "largest pow2 decode-table bucket dispatched so far")
        cache = batcher.cache
        if cache is not None:
            r.bind("kv_cache_pages", cache.tree.device_pages,
                   "prefix-cache radix-tree pages resident on device",
                   labels={"tier": "device"})
            r.bind("kv_cache_pages", cache.tree.host_pages,
                   "prefix-cache radix-tree pages resident on the host tier",
                   labels={"tier": "host"})
            for name in ("lookups", "hits", "hit_tokens", "inserted_pages",
                         "evicted_pages", "reclaims", "cow_copies"):
                r.bind(f"kv_cache_{name}",
                       (lambda n=name: getattr(cache.stats, n)),
                       f"prefix cache {name.replace('_', ' ')}",
                       kind="counter")
            if cache.host is not None:
                host = cache.host
                r.bind("kv_pages_total", lambda: host.capacity,
                       "host offload tier capacity (pages)",
                       labels={"tier": "host"})
                r.bind("kv_pages_in_use", lambda: host.used,
                       "host offload tier pages used",
                       labels={"tier": "host"})
                r.bind("kv_pages_in_use_peak",
                       lambda: host.stats.peak_host_pages,
                       "high-water of host tier pages used",
                       labels={"tier": "host"})
                for name in ("swapped_out_pages", "swapped_in_pages",
                             "dropped_pages"):
                    r.bind(f"kv_{name}",
                           (lambda n=name: getattr(host.stats, n)),
                           f"host tier {name.replace('_', ' ')}",
                           kind="counter")

    # ---- live snapshot reductions (pull bindings) ---------------------
    def _live(self) -> tuple[int, float]:
        ctx = self.batcher._ctx
        b = int(np.count_nonzero(ctx))
        return b, (float(ctx.sum()) / b if b else 0.0)

    def _bytes_per_token(self) -> float:
        _b, avg = self._live()
        return decode_hbm_bytes(avg, self.cfg.n_kv_heads, self.cfg.d_head,
                                self.el, self.cfg.n_layers)

    def _channel_util(self) -> float:
        b, avg = self._live()
        if b == 0:
            return 0.0
        ctx = self.batcher._ctx
        live = ctx[ctx > 0].astype(np.float64)
        cv = float(live.std() / live.mean()) if live.mean() > 0 else 0.0
        return pim_model.attn_channel_util(self.system, self.llm, b, avg, cv)

    def _live_tokens(self) -> int:
        return int(self.batcher._ctx.sum())

    def _pages_peak(self) -> int:
        self.pages_hw = max(self.pages_hw, self.alloc.pages_in_use)
        return self.pages_hw

    def _waste_ratio(self) -> float:
        used = self.alloc.pages_in_use
        if used == 0:
            return 0.0
        need = float(self._live_tokens()) / self.alloc.page_size
        return max(0.0, 1.0 - need / used)

    def _static_saved(self) -> int:
        """Pages a static allocator would reserve for the live batch beyond
        what lazy allocation holds right now (DPA's headline saving)."""
        page = self.alloc.page_size
        static_pages = -(-self.batcher.max_context // page)
        occupied = sum(1 for r in self.batcher.slots if r is not None)
        lazy = int(self.batcher._npages.sum())
        return max(0, occupied * static_pages - lazy)

    def _bucket(self) -> int:
        from repro_torch.serving.prefill import decode_table_bucket
        width = self.batcher._bt_width or 1
        return decode_table_bucket(self.batcher.max_live_pages(), width)

    # ---- engine-driven updates ----------------------------------------
    def on_horizon(self, tokens_bytes: float) -> None:
        """Cumulative modeled bytes for one collected horizon: the engine
        passes sum over emitted tokens of ctx-at-dispatch x
        kv_bytes_per_token (cheap host arithmetic on data it already has).
        Also refreshes the pow2-bucket and pool high-waters."""
        self.c_bytes.inc(tokens_bytes)
        self.bucket_hw = max(self.bucket_hw, self._bucket())
        self.pages_hw = max(self.pages_hw, self.alloc.pages_in_use)

    def kv_bytes_per_token(self) -> float:
        return self.llm.kv_bytes_per_token
