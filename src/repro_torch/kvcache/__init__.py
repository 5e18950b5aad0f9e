"""KV-cache hierarchy: radix prefix sharing + host offload tier.

Port of ``repro/kvcache`` (see ``docs/kvcache.md``), layered under the
serving engine:

* ``radix``   — token-prefix radix tree over allocator pages (refcounted
  sharing, page-boundary splits, copy-on-write on mid-page divergence);
* ``offload`` — host-DRAM capacity tier: pinned host buffers filled on a
  side stream, drained ping-pong style;
* ``policy``  — pluggable placement/eviction (LRU, watermarks);
* ``cache``   — the ``PrefixCache`` facade the engine and scheduler use;
* ``handoff`` — the checksummed wire blob that moves a finished prefill's
  KV pages and recurrent carry between the cluster's engines
  (``serving/cluster.py``).
"""
from repro_torch.kvcache.cache import CacheHit, CacheStats, PrefixCache
from repro_torch.kvcache.handoff import Handoff, HandoffError
from repro_torch.kvcache.offload import (DeviceOpQueue, HostCopier, HostTier,
                                         TierStats)
from repro_torch.kvcache.policy import (EvictionPolicy, LRUPolicy,
                                        WatermarkConfig, make_cache_policy)
from repro_torch.kvcache.radix import MatchResult, RadixNode, RadixTree

__all__ = [
    "PrefixCache", "CacheHit", "CacheStats",
    "HostTier", "TierStats", "DeviceOpQueue", "HostCopier",
    "EvictionPolicy", "LRUPolicy", "WatermarkConfig", "make_cache_policy",
    "RadixTree", "RadixNode", "MatchResult",
    "Handoff", "HandoffError",
]
