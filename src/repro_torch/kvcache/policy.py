"""Placement / eviction policy for the KV-cache hierarchy.

A copy of ``repro/kvcache/policy.py`` (framework-free).

Decides *which* cold radix nodes leave the device pool, *when* (watermark
pressure or on-demand reclaim), and *where to* (host tier vs dropped). The
invariants the cache facade enforces regardless of policy:

* pin-while-running — nodes on a running request's matched path have
  ref > 0 and are never victims;
* pages with an in-flight device op (queued swap-in scatter / CoW copy) are
  never victims until the op applies;
* only leaves may be *dropped* (structure stays a tree); any unpinned node
  may be *offloaded* (payload moves, structure stays).

The price of counting offloaded pages as capacity — one swap-in over the
host link — is the analytic ``core.pim_model.swap_latency`` term, which
memory-aware admission (``serving/policies.py``) adds to a candidate's
modelled cost (the placement/migration trade-off of the L3/PAM line of
work).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class WatermarkConfig:
    """Device-pool occupancy thresholds driving background offload."""
    high: float = 0.85          # start offloading above this fill fraction
    low: float = 0.60           # ...until the pool drops back to this


class EvictionPolicy:
    """Base: picks victims and decides offload-vs-drop."""
    name = "base"

    def __init__(self, watermark: WatermarkConfig | None = None):
        self.watermark = watermark or WatermarkConfig()

    def next_victim(self, tree, *, inflight: set[int], host_tier=None):
        """The next node to evict from the device pool, or None. Must be
        device-resident, unpinned, not in-flight, and *evictable*: either a
        leaf (can be dropped) or offloadable to a host tier with space."""
        raise NotImplementedError

    def should_offload(self, node, host_tier) -> bool:
        """Offload to host (True) vs drop (False) for an evicted node.
        Non-leaves MUST offload (the facade only drops leaves)."""
        return host_tier is not None and host_tier.has_space(node.n_pages)

    # ---- watermark driver --------------------------------------------
    def pressure_pages(self, alloc) -> int:
        """Pages to shed under watermark pressure (0 = below high mark)."""
        if alloc.pages_in_use <= self.watermark.high * alloc.n_pages:
            return 0
        return int(alloc.pages_in_use - self.watermark.low * alloc.n_pages)


class LRUPolicy(EvictionPolicy):
    """Least-recently-touched first. Offload victims may be internal nodes
    (deep cold prefixes leave as a unit); drop victims must be leaves, so a
    cold branch peels bottom-up."""
    name = "lru"

    def _eligible(self, node, inflight: set[int], host_tier) -> bool:
        if node.on_host or node.ref > 0 or node.pages is None:
            return False
        if inflight and set(node.pages) & inflight:
            return False
        return node.is_leaf or self.should_offload(node, host_tier)

    def next_victim(self, tree, *, inflight: set[int], host_tier=None):
        cands = [n for n in tree.nodes()
                 if self._eligible(n, inflight, host_tier)]
        if not cands:
            return None
        # prefer leaves among equally-cold nodes so structure erodes from
        # the bottom; ticks are unique (tree clock) so this is a stable
        # total order
        return min(cands, key=lambda n: (n.tick, not n.is_leaf))


def make_cache_policy(name: str = "lru", *,
                      watermark: WatermarkConfig | None = None
                      ) -> EvictionPolicy:
    if isinstance(name, EvictionPolicy):
        return name
    return {"lru": LRUPolicy}[name](watermark)
