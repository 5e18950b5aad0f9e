"""PrefixCache — the facade tying radix tree, host tier, policy and
allocator into one KV-cache hierarchy for the serving engine.

Port of ``repro/kvcache/cache.py``: the same bookkeeping, with the device
side in place. ``apply_pending`` writes the queued swap-ins and copies into
the pool tensors themselves and returns the same dict (the engine never
rebinds its pool: captured decode graphs hold its address), and the host
tier and the op queue share one ``HostCopier`` so a swap-in orders itself
after the swap-out copy that filled its payload.

Responsibilities and the tick choreography:

* ``lookup(req_id, tokens)`` at admission: longest-prefix match, pin the
  matched path, swap host-resident path nodes back in (allocating
  tree-owned device pages, queueing the scatters), and stage a CoW source
  when the walk diverges mid-page. Returns a ``CacheHit`` whose ``pages``
  the scheduler hands to ``PageAllocator.admit_shared``.
* ``commit(req_id, table)`` right after admission binds the CoW copy to the
  request's first private page.
* ``apply_pending(pool)`` (engine, before the tick's prefill) applies all
  queued device ops to the pool in place — swap-in scatters first, then
  CoW copies.
* ``insert(req_id, tokens)`` after a prefill completes / a request finishes
  or is preempted: record the written full pages under the tree (the tree
  increfs them, so they outlive the request).
* ``release(req_id)`` unpins; ``maintain()`` once per tick drains last
  tick's swap-outs (ping-pong) and enforces the occupancy watermarks.
* reclaimer protocol (``reclaimable`` / ``reclaim``): the allocator calls
  back under exhaustion, so cold cached pages count as admission capacity
  and are evicted/offloaded exactly on demand.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.kvcache.offload import DeviceOpQueue, HostCopier, HostTier
from repro_torch.kvcache.policy import EvictionPolicy, make_cache_policy
from repro_torch.kvcache.radix import RadixNode, RadixTree
from repro_torch.runtime.faults import NULL_FAULTS


@dataclass
class CacheHit:
    """What admission gets back from a lookup."""
    req_id: int
    pages: list[int]                    # device pages to borrow, in order
    matched: int                        # tokens of KV reused (incl. CoW run)
    deepest: RadixNode | None           # pinned path handle
    cow_node: RadixNode | None = None   # pinned while the copy is queued
    cow_tokens: int = 0
    cow_src: int | None = None          # device page id (None: host payload)
    cow_host: dict | None = None        # host page payload when src offloaded
                                        # (views of the node's host buffer)
    cow_applied: bool = False

    @property
    def n_shared_pages(self) -> int:
        return len(self.pages)


@dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0
    hit_tokens: int = 0                 # prefill tokens skipped
    cow_copies: int = 0
    inserted_pages: int = 0
    evicted_pages: int = 0              # dropped from device (incl. offloads)
    reclaims: int = 0                   # on-demand reclaim calls
    swap_in_fails: int = 0              # refused swap-ins (real or injected)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


class PrefixCache:
    def __init__(self, alloc, *, policy: EvictionPolicy | str = "lru",
                 host_pages: int = 0,
                 pool_ref: Callable[[], dict] | None = None,
                 swap_retry_limit: int = 3, swap_backoff_cap: int = 8):
        self.alloc = alloc
        alloc.reclaimer = self              # cold cached pages = capacity
        self.tree = RadixTree(alloc.page_size)
        self.policy = make_cache_policy(policy)
        copier = HostCopier()
        self.host = HostTier(host_pages, copier) if host_pages > 0 else None
        # transient-failure absorption BEFORE the degrade_after ladder: up
        # to swap_retry_limit consecutive failed swap-ins are retried after
        # a capped-exponential backoff (1, 2, 4, ... maintain() ticks) and
        # counted as TierStats.swap_retries; only failures past the budget
        # advance stats.swap_in_fails toward dropping the tier
        self.swap_retry_limit = swap_retry_limit
        self.swap_backoff_cap = swap_backoff_cap
        self._swap_streak = 0               # consecutive failed swap-ins
        self._swap_retry_at = 0             # maintain-tick backoff gate
        self._mtick = 0                     # maintain() call counter
        self._dropped_stats: "TierStats | None" = None
        self.ops = DeviceOpQueue(copier)
        # pool_ref: () -> {"k","v"} pool tensors — swap-out gathers read
        # the engine's pool at dispatch time
        self.pool_ref = pool_ref
        self.stats = CacheStats()
        # fault injection (repro.runtime.faults): the engine threads its
        # injector here so swap-tier refusal is deterministically replayable
        self.faults = NULL_FAULTS
        self._hits: dict[int, CacheHit] = {}
        # reclaimable() is consulted by every can_admit (once per queued
        # candidate per tick): memoize the tree walk and invalidate on any
        # mutation that can change eligibility (pins, structure, device ops)
        self._reclaimable_memo: int | None = None

    # ------------------------------------------------------------------
    # admission path
    # ------------------------------------------------------------------
    def lookup(self, req_id: int, tokens: np.ndarray) -> CacheHit:
        """Match, pin, swap in. Caps the match at len(tokens) - 1 so at
        least one suffix token runs through prefill (first-token logits)."""
        assert req_id not in self._hits, req_id
        self._mutated()
        tokens = np.asarray(tokens, np.int32)
        self.stats.lookups += 1
        res = self.tree.match(tokens, max_tokens=len(tokens) - 1)
        # materialize host-resident path nodes (swap-in); on pool pressure
        # the match truncates at the last materializable node. The pin is
        # extended node-by-node BEFORE each materialization: _swap_in's
        # allocation may reclaim, and an unpinned not-yet-collected path
        # node would be fair game for eviction — the walk would then read
        # freed pages (or a discarded host payload) into the hit.
        pages: list[int] = []
        matched = 0
        deepest = self.tree.root
        self.tree.pin(self.tree.root)
        for node in res.path:
            node.ref += 1               # ancestors already hold the pin
            if node.on_host and not self._swap_in(node):
                node.ref -= 1
                res.cow_node, res.cow_tokens = None, 0
                break
            pages += node.pages
            matched += len(node.tokens)
            deepest = node
        hit = CacheHit(req_id, pages, matched, deepest)
        if res.cow_node is not None and not res.cow_node.on_host \
                and res.cow_node.pages is None:
            res.cow_node = None             # dropped by a reclaim mid-lookup
        if res.cow_node is not None and res.cow_tokens > 0:
            hit.cow_node, hit.cow_tokens = res.cow_node, res.cow_tokens
            hit.matched += res.cow_tokens
            if res.cow_node.on_host:
                # views of the node's page 0: the buffer stays alive with
                # the view, and a host payload is never written again
                host = res.cow_node.host
                hit.cow_host = {"k": host["k"][:, :1],
                                "v": host["v"][:, :1]}
                hit.cow_node = None         # payload captured; no pin needed
            else:
                hit.cow_src = res.cow_node.pages[0]
                self.tree.pin(res.cow_node)  # keep the source page resident
        if hit.matched < self.tree.page_size:
            # trivial sub-page match (e.g. one accidentally-equal leading
            # token): the CoW copy + suffix-path prefill would cost more
            # than the tokens it saves, and a lone hit fragments the
            # admission tick's batched prefill — treat as a miss
            self.tree.unpin(hit.deepest)
            if hit.cow_node is not None:
                self.tree.unpin(hit.cow_node)
            hit = CacheHit(req_id, [], 0, self.tree.root)
            self.tree.pin(self.tree.root)
        if hit.matched > 0:
            self.stats.hits += 1
            self.stats.hit_tokens += hit.matched
        self._hits[req_id] = hit
        return hit

    def commit(self, req_id: int, table: list[int]) -> None:
        """Bind post-admission state: the CoW copy lands in the request's
        first page after the shared prefix."""
        hit = self._hits[req_id]
        self._mutated()
        if hit.cow_tokens > 0:
            dst = table[hit.n_shared_pages]
            if hit.cow_host is not None:
                self.ops.queue_host_write(req_id, dst, hit.cow_host)
            else:
                self.ops.queue_copy(req_id, hit.cow_src, dst)
            self.stats.cow_copies += 1

    def cached_len(self, req_id: int) -> int:
        hit = self._hits.get(req_id)
        return hit.matched if hit is not None else 0

    def release(self, req_id: int) -> None:
        """Unpin a request's matched path (finish / preemption). Cancels any
        not-yet-applied request-tagged ops (their target pages are being
        released with the request)."""
        hit = self._hits.pop(req_id, None)
        if hit is None:
            return
        self._mutated()
        self.tree.unpin(hit.deepest)
        if hit.cow_node is not None and not hit.cow_applied:
            self.tree.unpin(hit.cow_node)
        self.ops.cancel(req_id)

    def peek(self, tokens: np.ndarray) -> tuple[int, int]:
        """(device_pages, host_pages) an admission would reuse — estimate
        for admission policies, no side effects."""
        tokens = np.asarray(tokens, np.int32)
        if len(tokens) <= 1:
            return 0, 0
        return self.tree.peek(tokens, max_tokens=len(tokens) - 1)

    # ------------------------------------------------------------------
    # insert path
    # ------------------------------------------------------------------
    def insert(self, req_id: int, tokens: np.ndarray) -> int:
        """Record the request's written KV (full pages only) under the
        tree. Newly adopted pages gain a tree reference so they survive the
        request's ``free``. Returns the number of pages adopted."""
        tokens = np.asarray(tokens, np.int32)
        if len(tokens) < self.tree.page_size:
            return 0
        self._mutated()
        table = self.alloc.pages_of(req_id)
        adopted = self.tree.insert(tokens, table)
        n = 0
        for _node, pages in adopted:
            for p in pages:
                self.alloc.incref(p)
                n += 1
        self.stats.inserted_pages += n
        return n

    # ------------------------------------------------------------------
    # device-op application (engine-side, once per tick before prefill)
    # ------------------------------------------------------------------
    @property
    def has_pending(self) -> bool:
        return not self.ops.empty

    def apply_pending(self, pool: dict) -> dict:
        self._mutated()
        pool = self.ops.apply(pool)
        for hit in self._hits.values():
            if hit.cow_node is not None and not hit.cow_applied:
                self.tree.unpin(hit.cow_node)
                hit.cow_applied = True
        return pool

    # ------------------------------------------------------------------
    # capacity tier: eviction / offload / reclaim
    # ------------------------------------------------------------------
    def _swap_in(self, node: RadixNode) -> bool:
        """Bring an offloaded node's payload back onto device pages. A
        refusal (real pool exhaustion, injected swap failure, or a dropped
        tier) truncates the caller's match at the last materializable node
        — prefill covers the rest, so refusal costs recompute, never
        correctness."""
        if self.host is None:               # tier dropped (degradation)
            return False
        if self._mtick < self._swap_retry_at:
            return False                    # backing off after a failure
        if self.faults.enabled and self.faults.fire(
                "swap_fail", key=self.stats.lookups):
            self._swap_failed()
            return False
        try:
            pages = self.alloc.alloc_pages(node.n_pages)
        except MemoryError:
            self._swap_failed()
            return False
        self._swap_streak = 0
        data = self.host.take(node)
        node.pages = pages
        self.ops.queue_scatter(pages, data["k"], data["v"])
        return True

    def _swap_failed(self) -> None:
        """Account one failed swap-in. The first ``swap_retry_limit``
        consecutive failures are treated as transient: counted in
        ``TierStats.swap_retries`` and gated behind a capped exponential
        backoff window so the tier is not hammered while unhealthy. Only a
        failure past the retry budget advances ``stats.swap_in_fails`` —
        the counter the engine's degrade_after ladder watches — so one
        pressure blip no longer walks the cache toward dropping the tier."""
        self._swap_streak += 1
        if self._swap_streak <= self.swap_retry_limit:
            self.host.stats.swap_retries += 1
            self._swap_retry_at = self._mtick + min(
                self.swap_backoff_cap, 1 << (self._swap_streak - 1))
            return
        self.stats.swap_in_fails += 1

    def drop_host_tier(self) -> int:
        """Degradation: abandon the host offload tier after repeated swap
        failures. Unpinned host-resident nodes are discarded and removed
        from the tree (their payloads were cold copies — the engine can
        always recompute them from tokens); the tier handle goes to None so
        ``maintain()`` stops offloading and ``_swap_in`` refuses, turning
        every future host hit into a plain miss. Still-pinned or inner
        host-resident nodes stay in the tree with their dead payload; a
        walk that reaches one refuses to materialize it and truncates
        there (the lookup's existing fallback). Returns nodes dropped."""
        if self.host is None:
            return 0
        self._mutated()
        self._dropped_stats = self.host.stats   # keep the tier's counters
        self.host.drain()                       # visible post-degradation
        n = 0
        while True:                         # removal is leaf-only; peel
            cands = [c for c in self.tree.nodes()
                     if c.on_host and c.ref == 0 and c.is_leaf]
            if not cands:
                break
            for node in cands:
                self.host.discard(node)
                self.tree.remove(node)
                n += 1
        self.host = None
        return n

    def _make_host_room(self, n_pages: int) -> None:
        """Tier eviction: discard the coldest unpinned host-resident leaves
        until ``n_pages`` fit (LRU within the tier, like the device side)."""
        while not self.host.has_space(n_pages):
            cands = [c for c in self.tree.leaves()
                     if c.on_host and c.ref == 0]
            if not cands:
                return
            victim = min(cands, key=lambda c: c.tick)
            self.host.discard(victim)
            self.tree.remove(victim)

    def _evict_node(self, node: RadixNode) -> int:
        """Take a victim off the device pool. Returns pages actually freed
        (a page survives if a running request still owns a reference)."""
        pages = node.pages
        if self.host is not None and not self.host.has_space(len(pages)):
            self._make_host_room(len(pages))
        if self.policy.should_offload(node, self.host):
            self.host.swap_out(node, self.pool_ref())
            freed = sum(1 for p in pages if self.alloc.decref(p))
        else:                               # drop (leaves only)
            freed = sum(1 for p in pages if self.alloc.decref(p))
            self.tree.remove(node)
            node.pages = None               # anyone still holding the node
        self.stats.evicted_pages += len(pages)  # (e.g. a CoW source picked
        return freed                            # mid-lookup) sees it's gone

    def _mutated(self) -> None:
        self._reclaimable_memo = None

    def reclaimable(self) -> int:
        """Device pages the cache could give back on demand (unpinned tree
        payload) — counted by the allocator as admission capacity. Memoized
        between mutations (see __init__)."""
        if self._reclaimable_memo is None:
            inflight = self.ops.inflight_pages()
            # count pages, not nodes: a page a running request still
            # references (tree ref + request ref => ref_of > 1) would
            # survive eviction, so advertising it as capacity lets
            # admission overcommit and walk straight into mid-decode
            # preemptions the count was supposed to prevent
            self._reclaimable_memo = sum(
                sum(1 for p in n.pages if self.alloc.ref_of(p) == 1)
                for n in self.tree.nodes()
                if not n.on_host and n.ref == 0
                and not (inflight and set(n.pages) & inflight))
        return self._reclaimable_memo

    def reclaim(self, n_pages: int, *, offload_only: bool = False) -> int:
        """Allocator exhaustion callback: free >= n_pages if possible.
        ``offload_only`` restricts eviction to host-tier offloads (watermark
        maintenance must not destroy cold state that on-demand reclaim
        could still have dropped lazily)."""
        self.stats.reclaims += 1
        self._mutated()
        freed = 0
        inflight = self.ops.inflight_pages()
        while freed < n_pages:
            victim = self.policy.next_victim(self.tree, inflight=inflight,
                                             host_tier=self.host)
            if victim is None:
                break
            if offload_only and not self.policy.should_offload(victim,
                                                               self.host):
                break
            freed += self._evict_node(victim)
        return freed

    def maintain(self) -> None:
        """Once-per-tick background work: drain last tick's swap-outs
        (ping-pong double buffer) and enforce the occupancy watermarks.
        Watermark pressure only moves cold payload to the host tier
        (proactive: later demand becomes a swap instead of a recompute);
        with no tier — or a full one — pages stay put for the allocator's
        on-demand reclaim, and running requests' own occupancy never
        triggers a pointless tree flush."""
        self._mtick += 1                    # backoff windows are measured
        if self.host is None:               # in maintain() ticks
            return
        self.host.drain()
        need = self.policy.pressure_pages(self.alloc)
        if need > 0:
            self.reclaim(need, offload_only=True)
            self.stats.reclaims -= 1        # watermark, not on-demand

    # ------------------------------------------------------------------
    def stats_dict(self) -> dict:
        out = self.stats.as_dict()
        out["tree_device_pages"] = self.tree.device_pages()
        out["tree_host_pages"] = self.tree.host_pages()
        if self.host is not None:
            out.update(self.host.stats.as_dict())
        elif self._dropped_stats is not None:
            out.update(self._dropped_stats.as_dict())
        return out
