"""Host-side lazy page allocator — the DPA controller's Va2Pa bookkeeping.

The paper's on-module dispatcher maps virtual KV-chunk indices to physical
DRAM rows and allocates chunks lazily as requests grow (§5.4). Here the
physical space is the device page pool (``core/paged_kv.py``), sharded over
mesh shards; the allocator hands out page ids so that

* a request's pages stripe **round-robin across shards** (ITPP balance), and
* under ``row_affine`` policy a request only uses pages owned by its data-row
  (decode batches sharded over the ``data`` axis), while ``striped`` uses the
  whole pod (long-context, batch=1).

Pages are **refcounted** so the prefix cache (``repro.kvcache``) can share
physical pages across requests and keep finished requests' KV alive in its
radix tree: ``admit_shared`` registers a request whose leading pages are
borrowed references, ``incref``/``decref`` manage extra owners, and a page
only returns to the free lists when its last owner lets go. A pluggable
``reclaimer`` hook (the cache) is consulted when the pool runs dry — cold
cached pages are evicted/offloaded on demand, and ``available_pages`` counts
them as admission capacity.

Pure numpy/host code — this runs in the serving loop between device steps,
exactly like the paper's host updating the Va2Pa table each iteration.
"""
from __future__ import annotations

import numpy as np


class PageAllocator:
    def __init__(self, n_pages: int, n_shards: int, page_size: int, *,
                 policy: str = "striped", n_rows: int = 1,
                 static_max_pages: int | None = None,
                 ring_pages: int | None = None,
                 blocked_chunk: int | None = None):
        assert n_pages % n_shards == 0, (n_pages, n_shards)
        assert policy in ("striped", "row_affine")
        assert n_shards % n_rows == 0
        self.n_pages = n_pages
        self.n_shards = n_shards
        self.pages_per_shard = n_pages // n_shards
        self.page_size = page_size
        self.policy = policy
        self.n_rows = n_rows
        self.shards_per_row = n_shards // n_rows
        # static_max_pages: baseline-PIM behaviour — reserve the max-context
        # page count at admission (the paper's static allocation strawman).
        self.static_max_pages = static_max_pages
        # ring_pages: sliding-window pools — a request never needs more than
        # this many pages; virtual slots beyond it recycle (mod ring_pages)
        self.ring_pages = ring_pages
        # blocked_chunk: virtual page v targets shard cycle[(v//chunk) %
        # n_cycle] — contiguous runs per shard align page ownership with the
        # sequence-sharded prefill writes so the pool scatter is shard-LOCAL
        # (zero collectives; EXPERIMENTS.md §Perf P1). Balance across shards
        # is preserved (each shard still holds ~maxp/stripe pages/request).
        self.blocked_chunk = blocked_chunk
        # per-shard free lists (a page's shard = page // pages_per_shard,
        # matching jax's contiguous sharding of the pool's page axis)
        self._free: list[list[int]] = [
            list(range(s * self.pages_per_shard + self.pages_per_shard - 1,
                       s * self.pages_per_shard - 1, -1))
            for s in range(n_shards)]
        self._tables: dict[int, list[int]] = {}   # req -> Va2Pa (virtual order)
        self._rr: dict[int, int] = {}             # req -> round-robin cursor
        self._row: dict[int, int] = {}
        self._refs: dict[int, int] = {}           # page -> owner count (>0)
        # reclaimer: object with ``reclaimable() -> int`` and
        # ``reclaim(n) -> int`` (pages actually freed). Set by the prefix
        # cache; consulted on exhaustion before raising MemoryError and when
        # counting admission capacity.
        self.reclaimer = None

    # ------------------------------------------------------------------
    def shard_of(self, page: int) -> int:
        return page // self.pages_per_shard

    def row_of_request(self, req: int) -> int | None:
        return self._row.get(req)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - sum(len(f) for f in self._free)

    def free_pages_in_row(self, row: int) -> int:
        lo = row * self.shards_per_row
        return sum(len(self._free[s]) for s in range(lo, lo + self.shards_per_row))

    @property
    def free_page_count(self) -> int:
        return sum(len(f) for f in self._free)

    def available_pages(self, row: int | None = None) -> int:
        """Admission capacity: free pages plus whatever the reclaimer could
        evict on demand (cold cached pages). Row-affine counts only the
        row's free pages plus the global reclaimable pool (reclaim does not
        target a specific row, so this is an optimistic bound)."""
        free = self.free_pages_in_row(row) if row is not None \
            else self.free_page_count
        if self.reclaimer is not None:
            free += self.reclaimer.reclaimable()
        return free

    def ref_of(self, page: int) -> int:
        return self._refs.get(page, 0)

    def pages_of(self, req: int) -> list[int]:
        """The request's Va2Pa table (copy, virtual order)."""
        return list(self._tables[req])

    # ------------------------------------------------------------------
    def _shard_cycle(self, req: int) -> list[int]:
        if self.policy == "row_affine":
            row = self._row[req]
            lo = row * self.shards_per_row
            return list(range(lo, lo + self.shards_per_row))
        return list(range(self.n_shards))

    def can_admit(self, n_tokens: int, row: int | None = None,
                  cached_pages: int = 0) -> bool:
        """``cached_pages``: pages the request would borrow from the prefix
        cache instead of allocating (reduces the need)."""
        need = self._pages_for(n_tokens)
        if self.static_max_pages is not None:
            need = self.static_max_pages
        need = max(0, need - cached_pages)
        if self.policy == "row_affine":
            assert row is not None
        return self.available_pages(row if self.policy == "row_affine"
                                    else None) >= need

    def _pages_for(self, n_tokens: int) -> int:
        n = max(1, -(-n_tokens // self.page_size))
        return min(n, self.ring_pages) if self.ring_pages else n

    def admit(self, req: int, n_tokens: int, row: int | None = None) -> list[int]:
        """Allocate pages for a request's first n_tokens (the prefill).

        Under static mode reserves static_max_pages regardless of n_tokens —
        the baseline the paper's lazy allocation beats.
        """
        return self.admit_shared(req, (), n_tokens, row)

    def admit_shared(self, req: int, shared_pages, n_tokens: int,
                     row: int | None = None) -> list[int]:
        """Admit ``req`` whose leading pages are borrowed references to
        already-resident pages (a prefix-cache hit): each shared page gets an
        extra owner, and only the remainder of the prompt footprint is
        allocated fresh. With ``shared_pages=()`` this is plain ``admit``."""
        assert req not in self._tables, req
        shared = list(shared_pages)
        if shared:
            assert self.static_max_pages is None and self.ring_pages is None, \
                "prefix sharing is incompatible with static/ring allocation"
        if self.policy == "row_affine":
            assert row is not None
            self._row[req] = row
        self._tables[req] = []
        self._rr[req] = 0
        try:
            for p in shared:
                self.incref(p)
                self._tables[req].append(p)
            need = self._pages_for(n_tokens) - len(shared)
            if self.static_max_pages is not None:
                need = self.static_max_pages
            if need > 0:
                self._grow(req, need)
        except MemoryError:
            self.free(req)              # release borrowed refs + fresh pages
            raise
        if shared:
            self._notify_reclaimer()    # borrowed pages gained an owner
        return list(self._tables[req])

    def ensure(self, req: int, n_tokens: int, *,
               reclaim: bool = True) -> list[int]:
        """Lazy growth: make sure the request can hold n_tokens; returns any
        newly allocated pages (usually 0 or 1 per decode step). Shrink-safe:
        asking for fewer tokens than already covered is a no-op (pages are
        only released by ``free``), and non-positive token counts are treated
        as the minimum footprint. ``reclaim=False`` grows from the free
        lists only — a MemoryError then means "would have to evict cached
        pages", letting gentle horizon reservation degrade instead of
        churning the radix cache (committed per-token growth still
        reclaims)."""
        need = self._pages_for(n_tokens)
        have = len(self._tables[req])
        if self.static_max_pages is not None and need > have:
            raise MemoryError(
                f"req {req} exceeded static reservation ({need} > {have})")
        if need <= have:
            return []
        return self._grow(req, need - have, reclaim=reclaim)

    def _pop_page(self, req: int) -> int | None:
        """One page off the free lists, honoring placement policy; None when
        the request's shard cycle is exhausted."""
        cycle = self._shard_cycle(req)
        if self.blocked_chunk:
            v = len(self._tables[req])              # virtual page index
            start = (v // self.blocked_chunk) % len(cycle)
        else:
            start = self._rr[req]
        for i in range(len(cycle)):
            s = cycle[(start + i) % len(cycle)]
            if self._free[s]:
                page = self._free[s].pop()
                if not self.blocked_chunk:
                    self._rr[req] = (start + i + 1) % len(cycle)
                return page
        return None

    def _grow(self, req: int, count: int, *,
              reclaim: bool = True) -> list[int]:
        new = []
        for _ in range(count):
            page = self._pop_page(req)
            if page is None and reclaim and self.reclaimer is not None:
                # pool exhausted: ask the cache to evict/offload cold pages,
                # then retry (the paper's DPA never stalls on static waste;
                # here the capacity tier absorbs the overflow instead)
                if self.reclaimer.reclaim(count - len(new)) > 0:
                    page = self._pop_page(req)
            if page is None:
                # roll back this grow to keep state consistent
                for p in new:
                    self._tables[req].pop()
                    del self._refs[p]
                    self._free[self.shard_of(p)].append(p)
                raise MemoryError("page pool exhausted")
            self._refs[page] = 1
            self._tables[req].append(page)
            new.append(page)
        return new

    # ------------------------------------------------------------------
    def alloc_pages(self, count: int) -> list[int]:
        """Raw tree-owned allocation (no request table) — used by the prefix
        cache to back swap-ins. Consults the reclaimer on exhaustion like
        ``_grow`` (cold cached pages make room for hot swap-ins). Pages come
        back with refcount 1; the caller owns the reference and releases via
        ``decref``."""
        new: list[int] = []
        for _ in range(count):
            page = self._pop_any()
            if page is None and self.reclaimer is not None:
                if self.reclaimer.reclaim(count - len(new)) > 0:
                    page = self._pop_any()
            if page is None:
                for p in new:
                    del self._refs[p]
                    self._free[self.shard_of(p)].append(p)
                raise MemoryError("page pool exhausted")
            self._refs[page] = 1
            new.append(page)
        return new

    def _pop_any(self) -> int | None:
        for s in range(self.n_shards):
            if self._free[s]:
                return self._free[s].pop()
        return None

    def incref(self, page: int) -> None:
        """Add an owner to a resident page (prefix sharing / tree retention)."""
        if page not in self._refs:
            raise ValueError(f"incref of unallocated page {page}")
        self._refs[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one owner; frees the page when the last owner lets go.
        Returns True iff the page went back to the free lists."""
        ref = self._refs.get(page)
        if ref is None:
            raise ValueError(f"decref of free page {page} (double free?)")
        if ref > 1:
            self._refs[page] = ref - 1
            return False
        del self._refs[page]
        self._free[self.shard_of(page)].append(page)
        return True

    def free(self, req: int) -> int:
        """Release all of a finished request's page references (EOS). Pages
        shared with the prefix cache or other requests survive; exclusively
        owned ones return to the free lists. Returns the number of pages
        actually freed. Unknown / already-freed request ids raise — the
        serving loop must never double-free (it would silently hand a live
        request's pages to the next admission)."""
        if req not in self._tables:
            raise KeyError(
                f"PageAllocator.free: unknown or already-freed request {req}")
        pages = self._tables.pop(req)
        self._rr.pop(req, None)
        self._row.pop(req, None)
        freed = sum(1 for p in pages if self.decref(p))
        # pages the request shared with the cache just lost an owner — the
        # reclaimable-capacity memo must see the new refcounts
        self._notify_reclaimer()
        return freed

    def _notify_reclaimer(self) -> None:
        """Invalidate the reclaimer's capacity memo after a refcount
        change. Duck-typed: reclaimers without a ``_mutated`` hook (test
        stubs, custom policies) just recompute on the next query."""
        m = getattr(self.reclaimer, "_mutated", None)
        if m is not None:
            m()

    # ------------------------------------------------------------------
    def block_table(self, req: int, width: int) -> np.ndarray:
        """Va2Pa row for the device block table, -1-padded to ``width``."""
        t = self._tables[req]
        assert len(t) <= width, (len(t), width)
        out = np.full((width,), -1, np.int32)
        out[:len(t)] = t
        return out

    def shard_balance(self) -> np.ndarray:
        """Pages in use per shard — ITPP balance metric (tested: max-min <= small)."""
        used = np.full((self.n_shards,), self.pages_per_shard, np.int64)
        for s, f in enumerate(self._free):
            used[s] -= len(f)
        return used
