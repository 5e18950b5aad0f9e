"""Continuous-batching scheduler with EOS replacement (paper Fig. 2(b)).

Slot-based: the decode batch has ``n_slots`` positions; when a request emits
EOS (or hits its token budget) its pages are freed and the slot is refilled
from the waiting queue in the same scheduling tick — the paper's
"Request-1 ... replaced with Request-5" flow. Works with either lazy (DPA)
or static (baseline) allocation, which is how the lazy-allocation benchmark
reproduces the paper's batch-size growth (Fig. 4(b), §5.4).

Three serving hooks (repro.serving builds on these):

* ``policy`` — admission is pluggable: a policy object picks which queued
  request fills an open slot (FCFS / SJF / memory-aware live in
  ``repro.serving.policies``). ``policy=None`` keeps the seed strict
  head-of-line FCFS scan.
* incrementally-maintained host snapshots — the [n_slots, width] block-table
  matrix and the context-length vector are updated page-by-page as requests
  are admitted / grown / freed instead of being rebuilt from the allocator
  dict every tick, so the engine's per-tick "configuration buffer" update
  (paper Fig. 2(c)) is O(changes), not O(slots x width).
* ``cache`` — an optional ``repro.kvcache.PrefixCache``: admission borrows
  the matched prefix pages (``admit_shared``) and records the resume depth
  on the request (``cached_len``); finished *and preempted* requests insert
  their written KV into the cache before freeing, so a preempted request
  resumes from cached pages instead of re-prefilling. ``cache_tokens(req,
  finished)`` is the engine-provided token-sequence oracle (the batcher
  itself never sees token ids).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.allocator import PageAllocator
from repro_torch.runtime.faults import NULL_FAULTS


@dataclass
class Request:
    req_id: int
    prompt_len: int
    max_new_tokens: int
    arrived_at: int = 0
    generated: int = 0
    # chunked_prefill: this request prefills in chunks (DCS-style
    # interleave); prefill_done is False while chunks are still streaming —
    # the slot is occupied but excluded from decode.
    chunked_prefill: bool = False
    prefill_done: bool = True
    # cached_len: tokens of KV borrowed from the prefix cache at admission;
    # prefill starts at this depth (0 = cold).
    cached_len: int = 0
    # kv_written: the prompt's KV pages actually hold computed values (set
    # by the prefillers once the prompt is through the model) — guards the
    # cache-insert paths against adopting never-written pages when a request
    # is admitted and preempted in the same tick.
    kv_written: bool = False
    # SLO scheduling surface (PR 10): priority tier (higher = more urgent),
    # submission timestamp in the engine's clock frame, and the immutable
    # client-facing submission spec (serving.Request) policies and the
    # tracker read SLO targets from. The scheduler itself only sorts on
    # these; it never mutates the spec.
    priority: int = 0
    submit_t: float = 0.0
    spec: object = None

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.generated


@dataclass
class SchedulerStats:
    steps: int = 0
    occupied_slot_steps: int = 0
    completed: int = 0
    admitted: int = 0
    preempted: int = 0
    dedup_deferred: int = 0
    # lifecycle-hardening counters (PR 8): requests torn down before their
    # natural finish (client abort / deadline / quarantine / load shed) and
    # requests drained off a dead serving row into re-queued prefills.
    aborted: int = 0
    migrated: int = 0
    # policy-driven preemptions (SLO tier starvation), a subset of
    # ``preempted`` — pool-exhaustion preemptions are the remainder
    priority_preempted: int = 0
    batch_trace: list = field(default_factory=list)

    @property
    def avg_batch(self) -> float:
        return self.occupied_slot_steps / max(1, self.steps)


class ContinuousBatcher:
    def __init__(self, allocator: PageAllocator, n_slots: int, *,
                 max_context: int, n_rows: int = 1, policy=None,
                 bt_width: int | None = None, cache=None, cache_tokens=None):
        self.alloc = allocator
        self.n_slots = n_slots
        self.max_context = max_context
        self.n_rows = n_rows
        self.policy = policy
        # injectable time source: policies compute queue-waiting times and
        # SLO budgets from this (the engine threads its own clock here, so
        # virtual-time replay is deterministic end to end)
        self.clock = time.perf_counter
        # prefix cache + token oracle (see module docstring)
        self.cache = cache
        self.cache_tokens = cache_tokens
        # same-tick prefix dedup (see _dedup_defer); engines may disable
        self.dedup = True
        # telemetry events hook: an object with ``on_admit(req, slot)`` /
        # ``on_preempt(req, slot)`` / ``on_finish(req, slot)`` called at the
        # exact bookkeeping points (repro.telemetry.RequestTracker). None
        # (the default) costs one identity check per event — disabled
        # telemetry adds no work and no allocation here.
        self.events = None
        # recurrent-state hook: ``rstate_hook(req, slot, finished)`` fires
        # when a slot's pages are about to be released — preemption
        # (finished=False: the engine snapshots the recurrent carry + the
        # written KV pages so re-admission restores instead of recomputing,
        # mirroring the kvcache swap story) and completion (finished=True:
        # the engine drops any stored snapshot).
        self.rstate_hook = None
        # fault injection (repro.runtime.faults): the engine threads its
        # injector here so the scheduler can model allocator exhaustion
        # deterministically. NULL_FAULTS is the shared disabled no-op —
        # one bool attribute check per growth step.
        self.faults = NULL_FAULTS
        # per-tick memo of (tokens, dev_pages, host_pages) per queued
        # candidate: can_admit's capacity estimate and the dedup check
        # share one token materialization + tree walk. ``prefetch_peeks``
        # lets the fused engine warm it in the overlap window (radix walks
        # run while the device computes); _peeks_fresh keeps step() from
        # discarding a prefetched memo.
        self._peek_memo: dict[int, tuple] = {}
        self._peeks_fresh = False
        self.slots: list[Request | None] = [None] * n_slots
        self.queue: deque[Request] = deque()
        self.stats = SchedulerStats()
        # host-side snapshots, maintained incrementally (see module docstring)
        self._bt_width = bt_width
        self._bt = (np.full((n_slots, bt_width), -1, np.int32)
                    if bt_width else None)
        self._npages = np.zeros((n_slots,), np.int32)
        self._ctx = np.zeros((n_slots,), np.int32)
        # slots whose snapshot changed since the engine last mirrored them to
        # the device (admission / growth / free / chunk completion). The
        # fused-decode engine consumes this via ``take_dirty`` and patches
        # ONLY these rows of its device-resident slot state — per-tick
        # config-buffer traffic is O(changes), never a full rebuild.
        self.dirty: set[int] = set(range(n_slots))

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _row_of_slot(self, slot: int) -> int:
        return slot * self.n_rows // self.n_slots

    # ---- snapshot maintenance ----------------------------------------
    def _snap_admit(self, s: int, req: Request, pages: list[int]) -> None:
        self._npages[s] = len(pages)
        self._ctx[s] = req.prompt_len if req.prefill_done else 0
        if self._bt is not None:
            self._bt[s, :len(pages)] = pages
        self.dirty.add(s)

    def _snap_grow(self, s: int, new: list[int]) -> None:
        if new:
            n = int(self._npages[s])
            self._npages[s] = n + len(new)
            if self._bt is not None:
                self._bt[s, n:n + len(new)] = new
            self.dirty.add(s)

    def _snap_clear(self, s: int) -> None:
        self._npages[s] = 0
        self._ctx[s] = 0
        if self._bt is not None:
            self._bt[s, :] = -1
        self.dirty.add(s)

    def take_dirty(self) -> list[int]:
        """Slots whose snapshot changed since the last call (sorted); clears
        the set. The engine patches exactly these rows of its device-resident
        block-table/ctx/token/budget arrays before dispatching a horizon."""
        out = sorted(self.dirty)
        self.dirty.clear()
        return out

    def _preempt(self, s: int, req: Request) -> None:
        """Pool exhausted mid-decode: free pages, requeue at the front for
        re-prefill of the reconstructable context — the lazy-allocation
        analogue of vLLM preemption.

        The reconstructable context is prompt + *written* generated tokens:
        when anything was generated, the last sampled token's KV was never
        written (it re-enters as the next decode input after re-prefill),
        and ``generated`` was already incremented this tick for a token
        never sampled — hence total_len - 1, not total_len. The remaining
        budget keeps the request's total emission where it would have been
        without preemption (``- generated + 1``: a fresh incarnation emits
        max_new + 1 tokens — prefill emits the first — while a resumed one
        emits exactly max_new, one per decode tick).

        With a prefix cache the written context is *inserted* before the
        pages are released: the tree keeps them alive (or offloads them to
        the host tier under pressure), so the re-admission's lookup resumes
        from cache instead of re-prefilling — the swap-in-on-resume path.
        For recurrent/enc-dec families the ``rstate_hook`` plays the same
        role for the dense carry (and its written KV pages): snapshot
        before release so resume = restore, not recompute."""
        if self.rstate_hook is not None:
            self.rstate_hook(req, s, False)
        if req.generated:
            req.prompt_len = req.total_len - 1
            req.max_new_tokens = max(1, req.max_new_tokens
                                     - req.generated + 1)
        req.generated = 0
        req.prefill_done = not req.chunked_prefill
        req.cached_len = 0
        self._release_pages(req, finished=False)
        self.queue.appendleft(req)
        self.slots[s] = None
        self._snap_clear(s)
        self.stats.preempted += 1
        if self.events is not None:
            self.events.on_preempt(req, s)

    def _release_pages(self, req: Request, *, finished: bool) -> None:
        """Free a request's pages; with a prefix cache, first record its
        written KV under the radix tree (the tree's references keep shared
        pages alive) and unpin its matched path."""
        if self.cache is not None:
            if req.kv_written:
                self.cache.insert(req.req_id,
                                  self.cache_tokens(req, finished))
            self.cache.release(req.req_id)
        self.alloc.free(req.req_id)

    def mark_prefill_done(self, s: int) -> bool:
        """Chunked prefill finished for slot ``s``: the request joins the
        decode batch with its first generated token counted (the engine sets
        ``generated=1`` before calling). Allocates the growth page the seed's
        admission-tick ``ensure`` would have grabbed; returns False (and
        preempts) if the pool is exhausted."""
        req = self.slots[s]
        req.prefill_done = True
        if req.total_len <= self.max_context:
            try:
                self._snap_grow(s, self.alloc.ensure(req.req_id,
                                                     req.total_len))
            except MemoryError:
                # the first token was sampled but never written/emitted:
                # requeue the bare prompt, not prompt+1
                req.generated = 0
                self._preempt(s, req)
                return False
        self._ctx[s] = req.total_len
        self.dirty.add(s)
        return True

    # ---- lifecycle hardening (PR 8) ----------------------------------
    def abort_slot(self, s: int, reason: str = "abort") -> Request:
        """Tear down a RUNNING request without a finish: its output is
        abandoned, so its written KV is NOT inserted into the prefix cache
        (already-shared prefix pages survive through the tree's own refs).
        Releases radix pins + pending swap ops (``cache.release`` →
        ``ops.cancel``) and frees the pages. Must only be called at a
        quiescent point — no decode horizon in flight over this slot's
        pages (the engine's ``_process_faults`` safe point)."""
        req = self.slots[s]
        if self.rstate_hook is not None:
            self.rstate_hook(req, s, True)   # drop any carry snapshot
        if self.cache is not None:
            self.cache.release(req.req_id)
        self.alloc.free(req.req_id)
        self.slots[s] = None
        self._snap_clear(s)
        self.stats.aborted += 1
        ev = getattr(self.events, "on_abort", None)
        if ev is not None:
            ev(req, s, reason)
        return req

    def abort_queued(self, req: Request, reason: str = "abort") -> None:
        """Drop a request still in the waiting queue. Queued requests hold
        no allocator or cache state (lookup/commit happen at admission, and
        preemption released everything before requeueing), so this is pure
        bookkeeping."""
        self.queue.remove(req)
        self._peek_memo.pop(req.req_id, None)
        self.stats.aborted += 1
        ev = getattr(self.events, "on_abort", None)
        if ev is not None:
            ev(req, -1, reason)

    def drain_slot(self, s: int) -> Request:
        """A serving row died under this slot: its written KV is garbage,
        so the request re-queues for a full re-prefill of the
        reconstructable context and the pages are freed WITHOUT a cache
        insert. Called at the engine's post-collect quiescent point, where
        ``generated`` counts only really-emitted tokens — so the written
        context is exactly ``total_len`` tokens (prompt + every consumed
        decode input; the newest sample re-enters as the first decode input
        after re-prefill) and the remaining budget is ``max_new -
        generated`` (unlike ``_preempt``'s mid-tick ``- generated + 1``
        frame, where ``generated`` was pre-incremented for an unsampled
        token)."""
        req = self.slots[s]
        if self.rstate_hook is not None:
            self.rstate_hook(req, s, True)   # carry snapshot is lost too
        if req.generated:
            req.prompt_len = req.total_len
            req.max_new_tokens = max(1, req.max_new_tokens - req.generated)
        req.generated = 0
        req.prefill_done = not req.chunked_prefill
        req.cached_len = 0
        req.kv_written = False
        if self.cache is not None:
            self.cache.release(req.req_id)
        self.alloc.free(req.req_id)
        self.queue.appendleft(req)
        self.slots[s] = None
        self._snap_clear(s)
        self.stats.migrated += 1
        if self.events is not None:
            self.events.on_preempt(req, s)
        return req

    def reserve_horizon(self, active, k: int, *,
                        gentle: bool = False) -> np.ndarray:
        """Best-effort page reservation for a fused ``k``-step decode
        horizon. ``step()`` already covered each active slot's next token;
        this grows the allocation to cover up to ``k`` consecutive tokens
        (clamped by the slot's remaining budget — a finished slot's final
        sample is never written, so ``prompt + max_new`` pages bound every
        horizon — and by ``max_context``, matching the per-token growth
        guard). On pool exhaustion a slot's allowance degrades to whatever
        its pages already cover instead of preempting: the device mask
        pauses it mid-horizon and the next tick resumes it, so reservation
        pressure never changes outputs. ``gentle=True`` additionally
        declines to evict radix-cached pages for SPECULATIVE growth (the
        horizon beyond the committed next token): under sharing-heavy load
        an aggressive k-token reservation would churn the prefix cache
        every tick for tokens that may never be accepted, so the horizon
        degrades first and only committed per-token growth reclaims.
        Returns ``allow`` [n_slots] int32 — decode steps each slot may run
        this horizon (0 = not active)."""
        allow = np.zeros((self.n_slots,), np.int32)
        for s in active:
            req = self.slots[s]
            steps = min(max(1, int(k)),
                        req.max_new_tokens - req.generated + 1)
            want = min(req.total_len + steps - 1, self.max_context)
            if steps > 1 and want > req.total_len:
                try:
                    self._snap_grow(s, self.alloc.ensure(
                        req.req_id, want, reclaim=not gentle))
                except MemoryError:
                    covered = int(self._npages[s]) * self.alloc.page_size
                    steps = max(1, min(steps, covered - req.total_len + 1))
            allow[s] = steps
        return allow

    # ------------------------------------------------------------------
    def _peek_cached(self, req: Request) -> tuple:
        """(tokens, dev_pages, host_pages) for a queued candidate, memoized
        for the current tick (peek is an estimate; within-tick staleness is
        fine and was already inherent to per-call peeks)."""
        ent = self._peek_memo.get(req.req_id)
        if ent is None:
            toks = self.cache_tokens(req, False)
            dev, host = self.cache.peek(toks)
            ent = self._peek_memo[req.req_id] = (toks, dev, host)
        return ent

    def prefetch_peeks(self, limit: int | None = None) -> None:
        """Warm the per-tick peek memo for the first ``limit`` queued
        candidates — the fused engine's overlap window runs these radix
        walks while the previous decode horizon is still computing on
        device. Peeks taken here predate the horizon's finish-inserts, an
        underestimate the memo's estimate semantics already tolerate."""
        if self.cache is None or not self.queue:
            return
        self._peek_memo.clear()
        self._peeks_fresh = True
        for req in list(self.queue)[:limit]:
            self._peek_cached(req)

    def cached_pages(self, req: Request) -> int:
        """Device pages a prefix-cache hit would let this queued request
        borrow instead of allocating (admission-capacity estimate).
        Host-resident matched pages do NOT reduce the need — their swap-in
        consumes a device page apiece."""
        if self.cache is None:
            return 0
        return self._peek_cached(req)[1]

    def _admit_one(self, req: Request, row: int | None) -> list[int] | None:
        """Allocate a request's prompt footprint, borrowing the cached
        prefix when a cache is attached. Returns the page table, or None if
        the pool could not cover it even after reclaim (the request stays
        queued)."""
        if self.cache is None:
            return self.alloc.admit(req.req_id, req.prompt_len, row)
        hit = self.cache.lookup(req.req_id, self.cache_tokens(req, False))
        try:
            pages = self.alloc.admit_shared(req.req_id, hit.pages,
                                            req.prompt_len, row)
        except MemoryError:
            self.cache.release(req.req_id)
            return None
        self.cache.commit(req.req_id, pages)
        req.cached_len = hit.matched
        return pages

    def _inflight_prefill_seqs(self) -> list[np.ndarray]:
        """Token sequences whose KV is being computed right now (admitted
        but not yet published to the prefix cache) — the same-tick dedup
        keys."""
        return [self.cache_tokens(r, False) for r in self.slots
                if r is not None and not r.kv_written]

    def _dedup_defer(self, req: Request, inflight) -> bool:
        """Same-tick prefix dedup: if an in-flight prefill already covers
        more page-aligned prefix of this request than the radix cache
        would, wait one tick — the leader publishes its prefix at prefill
        completion, so the deferred request admits with ``cached_len`` set
        and prefills only the suffix. A cold same-prefix burst then pays
        ONE full prefill instead of one per slot."""
        if self.cache is None or not self.dedup or not inflight:
            return False
        toks, dev, host = self._peek_cached(req)
        page = self.alloc.page_size
        best = 0
        for seq in inflight:
            n = min(len(seq), len(toks))
            if n <= best:
                continue
            eq = np.asarray(seq[:n]) == np.asarray(toks[:n])
            best = max(best, n if eq.all() else int(np.argmax(~eq)))
        if best // page == 0:
            return False
        return best // page > dev + host

    def _try_admit(self) -> list[tuple[int, Request]]:
        """Fill empty slots from the queue. Returns [(slot, request)] newly
        admitted (the engine must run prefill for these). With a policy the
        next request is whatever ``policy.select`` picks; the policy must
        only pick requests that pass ``alloc.can_admit``.

        Dedup-deferred requests are spliced out of the queue for the span
        of the admission pass (one verdict and one counter tick per
        request) and restored afterwards, so selection — FCFS or policy —
        moves on to admissible candidates instead of re-picking a waiting
        request once per free slot."""
        admitted = []
        dedup = self.cache is not None and self.dedup and bool(self.queue)
        inflight = self._inflight_prefill_seqs() if dedup else []
        deferred: list[tuple[int, Request]] = []
        for s in range(self.n_slots):
            if self.slots[s] is not None:
                continue
            row = self._row_of_slot(s) if self.alloc.policy == "row_affine" \
                else None
            while self.queue:
                if self.policy is not None:
                    idx = self.policy.select(self, row)
                    if idx is None:
                        break
                else:                  # seed behavior: strict head-of-line
                    if not self.alloc.can_admit(
                            self.queue[0].prompt_len, row,
                            self.cached_pages(self.queue[0])):
                        break  # head-of-line blocked on memory; next tick
                    idx = 0
                req = self.queue[idx]
                if inflight and self._dedup_defer(req, inflight):
                    self.stats.dedup_deferred += 1
                    deferred.append((idx + len(deferred), req))
                    del self.queue[idx]
                    continue           # re-select a candidate for this slot
                pages = self._admit_one(req, row)
                if pages is None:
                    break              # reclaim couldn't cover it; next tick
                del self.queue[idx]
                req.kv_written = False
                self.slots[s] = req
                self._snap_admit(s, req, pages)
                self.stats.admitted += 1
                admitted.append((s, req))
                if self.events is not None:
                    self.events.on_admit(req, s)
                if dedup:              # later candidates defer vs this leader
                    inflight.append(self.cache_tokens(req, False))
                break
        for i, req in sorted(deferred, key=lambda t: t[0]):
            self.queue.insert(min(i, len(self.queue)), req)
        return admitted

    def step(self, finished_mask: np.ndarray | None = None):
        """One decode tick.

        ``finished_mask`` [n_slots] — which active slots finished on the
        *previous* step (EOS sampled / budget reached). Frees their pages,
        refills slots, lazily grows every active request by one token.
        Slots still in chunked prefill are occupied but not active.
        Returns (admitted, active_slots).
        """
        if self._peeks_fresh:
            self._peeks_fresh = False
        else:
            self._peek_memo.clear()
        if finished_mask is not None:
            for s in np.flatnonzero(finished_mask):
                if self.slots[s] is not None:
                    if self.rstate_hook is not None:
                        self.rstate_hook(self.slots[s], s, True)
                    self._release_pages(self.slots[s], finished=True)
                    self.stats.completed += 1
                    if self.events is not None:
                        self.events.on_finish(self.slots[s], s)
                    self.slots[s] = None
                    self._snap_clear(s)
        admitted = self._try_admit()
        # policy-driven preemption (SLO tier starvation): ask the policy
        # for victim slots once per tick and route them through the SAME
        # mid-tick preempt frame as allocator exhaustion below — identical
        # requeue arithmetic, identical snapshot/restore resume, so a
        # priority preemption is token-identical for the victim
        victims: set = ()
        if self.policy is not None and self.queue:
            pv = getattr(self.policy, "preempt_victims", None)
            if pv is not None:
                victims = pv(self)
        active = []
        for s, req in enumerate(self.slots):
            if req is None or not req.prefill_done:
                continue
            req.generated += 1
            self._ctx[s] = req.total_len
            if s in victims:
                self.stats.priority_preempted += 1
                self._preempt(s, req)
                continue
            # injected pool exhaustion: behave exactly as if ensure() had
            # raised — same preempt path, same requeue arithmetic — so the
            # chaos plan exercises the real recovery machinery
            if self.faults.enabled and self.faults.fire("alloc_exhaust",
                                                        key=req.req_id):
                self._preempt(s, req)
                continue
            if req.total_len <= self.max_context:
                try:
                    self._snap_grow(s, self.alloc.ensure(req.req_id,
                                                         req.total_len))
                except MemoryError:
                    self._preempt(s, req)
                    continue
            active.append(s)
        # a page-aligned request can be admitted and preempted in the SAME
        # tick (its +1 growth page was the last straw) — it is back in the
        # queue, so it must not be prefilled
        admitted = [(s, r) for s, r in admitted if self.slots[s] is r]
        self.stats.steps += 1
        self.stats.occupied_slot_steps += len(active)
        self.stats.batch_trace.append(len(active))
        return admitted, active

    # ------------------------------------------------------------------
    def block_tables(self, width: int) -> np.ndarray:
        """Device block-table snapshot [n_slots, width]. When ``width``
        matches the maintained snapshot this is O(1) (the live array —
        treat as read-only); otherwise falls back to rebuilding."""
        if self._bt is not None and width == self._bt_width:
            return self._bt
        out = np.full((self.n_slots, width), -1, np.int32)
        for s, req in enumerate(self.slots):
            if req is not None:
                out[s] = self.alloc.block_table(req.req_id, width)
        return out

    def block_table_row(self, slot: int) -> np.ndarray:
        """One request's Va2Pa row (read-only view of the snapshot)."""
        if self._bt is not None:
            return self._bt[slot]
        return self.alloc.block_table(self.slots[slot].req_id,
                                      self._bt_width or 1)

    def context_lens(self) -> np.ndarray:
        return self._ctx.copy()

    def max_live_pages(self) -> int:
        """High-water mark of per-slot allocated pages — the live width the
        engine's decode-table bucketing needs."""
        return int(self._npages.max(initial=0))

    def done(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)
