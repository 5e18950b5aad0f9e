"""Pluggable admission/scheduling policies for the continuous batcher.

The seed batcher hard-coded a strict head-of-line FCFS scan; the paper's
host loop (Fig. 2) co-designs scheduling with the DPA allocator, so the
policy is a plug-in point on ``core.scheduler.ContinuousBatcher``.

Contract: ``select(batcher, row)`` is called once per open slot and returns
the index into ``batcher.queue`` of the request to admit, or None to leave
the slot empty this tick. A policy must only return requests that pass
``batcher.alloc.can_admit`` — the batcher admits whatever the policy picks.

A policy may additionally implement ``preempt_victims(batcher) -> set``:
the scheduler calls it once per tick (at the same mid-tick frame where
allocator exhaustion preempts) and routes every returned slot through the
existing ``_preempt`` snapshot/restore path — preemption is restore, not
recompute, so a preempted request's output is token-identical on resume.

Policies register by name (``@register_policy``) with a per-policy config
dataclass; ``make_policy`` resolves a name, a config instance, or a
ready-made policy object. ``launch/serve.py --sched-policy`` keys into the
same registry, so new policies plug in without touching engine code.

SLO fields (priority tier, TTFT target, deadline) are read from the
request's immutable submission spec (``serving.Request``, attached to the
scheduler request as ``req.spec``); timestamps come from ``batcher.clock``
so the SLO/EDF policies are deterministic under a virtual clock.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

from repro_torch.core import pim_model as PM

#: name -> policy class; populated by @register_policy
POLICIES: dict[str, type] = {}
#: per-policy config dataclass -> policy class (make_policy accepts either)
_CONFIGS: dict[type, type] = {}


def register_policy(name: str):
    """Class decorator: register a SchedulingPolicy subclass under ``name``
    (and its ``Config`` dataclass, when it defines its own)."""
    def deco(cls):
        cls.name = name
        POLICIES[name] = cls
        cfg_t = cls.__dict__.get("Config")
        if cfg_t is not None:
            _CONFIGS[cfg_t] = cls
        return cls
    return deco


def available_policies() -> tuple[str, ...]:
    return tuple(sorted(POLICIES))


class SchedulingPolicy:
    name = "base"

    @dataclass
    class Config:
        pass

    def __init__(self, cfg=None, **kw):
        if cfg is None:
            cfg = self.Config(**kw)
        elif kw:
            raise TypeError(f"{type(self).__name__}: pass a Config or "
                            f"kwargs, not both: {sorted(kw)}")
        self.cfg = cfg

    def select(self, batcher, row: int | None = None) -> int | None:
        raise NotImplementedError

    def _admissible(self, batcher, row):
        for i, req in enumerate(batcher.queue):
            if batcher.alloc.can_admit(req.prompt_len, row,
                                       batcher.cached_pages(req)):
                yield i, req


def _spec(req):
    return getattr(req, "spec", None)


def _effective_deadline(req) -> float:
    """Absolute urgency deadline of a queued request: the earlier of its
    hard deadline and its TTFT target (both anchored at submit). +inf when
    neither is set, so unconstrained requests sort last under EDF."""
    spec = _spec(req)
    dl = math.inf
    if spec is not None:
        if spec.deadline_s:
            dl = req.submit_t + spec.deadline_s
        if spec.ttft_slo_s:
            dl = min(dl, req.submit_t + spec.ttft_slo_s)
    return dl


@register_policy("fcfs")
class FCFSPolicy(SchedulingPolicy):
    """First-come-first-served with strict head-of-line blocking (the seed
    behavior): if the oldest request doesn't fit, nothing is admitted."""

    def select(self, batcher, row=None):
        q = batcher.queue
        if q and batcher.alloc.can_admit(q[0].prompt_len, row,
                                         batcher.cached_pages(q[0])):
            return 0
        return None


@register_policy("sjf")
class SJFPolicy(SchedulingPolicy):
    """Shortest-job-first: admit the admissible request with the smallest
    expected footprint. ``by='prompt'`` ranks on prompt length alone,
    ``by='total'`` on prompt + token budget (expected lifetime). Ties break
    FCFS (earlier arrival wins)."""

    @dataclass
    class Config:
        by: str = "total"

    def __init__(self, cfg=None, **kw):
        super().__init__(cfg, **kw)
        assert self.cfg.by in ("prompt", "total"), self.cfg.by
        self.by = self.cfg.by

    def _size(self, req) -> int:
        return req.prompt_len if self.by == "prompt" \
            else req.prompt_len + req.max_new_tokens

    def select(self, batcher, row=None):
        best, best_size = None, math.inf
        for i, req in self._admissible(batcher, row):
            if self._size(req) < best_size:
                best, best_size = i, self._size(req)
        return best


@register_policy("edf")
class EDFPolicy(SchedulingPolicy):
    """Earliest-deadline-first: among admissible queued requests, admit the
    one whose effective deadline (hard ``deadline_s`` or TTFT target,
    whichever is earlier) is soonest. Requests with no deadline sort last;
    ties break FCFS. Classic EDF — optimal for meeting deadlines when the
    system is feasible, no notion of priority tiers (see SLOPolicy)."""

    def select(self, batcher, row=None):
        best, best_key = None, None
        for i, req in self._admissible(batcher, row):
            key = (_effective_deadline(req), req.submit_t, i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best


@register_policy("slo")
class SLOPolicy(SchedulingPolicy):
    """SLO-aware tiered scheduling: admission ranks by priority tier first
    (higher tier always beats lower), then EDF within a tier, and lower
    tiers backfill when no higher-tier candidate fits.

    Preemption: when the most urgent queued request (a) outranks a running
    one, (b) has burned ``starve_frac`` of its TTFT budget waiting, and
    (c) still cannot be admitted, the policy names a victim slot for the
    scheduler's snapshot/restore preemption path. Victims are lower-tier
    running requests; among them, one that is already *over budget*
    (elapsed time exceeds its own TTFT + generated x TPOT allowance — it
    cannot contribute goodput by continuing) is taken first, then the
    lowest tier, then the highest slot index. At most
    ``max_preempts_per_tick`` victims per tick bounds thrash; the
    preempted request re-queues at the front and resumes from its cached
    KV / recurrent-carry snapshot (restore, not recompute)."""

    @dataclass
    class Config:
        preempt: bool = True
        # preempt for a waiter once it has burned this fraction of its
        # TTFT budget in the queue (patience_s when it has no target)
        starve_frac: float = 0.5
        patience_s: float = 0.25
        max_preempts_per_tick: int = 1

    def _key(self, req, i):
        return (-getattr(req, "priority", 0), _effective_deadline(req),
                req.submit_t, i)

    def select(self, batcher, row=None):
        order = sorted((self._key(req, i), i, req)
                       for i, req in enumerate(batcher.queue))
        for _, i, req in order:
            if batcher.alloc.can_admit(req.prompt_len, row,
                                       batcher.cached_pages(req)):
                return i
        return None

    # ---- tick-level preemption hook ----------------------------------
    def _ttft_budget(self, req) -> float:
        spec = _spec(req)
        if spec is not None and spec.ttft_slo_s:
            return spec.ttft_slo_s
        return self.cfg.patience_s

    def _over_budget(self, req, now: float) -> bool:
        """A running request has blown its own SLO allowance so far:
        elapsed > TTFT target + generated tokens x TPOT target (or its
        hard deadline has passed). False when it has no targets."""
        spec = _spec(req)
        if spec is None:
            return False
        elapsed = now - req.submit_t
        if spec.deadline_s and elapsed > spec.deadline_s:
            return True
        if spec.ttft_slo_s and spec.tpot_slo_s:
            return elapsed > (spec.ttft_slo_s
                              + spec.tpot_slo_s * max(0, req.generated - 1))
        return False

    def preempt_victims(self, batcher) -> set[int]:
        if not self.cfg.preempt or not batcher.queue:
            return set()
        now = batcher.clock()
        # the most urgent starved waiter the batcher cannot place. The
        # hook runs right after admission, so anyone still queued is
        # blocked on slots or pages; only a waiter that BOTH has a free
        # slot and fits the page pool is skipped (transiently unplaced).
        free_slot = any(r is None for r in batcher.slots)
        waiter = None
        for i, req in enumerate(batcher.queue):
            waited = now - req.submit_t
            if waited < self.cfg.starve_frac * self._ttft_budget(req):
                continue
            if free_slot and batcher.alloc.can_admit(
                    req.prompt_len, None, batcher.cached_pages(req)):
                continue               # admissible on its own: no victim
            key = self._key(req, i)
            if waiter is None or key < waiter[0]:
                waiter = (key, req)
        if waiter is None:
            return set()
        wreq = waiter[1]
        wprio = getattr(wreq, "priority", 0)
        victims = []
        for s, r in enumerate(batcher.slots):
            if r is None or not r.prefill_done or r.generated <= 0:
                continue               # mid-prefill / just admitted: skip
            if getattr(r, "priority", 0) >= wprio:
                continue               # never preempt within/above the tier
            victims.append((0 if self._over_budget(r, now) else 1,
                            getattr(r, "priority", 0), -s))
        victims.sort()
        return {-v[2] for v in victims[:self.cfg.max_preempts_per_tick]}


@register_policy("memory_aware")
class MemoryAwarePolicy(SchedulingPolicy):
    """Admission control against request *lifetime* footprint, ranked by the
    analytic decode cost model (``core.pim_model.decode_latency``).

    A request is admissible only if pages for prompt + max_new_tokens fit
    the free pool with ``headroom_pages`` spare — unlike FCFS, which admits
    on prompt footprint alone and pays for it with mid-decode preemptions
    (the re-prefill the paper's DPA is designed to amortize away). Among
    admissible candidates the policy picks the one the cost model says
    yields the lowest per-token decode latency at the resulting batch.

    With a prefix cache attached the capacity side counts reclaimable cached
    pages (``alloc.available_pages``) and a candidate's need shrinks by its
    matched prefix — shared and host-offloaded KV are admission capacity.
    The price of the host-resident part, one swap-in over the host link, is
    added to the candidate's modelled cost (``pim_model.swap_latency``) so a
    swap-heavy hit only wins when it beats the prefill it replaces.

    When the system is idle and no candidate passes the lifetime check, the
    policy degrades to FCFS admission so a single oversized request cannot
    livelock the queue (it will run under preemption, as the seed did).
    """

    @dataclass
    class Config:
        system: Any = None
        model: Any = None
        headroom_pages: int = 0

    def __init__(self, cfg=None, **kw):
        super().__init__(cfg, **kw)
        self.system = self.cfg.system or PM.System(
            PM.PIM_NODE, n_nodes=1, itpp=True, dpa=True, pingpong=True)
        self.model = self.cfg.model or PM.QWEN_7B
        self.headroom = self.cfg.headroom_pages

    def _lifetime_pages(self, alloc, req) -> int:
        return -(-(req.prompt_len + req.max_new_tokens) // alloc.page_size)

    def _cached(self, batcher, req) -> tuple[int, int]:
        """(device, host) pages the prefix cache would cover."""
        if batcher.cache is None:
            return 0, 0
        return batcher.cache.peek(batcher.cache_tokens(req, False))

    def _cost(self, batcher, req, host_pages: int = 0) -> float:
        """Modelled seconds/token if ``req`` joins the current batch, plus
        the amortized swap-in of its host-resident prefix."""
        ctxs = [r.total_len for r in batcher.slots if r is not None]
        B = len(ctxs) + 1
        avg = (sum(ctxs) + req.prompt_len + req.max_new_tokens) / B
        cost = PM.decode_latency(self.system, self.model, B,
                                 max(avg, 1.0))["t_step"] / B
        if host_pages:
            swap = PM.swap_latency(self.model,
                                   host_pages * batcher.alloc.page_size)
            cost += swap / max(1, req.max_new_tokens)
        return cost

    def select(self, batcher, row=None):
        alloc = batcher.alloc
        free = alloc.available_pages(row if alloc.policy == "row_affine"
                                     else None)
        best, best_cost = None, math.inf
        fallback = None
        for i, req in self._admissible(batcher, row):
            if fallback is None:
                fallback = i
            dev, host = self._cached(batcher, req)
            # host-resident matched pages don't reduce the device need
            # (swap-in consumes a device page apiece) — they only shift
            # cost from prefill compute to the host link
            need = self._lifetime_pages(alloc, req) - dev
            if need + self.headroom > free:
                continue                    # would preempt mid-decode: refuse
            cost = self._cost(batcher, req, host)
            if cost < best_cost:
                best, best_cost = i, cost
        if best is None and fallback is not None \
                and all(r is None for r in batcher.slots):
            return fallback                 # idle system: degrade to FCFS
        return best


def route_least_loaded(loads: dict[int, float]) -> int | None:
    """Router-side engine pick for the cluster (``serving/cluster.py``):
    the candidate with the least outstanding work, ties broken toward the
    lowest engine index so routing is deterministic across replays."""
    if not loads:
        return None
    return min(loads, key=lambda ix: (loads[ix], ix))


def make_policy(name, **kw) -> SchedulingPolicy:
    """Resolve a policy: a registered name ('fcfs' | 'sjf' | 'edf' | 'slo'
    | 'memory_aware', plus kwargs for its Config), a per-policy Config
    instance, or a ready SchedulingPolicy passed through."""
    if isinstance(name, SchedulingPolicy):
        return name
    if type(name) in _CONFIGS:
        return _CONFIGS[type(name)](name)
    try:
        cls = POLICIES[name]
    except (KeyError, TypeError):
        raise KeyError(f"unknown policy {name!r}; registered: "
                       f"{', '.join(available_policies())}") from None
    return cls(**kw)
