"""The public request-submission spec (``serving.Request``).

PRs 1-9 accreted kwargs onto ``Engine.submit(req_id, prompt,
max_new_tokens, deadline_s=...)``; the SLO layer needs several more
(priority tier, TTFT/TPOT targets, tenant + shared-prefix group), so
submission is now one spec object. ``engine.submit()`` and
``cluster.submit()`` accept it; scheduling policies and the request
tracker read from it (the scheduler's internal ``core.scheduler.Request``
carries a ``spec`` back-reference). The old positional signature survives
as a thin deprecated shim — exercised only by the back-compat test.

The spec is the *immutable submission record*: the scheduler mutates its
own bookkeeping fields (``prompt_len`` shrinks budget arithmetic across
preemptions) but never the spec, so SLO accounting always sees what the
client asked for.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class Request:
    """One client request.

    SLO semantics (all optional, seconds in the engine's clock frame):

    * ``deadline_s``   — hard wall budget from submit; the engine tears the
      request down (reason ``deadline``) when it expires, wherever it is in
      its lifecycle.
    * ``ttft_slo_s``   — target submit -> first token. A finished request
      over this target counts as an SLO miss for goodput.
    * ``tpot_slo_s``   — target mean inter-token time after the first.
    * ``priority``     — scheduling tier, higher = more urgent. The SLO
      policy admits strictly by tier and may preempt a lower-tier running
      request for a starved higher-tier one.
    * ``tenant`` / ``prefix_group`` — workload identity: which traffic
      class this request belongs to and which shared-prefix family its
      prompt was drawn from (the workload generator keys shared prompt
      prefixes on ``prefix_group``; the radix cache does the actual
      sharing by token content).
    """
    req_id: int
    prompt: Any                          # token ids (array-like of int)
    max_new_tokens: int
    deadline_s: float | None = None
    priority: int = 0
    ttft_slo_s: float | None = None
    tpot_slo_s: float | None = None
    tenant: str | None = None
    prefix_group: int | None = None
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        self.req_id = int(self.req_id)
        self.max_new_tokens = int(self.max_new_tokens)
