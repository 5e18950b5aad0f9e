"""Elastic scaling & straggler mitigation (host-level planning logic).

A copy of ``repro/runtime/elastic.py`` (framework-free).

At 1000+ nodes, failures are routine; the runtime must (a) keep serving /
training with the survivors and (b) not let one slow node gate the fleet.
This module contains the *planning* logic — pure, unit-tested functions the
launcher consults; actual process orchestration is the cluster manager's job.

Policies (DESIGN.md §4):

* ``plan_remesh`` — shrink the ``data`` axis first (DP rows are stateless
  replicas in serving; in training their optimizer shards re-gather from the
  checkpoint), keep the ``model`` axis intact (TP shards are stateful and
  resharding them mid-flight costs a full weight reshuffle). A pod that
  loses any chip beyond the data-axis slack drops out whole (PP stage
  granularity).
* ``plan_request_migration`` — serving rows own their requests (row-affine
  pages); when a row dies its in-flight requests are re-queued for prefill
  on surviving rows (KV pages are lost — recompute, the standard trade).
* ``StragglerPolicy`` — EMA of per-row step times; rows slower than
  ``factor``x the fleet median get their decode batch share shrunk
  (scheduler admits fewer requests to those rows), the continuous-batching
  equivalent of backup tasks.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class MeshPlan:
    pods: int
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.pods * self.data * self.model


def plan_remesh(current: MeshPlan, failed_devices: list[int]) -> MeshPlan:
    """New mesh after failures. Device ids are row-major (pod, data, model).

    Keeps the model axis; drops whole data rows containing failures; drops a
    pod entirely if fewer than half its rows survive (PP stages need symmetric
    capacity across pods).
    """
    failed = set(failed_devices)
    rows_per_pod = current.data
    surviving_rows = []
    for p in range(current.pods):
        rows = 0
        for d in range(current.data):
            base = (p * current.data + d) * current.model
            if not any(base + m in failed for m in range(current.model)):
                rows += 1
        surviving_rows.append(rows)
    # symmetric row count across surviving pods
    pods = [p for p, r in enumerate(surviving_rows)
            if r >= max(1, rows_per_pod // 2)]
    if not pods:
        raise RuntimeError("no pod has enough surviving rows")
    data = min(surviving_rows[p] for p in pods)
    return MeshPlan(pods=len(pods), data=data, model=current.model)


def plan_request_migration(row_of_request: dict[int, int],
                           dead_rows: set[int]) -> list[int]:
    """Requests to re-queue (their row died; pages lost -> re-prefill)."""
    return sorted(r for r, row in row_of_request.items() if row in dead_rows)


def plan_role_collapse(roles: dict[int, str],
                       healthy: set[int]) -> dict[int, str] | None:
    """Sticky degradation planning for the disaggregated engine cluster
    (``serving/cluster.py``): when either the prefill or the decode role
    has no healthy member left, every surviving engine collapses to the
    colocated ``both`` role — the cluster keeps serving as a (possibly
    single-engine) colocated pool instead of wedging on a missing stage.

    Returns the new role map over the healthy engines, or None when both
    roles are still covered (no change needed). An empty map means nothing
    survived — the cluster must go terminal."""
    def covered(role: str) -> bool:
        return any(ix in healthy and r in (role, "both")
                   for ix, r in roles.items())
    if covered("prefill") and covered("decode"):
        return None
    return {ix: "both" for ix in roles if ix in healthy}


@dataclass
class StragglerPolicy:
    n_rows: int
    factor: float = 1.5       # slower than factor x median => straggler
    alpha: float = 0.2        # EMA coefficient
    min_share: float = 0.25   # never shrink a row below this batch share
    ema: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.ema is None:
            self.ema = np.zeros(self.n_rows)

    def observe(self, row_step_times: np.ndarray) -> None:
        t = np.asarray(row_step_times, np.float64)
        self.ema = np.where(self.ema == 0, t,
                            (1 - self.alpha) * self.ema + self.alpha * t)

    def shares(self) -> np.ndarray:
        """Per-row decode batch share in (min_share, 1]."""
        if not self.ema.any():
            return np.ones(self.n_rows)
        med = np.median(self.ema[self.ema > 0])
        ratio = np.where(self.ema > 0, self.ema / max(med, 1e-9), 1.0)
        share = np.clip(self.factor / np.maximum(ratio, self.factor),
                        self.min_share, 1.0)
        return share

    def stragglers(self) -> list[int]:
        med = np.median(self.ema[self.ema > 0]) if self.ema.any() else 0
        return [i for i, t in enumerate(self.ema)
                if med and t > self.factor * med]
