"""Chaos soak: the port's serving engine under a seeded fault storm.

    python -m repro_torch.launch.chaos_soak --device cpu --json chaos.json

The single-engine scenarios of ``benchmarks/chaos_soak.py`` on
``repro_torch``'s engine (by default the reference's: reduced llama3.2-1b,
fp32, random weights from seed 0, the draft's from seed 7, 4 slots, 4-token
pages): mixed fault storms, prefix-cache / host-tier swap failures, client
aborts and deadlines, serving-row deaths, speculative decoding under
allocation pressure, and a kill + restore over the crash-consistent
snapshots; beyond the reference, ``swap_drop`` drives swap-ins that fail
until the host tier is dropped. ``ChaosSoak`` also takes another model,
weights and geometry (``chip_smoke.py`` runs full-width llama3.2-1b at
16-token pages): prompt lengths, new tokens and the context scale with the
page size, so each scenario keeps its page counts. Each enforces the
reference's invariants:

* every request reaches a terminal state (completed, or aborted with a
  recorded reason);
* no leak at drain: every page free or held by the prefix cache's tree, no
  carry snapshot, draft coverage, deadline or pending abort left;
* row deaths, spec degradation, refused swap-ins and kill + restore leave
  the greedy outputs of the clean run unchanged (exactly, or by the
  caller's ``same`` rule);
* a wall-clock watchdog per scenario.

Every injection is replayable from the scenario's seed
(``runtime.faults``); ``--json PATH`` writes the per-scenario stats with
the fired-event logs in the reference's shape, plus each engine's graph
captures and their ``(width, K, spec)`` keys (a degradation's new horizon
kinds capture their own graphs on a card). The engines run on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import model as MDL
from repro_torch.runtime.faults import FaultConfig
from repro_torch.serving import DecodeEngine, EngineConfig
from repro_torch.serving import Request as Req

WATCHDOG_S = 240.0          # per-scenario wall budget


def _exactly(what: str, prompts: dict, ref: dict, outs: dict) -> None:
    assert outs == ref, f"{what} changed greedy outputs"


class ChaosSoak:
    """The scenarios over one set of weights on one device. ``cfg`` /
    ``draft_cfg`` and their weights default to the reference's;
    ``engine_kw`` (e.g. ``n_slots``, ``decode_horizon``) goes into every
    engine's config. Every engine a scenario makes is kept in ``engines``
    (the caller clears it), so a driver can read their counters."""

    def __init__(self, device=None, *, cfg=None, params=None,
                 draft_cfg=None, draft_params=None, page_size: int = 4,
                 same=None, **engine_kw):
        self.device = device
        # same(what, prompts, ref, outs): after ``what``, the greedy
        # outputs ``outs`` must be the clean run's ``ref`` (default:
        # exactly); ``prompts`` by request id
        self.same = same or _exactly
        self.cfg = cfg or replace(reduced(get_config("llama3.2-1b")),
                                  dtype="float32")
        self.dcfg = draft_cfg or replace(
            reduced(get_config("llama3.2-1b"), layers=1), dtype="float32")
        self.params = params if params is not None else MDL.init_params(
            self.cfg, 0, torch.float32, device)
        self.draft_params = draft_params if draft_params is not None else \
            MDL.init_params(self.dcfg, 7, torch.float32, device)
        # tokens per 4-token page of the reference's geometry
        self.scale = page_size // 4
        self.geo = {**dict(n_slots=4, page_size=page_size, n_pages=128,
                           max_context=64 * self.scale, eos_token=-1),
                    **engine_kw}
        self.engines: list[DecodeEngine] = []

    def engine(self, faults=None, **kw) -> DecodeEngine:
        ecfg = EngineConfig(faults=faults, **{
            "prefill_mode": "batched", **self.geo, **kw})
        self.engines.append(DecodeEngine(self.cfg, ecfg, self.params,
                                         device=self.device))
        return self.engines[-1]

    def spec_engine(self, faults=None, **kw) -> DecodeEngine:
        ecfg = EngineConfig(draft_config=self.dcfg, spec_horizon=3,
                            faults=faults, **{**self.geo, **kw})
        self.engines.append(DecodeEngine(
            self.cfg, ecfg, self.params, device=self.device,
            draft_params=self.draft_params))
        return self.engines[-1]

    def tokens(self, rng, n: int) -> np.ndarray:
        """``n`` reference tokens' worth of random prompt ids."""
        return rng.integers(0, self.cfg.vocab_size, size=n * self.scale)

    def submit(self, eng, n, max_new, seed=0) -> None:
        """``n`` random prompts of 4-19 reference tokens, each asking for
        ``max_new`` reference tokens."""
        rng = np.random.default_rng(seed)
        for r in range(n):
            eng.submit(Req(r, self.tokens(rng, int(rng.integers(4, 20))),
                           max_new * self.scale))

    @staticmethod
    def drained(eng, n_submitted: int, name: str) -> dict:
        """The soak's contract: all terminal, zero leaks."""
        done = eng.batcher.stats.completed
        aborted = len(eng.aborted)
        assert done + aborted == n_submitted, \
            f"{name}: {done} done + {aborted} aborted != {n_submitted}"
        assert eng.batcher.done(), f"{name}: engine not drained"
        retained = (eng.cache.tree.device_pages()
                    if eng.cache is not None else 0)
        assert eng.alloc.pages_in_use == retained, \
            f"{name}: leaked {eng.alloc.pages_in_use - retained} pages"
        assert not eng.rsnaps, f"{name}: dangling carry snapshots"
        assert not eng.deadline_t, f"{name}: dangling deadlines"
        assert not eng._abort_req, f"{name}: unprocessed aborts"
        return {"scenario": name, "submitted": n_submitted,
                "completed": done, "aborted": aborted,
                "abort_counts": dict(eng.abort_counts),
                "faults_fired": eng.faults.total_fired,
                "fault_counts": dict(eng.faults.counts),
                "degraded_mode": eng.degraded_mode,
                "migrated": eng.batcher.stats.migrated,
                "preempted": eng.batcher.stats.preempted,
                "events": list(eng.faults.events),
                "graph_captures": eng.timing.graph_captures,
                # (width, K, spec) of each captured graph: a speculative
                # engine whose ladder turns spec off adds plain horizons
                "graph_keys": sorted(map(list, eng.horizons.captured))}

    @staticmethod
    def outputs(eng) -> dict:
        return {k: list(v) for k, v in eng.outputs.items()}

    # ---- scenarios: (stats, outputs) ---------------------------------
    def mixed_storm(self, seed: int):
        """Everything at once on the plain fused engine: exhaustion
        preempts, row deaths, NaN quarantines, client hangups, stragglers."""
        fc = FaultConfig(seed=seed, alloc_exhaust_p=0.05, row_death_p=0.02,
                         nan_logits_p=0.02, client_abort_p=0.01,
                         slow_tick_p=0.05, slow_tick_s=0.0)
        eng = self.engine(fc, n_rows=2, n_shards=2, degrade_after=3,
                          default_deadline_s=30.0)
        self.submit(eng, 10, 10, seed=seed)
        eng.run(5000)
        return self.drained(eng, 10, f"mixed_storm[{seed}]"), \
            self.outputs(eng)

    def swap_faults(self, seed: int):
        """Prefix cache + host tier under swap failures and stalls: the
        retry budget absorbs the first failures, repeated refusals drop the
        tier, and the run drains with the tree's pages accounted."""
        fc = FaultConfig(seed=seed, swap_fail_p=0.3, swap_stall_p=0.1)
        eng = self.engine(fc, n_pages=48, prefix_cache=True, host_pages=32,
                          offload_high=0.5, offload_low=0.3, degrade_after=2)
        rng = np.random.default_rng(seed)
        shared = self.tokens(rng, 12)
        for r in range(12):
            eng.submit(Req(r, np.concatenate(
                [shared, self.tokens(rng, 6)]), 8 * self.scale))
        eng.run(5000)
        stats = self.drained(eng, 12, f"swap_faults[{seed}]")
        sd = eng.cache.stats_dict()
        stats["swap_in_fails"] = eng.cache.stats.swap_in_fails
        stats["swap_retries"] = sd.get("swap_retries", 0)
        fired = eng.faults.counts.get("swap_fail", 0)
        if fired:
            assert stats["swap_retries"] >= 1, "no swap retries recorded"
            assert stats["swap_retries"] + stats["swap_in_fails"] >= fired
        if eng.degraded_mode & 4:
            assert eng.cache.host is None, "host tier degraded but wired"
            assert "swap_retries" in sd, "tier stats lost on degradation"
        return stats, self.outputs(eng)

    def _waves(self, eng, seed: int, abort: bool = False) -> int:
        """Nine waves of four requests, one of three shared prefixes each,
        four ticks apart: a prefix comes back after two others have pushed
        its pages to the host tier. ``abort``: each wave's first request is
        aborted one tick after its submission (admitted, its swap-ins and
        prefill just queued). Returns the requests submitted."""
        rng = np.random.default_rng(seed)
        shared = [self.tokens(rng, 12) for _ in range(3)]
        for wave in range(9):
            for r in range(4 * wave, 4 * wave + 4):
                eng.submit(Req(r, np.concatenate(
                    [shared[wave % 3], self.tokens(rng, 6)]),
                    8 * self.scale))
            for t in range(4):
                eng.tick()
                if abort and t == 0:
                    eng.abort(4 * wave)
        return 36

    def swap_drop(self, seed: int):
        """Beyond the reference's scenarios: swap-ins refused past a
        one-retry budget drop the host tier mid-run, with client aborts
        tearing requests down while their copies are queued. Survivors'
        greedy outputs equal a clean run's without the cache (a refused
        swap-in costs recompute; a stale or raced copy would show)."""
        clean = self.engine()
        n = self._waves(clean, seed)
        ref = self.outputs_of(clean)
        eng = self.engine(FaultConfig(seed=seed, swap_fail_p=0.9),
                          n_pages=48, prefix_cache=True, host_pages=32,
                          offload_high=0.5, offload_low=0.3, degrade_after=1,
                          swap_retry_limit=1, swap_backoff_cap=1)
        self._waves(eng, seed, abort=True)
        outs = self.outputs_of(eng)
        stats = self.drained(eng, n, f"swap_drop[{seed}]")
        tier = eng.cache.stats_dict()
        stats.update(swap_in_fails=eng.cache.stats.swap_in_fails,
                     swap_retries=tier.get("swap_retries", 0),
                     swapped_in_pages=tier.get("swapped_in_pages", 0),
                     swapped_out_pages=tier.get("swapped_out_pages", 0))
        assert stats["swapped_out_pages"] and stats["swap_in_fails"], \
            "nothing offloaded, or no swap-in refused"
        assert eng.degraded_mode & 4 and eng.cache.host is None, \
            "repeated swap-in failures did not drop the host tier"
        surv = [r for r in ref if r not in eng.aborted]
        self.same("swap failures (survivors)", clean.prompts,
                  {r: ref[r] for r in surv}, {r: outs[r] for r in surv})
        return stats, outs

    def abort_deadline(self, seed: int):
        """Client aborts and a deadline that expires at once while requests
        are mid-stream."""
        eng = self.engine()
        self.submit(eng, 6, 30, seed=seed)
        eng.submit(Req(100, np.arange(1, 10), 30 * self.scale,
                       deadline_s=1e-6))
        for _ in range(3):
            eng.tick()
        for rid in (0, 2):
            eng.abort(rid)
        eng.run(5000)
        stats = self.drained(eng, 7, f"abort_deadline[{seed}]")
        assert eng.aborted.get(0) == "client"
        assert eng.aborted.get(2) == "client"
        assert eng.aborted.get(100) == "deadline"
        return stats, self.outputs(eng)

    def row_death_identity(self, seed: int):
        """A row death mid-run changes no request's greedy tokens."""
        clean = self.engine(n_rows=2, n_shards=2)
        self.submit(clean, 8, 8, seed=seed)
        ref = self.outputs_of(clean)
        eng = self.engine(FaultConfig(seed=3, row_death_p=0.1, max_faults=1),
                          n_rows=2, n_shards=2)
        self.submit(eng, 8, 8, seed=seed)
        outs = self.outputs_of(eng)
        stats = self.drained(eng, 8, f"row_death_identity[{seed}]")
        self.same("row death", clean.prompts, ref, outs)
        return stats, outs

    def spec_chaos(self, seed: int):
        """Speculative decoding under allocation pressure: the ladder
        turns spec off mid-run and survivors' greedy outputs do not
        change."""
        clean = self.spec_engine()
        self.submit(clean, 6, 8, seed=seed)
        ref = self.outputs_of(clean)
        eng = self.spec_engine(FaultConfig(seed=seed, alloc_exhaust_p=0.15,
                                           client_abort_p=0.01),
                               degrade_after=2)
        self.submit(eng, 6, 8, seed=seed)
        outs = self.outputs_of(eng)
        stats = self.drained(eng, 6, f"spec_chaos[{seed}]")
        assert not eng._dlen, f"draft-pool coverage leaked: {eng._dlen}"
        surv = [r for r in range(6) if r not in eng.aborted]
        self.same("spec degradation (survivors)", clean.prompts,
                  {r: ref[r] for r in surv}, {r: outs[r] for r in surv})
        return stats, outs

    def kill_restore(self, seed: int):
        """Snapshot every 3 ticks, abandon the engine mid-run, restore the
        newest snapshot into a fresh engine and finish: outputs equal the
        uninterrupted run's."""
        d = tempfile.mkdtemp(prefix="chaos_ckpt_")
        try:
            clean = self.engine()
            self.submit(clean, 8, 10, seed=seed)
            ref = self.outputs_of(clean)
            eng = self.engine(snapshot_dir=d, snapshot_every=3)
            self.submit(eng, 8, 10, seed=seed)
            for _ in range(5):          # killed mid-stream
                eng.tick()
            eng2 = self.engine(snapshot_dir=d)
            step = eng2.restore_snapshot()
            assert step is not None, "no restorable snapshot written"
            # requests already done in the snapshot only republish their
            # outputs: the terminal contract covers what was restored live
            n_live = (sum(1 for r in eng2.batcher.slots if r is not None)
                      + len(eng2.batcher.queue))
            outs = self.outputs_of(eng2)
            stats = self.drained(eng2, n_live, f"kill_restore[{seed}]")
            self.same("kill + restore", clean.prompts, ref, outs)
            stats["restored_step"] = step
            stats["snapshot_saves"] = eng.snapshot_saves
            stats["snapshot_restores"] = eng2.snapshot_restores
            return stats, outs
        finally:
            shutil.rmtree(d, ignore_errors=True)

    def outputs_of(self, eng) -> dict:
        eng.run(5000)
        return self.outputs(eng)

    SCENARIOS = ("mixed_storm", "swap_faults", "swap_drop",
                 "abort_deadline", "row_death_identity", "spec_chaos",
                 "kill_restore")

    def run(self, emit, *, seeds=(0, 1)) -> list[dict]:
        all_stats = []
        for name in self.SCENARIOS:
            for seed in seeds:
                t0 = time.perf_counter()
                stats, _ = getattr(self, name)(seed)
                dt = time.perf_counter() - t0
                self.engines.clear()
                assert dt < WATCHDOG_S, \
                    f"{stats['scenario']}: watchdog tripped ({dt:.0f}s)"
                stats["wall_s"] = dt
                all_stats.append(stats)
                emit(stats["scenario"],
                     f"done={stats['completed']} aborted={stats['aborted']} "
                     f"faults={stats['faults_fired']} "
                     f"degraded={stats['degraded_mode']} "
                     f"captures={stats['graph_captures']} wall={dt:.1f}s")
        return all_stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write per-scenario stats + fired-fault event logs")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    def emit(name, derived):
        print(f"{name},{derived}", flush=True)

    stats = ChaosSoak(args.device).run(emit, seeds=tuple(args.seeds))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"bench": "chaos_soak", "seeds": args.seeds,
                       "scenarios": stats}, f, indent=2)
        print(f"# wrote {args.json}")
    print(f"# chaos_soak OK ({len(stats)} scenarios, all terminal, "
          f"leak-free)")
    return stats


if __name__ == "__main__":
    main()
